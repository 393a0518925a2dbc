"""Prefixes of the mixer half's forward kernel (K2), for the ablation tool
(`asy_vrnet_tpu_torch/tools/ablate_mixer_fwd.py`, the counterpart of the TPU
tool `tools/ablate_mixer_fwd.py`): `mixer_block_ablate` launches K2 cut
after one phase (`csrc/mixer_block.cu`, template constants kStop and kNf);
`mixer_block_ablate_plain` is its plain twin, built from
`ops/block.py::_mixer_planes`.

The prefixes follow the port's phase order, in which A (the centers) comes
before B1 (the feat of a chunk); the TPU body computes feat first:
  gn       B's chunk loads: normalise, round
  centers  + A: pooled centers, projected, normalised per head
  feat     + B1: the feat of every chunk
  sim      + B2: the assignment, the winner's sigmoid, rs and cnt
  agg      + the split aggregation and the mixed centers
  full     + the fc2 fold, the cluster swap, the dispatch, the moments: K2
The normalise-first variant (`nf`, the similarity of the TPU's folded
kernel: featn = rnd(feat * rnd(inv)), cos = rnd(cn) . featn) has featn,
cosm (the M cosines, without the max), sim, agg and full.

A cut prefix runs each CTA as K2 does (sample b, region r, CTA g of G owning
heads [g*hpc, (g+1)*hpc)) and sums, in f32, what its phases computed that no
later phase of the prefix reads, for the CTA's heads:
  gn       rnd(xn) over the region's tokens and channels
  centers  that, plus cn and vc over the CTA's heads and the M centers
  feat     cn + vc + feat over the region's tokens (the CTA's columns)
  featn    cn + vc + featn
  cosm     vc + the M cosines of every (token, CTA head)
  sim      vc + rs + m * cnt (per CTA head and proposal m)
  agg      rnd(oc), the mixed centers
This checksum s keeps every phase's work alive.  The CTA writes rnd(x + s)
for the tokens it dispatches (region tokens [g*nper, (g+1)*nper), nper =
ceil(N / G)), K2's output bytes, and part[b, r*G + g] = (s, sum of the
terms' magnitudes).  `full` returns K2's output and its per-CTA moments.

Launches count in LAUNCHES["mixer_block_ablate"], never in
`ops/block.py::LAUNCHES`: no serving or train path runs a prefix.
"""
from __future__ import annotations

import torch

from asy_vrnet_tpu_torch.ops import block

STOPS = {False: ("gn", "centers", "feat", "sim", "agg", "full"),
         True: ("featn", "cosm", "sim", "agg", "full")}
# stop codes of csrc/mixer_block.cu (featn is the nf variant's feat stop)
CODES = {"gn": 0, "centers": 1, "feat": 2, "featn": 2, "cosm": 3, "sim": 4, "agg": 5,
         "full": 6}
LAUNCHES = {"mixer_block_ablate": 0}


def label(stop: str, nf: bool) -> str:
    """The profiler label of a prefix's launch."""
    return f"mixer_block_ablate/{'nf' if nf else 'base'}_{stop}"


def _check_prefix(stop, nf, heads, groups):
    if stop not in STOPS[bool(nf)]:
        raise ValueError(f"mixer_block_ablate: no prefix {stop!r} in the "
                         f"{'nf' if nf else 'base'} variant ({STOPS[bool(nf)]})")
    if groups < 1 or heads % groups:
        raise ValueError(f"mixer_block_ablate: {groups} CTAs per region do not divide "
                         f"{heads} heads")


def _dispatch_cta(n: int, groups: int, device) -> torch.Tensor:
    """(N,) the CTA of its region that dispatches each region token."""
    return torch.arange(n, device=device) // -(-n // groups)


def write_through(x, s, *, fold_h, fold_w):
    """rnd(x + s) NHWC, with s (B, R, G) the checksum of the CTA that
    dispatches each token: a cut prefix's output."""
    xr, region_hw = block._regions(x.float(), fold_h, fold_w)
    cta = _dispatch_cta(xr.shape[2], s.shape[2], x.device)
    return block._from_regions(xr + s[:, :, cta, None], region_hw, fold_h,
                               fold_w).to(x.dtype)


def _terms(p, stop, m, dt):
    """A cut prefix's terms: [per-head tensors (B, R, heads, ...)] and the
    region-level tensor (B, R, ...) or None."""
    if stop in ("gn", "centers"):
        return ([p.cnb, p.vc] if stop == "centers" else []), p.xnb
    if stop in ("feat", "featn"):
        return [p.cnb, p.vc, (p.feat if stop == "feat" else p.featn).transpose(2, 3)], None
    if stop == "cosm":
        return [p.vc, p.cos.transpose(2, 3)], None
    if stop == "sim":
        proposal = torch.arange(m, dtype=torch.float32, device=p.rs.device)
        return [p.vc, p.rs, p.mask.sum(2) * proposal], None
    return [block._round(p.oc, dt)], None


def mixer_block_ablate_plain(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta, *, heads,
                             fold_h, fold_w, proposal_h, proposal_w, stop, nf=False,
                             groups=1, assign=None, return_assign=False):
    """Plain twin of one prefix (see the module docstring) with `groups`
    CTAs per region.  `assign` (B, H, W, heads), if given, replaces the first
    max (the kernel's own assignment, as the K6 twin is fed K2's pack).
    Returns (out NHWC in x.dtype, part (B, R * groups, 2) f32) [, the
    assignment (B, H, W, heads) int8 of a full prefix]."""
    _check_prefix(stop, nf, heads, groups)
    if return_assign and stop != "full":
        raise ValueError("mixer_block_ablate: only a full prefix returns its assignment")
    geo = dict(heads=heads, fold_h=fold_h, fold_w=fold_w, proposal_h=proposal_h,
               proposal_w=proposal_w)
    p = block._mixer_planes(x, stats, wf, bf, wv, bv, alpha_beta, assign=assign,
                            normalise_first=nf, **geo)
    b, r, n = p.xn.shape[:3]
    if stop == "full":
        out, _ = block._mixer_out(x, p, w2, b2, heads, fold_h, fold_w)
        o = block._regions(out.float(), fold_h, fold_w)[0]
        cta = _dispatch_cta(n, groups, x.device)
        part = torch.zeros(b, r, groups, 2, device=x.device)
        part[..., 0].index_add_(2, cta, o.sum(-1))
        part[..., 1].index_add_(2, cta, (o * o).sum(-1))
        part = part.reshape(b, r * groups, 2)
        if return_assign:
            return out, part, block._from_regions(p.arg, p.region_hw, fold_h,
                                                  fold_w).to(torch.int8)
        return out, part
    per_head, region = _terms(p, stop, proposal_h * proposal_w, x.dtype)
    sums = torch.zeros(b, r, heads, 2, device=x.device)
    for t in per_head:
        sums[..., 0] += t.flatten(3).sum(-1)
        sums[..., 1] += t.abs().flatten(3).sum(-1)
    part = sums.reshape(b, r, groups, heads // groups, 2).sum(3)
    if region is not None:
        part[..., 0] += region.flatten(2).sum(-1)[..., None]
        part[..., 1] += region.abs().flatten(2).sum(-1)[..., None]
    out = write_through(x, part[..., 0], fold_h=fold_h, fold_w=fold_w)
    return out, part.reshape(b, r * groups, 2)


def mixer_block_ablate(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta, *, heads, fold_h,
                       fold_w, proposal_h, proposal_w, stop, nf=False, groups=None,
                       return_assign=False, return_occupancy=False):
    """One prefix of the mixer half (operands as `ops/block.py::mixer_block`).
    `groups`: CTAs per region (None: `kernels.mixer_groups`' choice, as
    K2's; 1 on the CPU).  The feat path is K2's.  Returns (out, part (B, R * G, 2) f32) [, the
    assignment (B, H, W, heads) int8 of a full prefix] [, (the prefix's CTAs
    per SM as launched, K2's), None on the CPU].  On the CPU the twin runs,
    on a CUDA tensor the kernel (or it raises); both under the profiler
    label `label(stop, nf)`."""
    kw = dict(heads=heads, fold_h=fold_h, fold_w=fold_w, proposal_h=proposal_h,
              proposal_w=proposal_w)
    with torch.profiler.record_function(label(stop, nf)):
        if x.device.type == "cpu":
            res = mixer_block_ablate_plain(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta,
                                           stop=stop, nf=nf, groups=groups or 1,
                                           return_assign=return_assign, **kw)
            return res + (None,) if return_occupancy else res
        if x.device.type != "cuda":
            raise ValueError(f"mixer_block_ablate: unsupported device {x.device}")
        from asy_vrnet_tpu_torch.ops import kernels

        block._check_mixer_args("mixer_block_ablate", x, stats, wf, bf, wv, bv, w2,
                                alpha_beta, heads, fold_h, fold_w)
        b, h, w, c = x.shape
        f32, dev = torch.float32, x.device
        block._check("b2", b2, (c,), f32, dev)
        regions = fold_h * fold_w
        g = groups or kernels.mixer_groups(x, wf.shape[1], heads, fold_h, fold_w,
                                           proposal_h, proposal_w)
        tc = kernels.mixer_feat_on_tensor_cores(c, wf.shape[1] // heads, x.dtype)
        _check_prefix(stop, nf, heads, g)
        out = torch.empty_like(x)
        part = torch.empty((b, regions * g, 2), dtype=f32, device=dev)
        asg = (torch.empty((b, h, w, heads), dtype=torch.int8, device=dev)
               if return_assign else None)
        occ = torch.zeros(2, dtype=torch.int32)
        kernels.mixer_block_ablate(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta, out,
                                   part, asg, occ, groups=g, tc=tc, stop=CODES[stop], nf=nf,
                                   **kw)
        LAUNCHES["mixer_block_ablate"] += 1
        occupancy = tuple(occ.tolist())
    res = (out, part)
    if return_assign:
        res += (asg,)
    if return_occupancy:
        res += (occupancy,)
    return res
