"""The stand-alone cluster mix, forward and backward (counterpart of
`asy_vrnet_tpu/ops/cluster_pallas.py`), each a hand-written CUDA kernel with
a plain PyTorch twin:

  K7  (`csrc/cluster_mix.cu`):     out = cluster_mix(feat, value, alpha, beta)
  K7b (`csrc/cluster_mix_bwd.cu`): d feat, d value, d alpha, d beta, the
                                   forward rematerialised in full

`Cluster` calls `cluster_mix_fused` where the JAX package's calls
`cluster_mix_pallas`: the fused ClusterBlock path is off (active dropout,
or drop-path in training) and the fused kernels are on.  Shapes the JAX
predicate refuses take the plain `cluster_mix`, as in JAX; the routing is
decided by the shape alone.

The twins follow the TPU kernel's formulation (`_mixer_core`,
`_mixer_core_bwd`), not `cluster_mix`'s: centers pooled from the working-type
operands with f32 sums; center and token norms in f32, the normalised
operands rounded to the working type for the cosine; first max over the
proposals by strict > in proposal order; sim rounded for the aggregation and
the dispatch, the mixed centers for the dispatch.  The TPU kernel's region
grouping and its dense replication and mask matrices are tiling, not math,
and are not carried over.

Layout is NHWC (B, H, W, heads * head_dim), contiguous.  The wrappers take
CPU tensors through the twins and CUDA tensors through the kernels (or
raise); each counts its kernel launches in LAUNCHES, and in PATHS by the
instantiation it took: "fast" (head width 32, at most 4 proposals: 4
channels a lane held in registers, the cosines formed at once, register
sums) or "general" (`kernels.cluster_mix_fast`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from asy_vrnet_tpu_torch.ops.block import (_aligned, _check, _needs_grad, _round,
                                           pallas_supported)
from asy_vrnet_tpu_torch.ops.cluster import (
    _fold_tokens,
    _pool_matrix,
    _unfold_tokens,
    cluster_mix,
)

# kernel launches per wrapper; plain-version calls are not counted
LAUNCHES = {"cluster_mix": 0, "cluster_mix_bwd": 0}
PATHS = {"cluster_mix/fast": 0, "cluster_mix/general": 0, "cluster_mix_bwd/fast": 0,
         "cluster_mix_bwd/general": 0}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _remat(feat, value, alpha_beta, heads, fold_h, fold_w, proposal_h, proposal_w,
           assign=None):
    """The forward's quantities on folded tokens (B, heads, R, N, D), f32,
    as `_mixer_core` computes them.  `assign` (B, H, W, heads) int, when
    given, replaces the first-max assignment."""
    dt, f32 = feat.dtype, torch.float32
    rnd = lambda t: _round(t, dt)  # noqa: E731
    x, hw = _fold_tokens(feat, heads, fold_h, fold_w)
    v, _ = _fold_tokens(value, heads, fold_h, fold_w)
    xf, vf = x.float(), v.float()
    pool = rnd(_pool_matrix(hw, (proposal_h, proposal_w), feat.device, f32))   # (M, N)
    c_rep = torch.einsum("mn,bhrnd->bhrmd", pool, xf)
    vc = torch.einsum("mn,bhrnd->bhrmd", pool, vf)
    inv_c = torch.rsqrt((c_rep * c_rep).sum(-1, keepdim=True) + 1e-12)
    cn = c_rep * inv_c
    inv = torch.rsqrt((xf * xf).sum(-1, keepdim=True) + 1e-12)
    xn = xf * inv
    raw = torch.einsum("bhrmd,bhrnd->bhrmn", rnd(cn), rnd(xn))
    s = torch.sigmoid(alpha_beta[1] + alpha_beta[0] * raw)
    if assign is None:
        best, arg = s[..., 0, :], torch.zeros_like(s[..., 0, :], dtype=torch.long)
        for mm in range(1, s.shape[-2]):
            better = s[..., mm, :] > best        # strict >: the first max wins
            best = torch.where(better, s[..., mm, :], best)
            arg = torch.where(better, mm, arg)
    else:
        arg, _ = _fold_tokens(assign.long(), heads, fold_h, fold_w)
        arg = arg[..., 0]
    mask = F.one_hot(arg, s.shape[-2]).movedim(-1, -2).float()    # (B,h,R,M,N)
    return dict(hw=hw, xf=xf, vf=vf, pool=pool, vc=vc, inv_c=inv_c, cn=cn,
                inv=inv, xn=xn, raw=raw, s=s, arg=arg, mask=mask, sim=s * mask,
                counts=mask.sum(-1, keepdim=True))


def _assign_map(p, fold_h, fold_w):
    """(B, heads, R, N) proposals -> the kernels' (B, H, W, heads) int8 map."""
    return _unfold_tokens(p["arg"][..., None], p["hw"], fold_h, fold_w).to(torch.int8)


def cluster_mix_fused_plain(feat, value, alpha_beta, *, heads, fold_h, fold_w, proposal_h,
                            proposal_w, return_assign=False):
    """Plain K7: `_mixer_core` step by step.  feat, value (B,H,W,C) in one
    dtype, alpha_beta (2,) f32.  Returns out in feat's dtype [, the winning
    proposal per (token, head), (B, H, W, heads) int8]."""
    p = _remat(feat, value, alpha_beta, heads, fold_h, fold_w, proposal_h, proposal_w)
    rnd = lambda t: _round(t, feat.dtype)  # noqa: E731
    sim = p["sim"]
    agg = torch.einsum("bhrmn,bhrnd->bhrmd", rnd(sim), p["vf"])
    oc = (agg + p["vc"]) / (p["counts"] + 1.0)
    out = torch.einsum("bhrmn,bhrmd->bhrnd", rnd(sim), rnd(oc))
    out = _unfold_tokens(out, p["hw"], fold_h, fold_w).to(feat.dtype)
    return (out, _assign_map(p, fold_h, fold_w)) if return_assign else out


def cluster_mix_bwd_plain(feat, value, g, alpha_beta, *, heads, fold_h, fold_w, proposal_h,
                          proposal_w, assign=None, return_assign=False):
    """Plain K7b: `_mixer_core_bwd` step by step, the forward rematerialised
    with the same roundings.  feat, value, g (B,H,W,C) in one dtype (the
    caller casts g to feat's dtype, as `_cluster_fused_bwd` does),
    alpha_beta (2,) f32.  `assign` (B, H, W, heads), when given, replaces
    the rebuilt assignment (to compare with a kernel on the same one).
    Returns (d feat, d value) in feat's dtype and (2,) f32 [d alpha, d beta]
    [, the assignment as in `cluster_mix_fused_plain`]."""
    p = _remat(feat, value, alpha_beta, heads, fold_h, fold_w, proposal_h, proposal_w,
               assign)
    rnd = lambda t: _round(t, feat.dtype)  # noqa: E731
    sim, s, pool, xn, cn = p["sim"], p["s"], p["pool"], p["xn"], p["cn"]
    gf, _ = _fold_tokens(g, heads, fold_h, fold_w)
    gf, vf = gf.float(), p["vf"]
    inv_cnt = 1.0 / (p["counts"] + 1.0)
    oc = (torch.einsum("bhrmn,bhrnd->bhrmd", rnd(sim), vf) + p["vc"]) * inv_cnt
    # out = sim^T oc
    d_oc = torch.einsum("bhrmn,bhrnd->bhrmd", sim, gf)
    d_sim = torch.einsum("bhrmd,bhrnd->bhrmn", oc, gf)
    # oc = (sim v + pool v) * inv_cnt
    d_num = d_oc * inv_cnt
    d_sim = d_sim + torch.einsum("bhrmd,bhrnd->bhrmn", d_num, vf)
    dv = torch.einsum("bhrmn,bhrmd->bhrnd", sim, d_num)
    dv = dv + torch.einsum("mn,bhrmd->bhrnd", pool, d_num)
    # sim = sigmoid(beta + alpha * raw) * mask, the mask and counts constant
    sig_grad = d_sim * p["mask"] * s * (1.0 - s)
    d_raw = sig_grad * alpha_beta[0]
    dab = torch.stack([(sig_grad * p["raw"]).sum(), sig_grad.sum()])
    # raw = cn . xn; xn = x * inv (per head), cn = c_rep * inv_c
    d_cn = torch.einsum("bhrmn,bhrnd->bhrmd", d_raw, xn)
    d_xn = torch.einsum("bhrmn,bhrmd->bhrnd", d_raw, cn)
    dx = p["inv"] * (d_xn - xn * (xn * d_xn).sum(-1, keepdim=True))
    d_c_rep = p["inv_c"] * (d_cn - cn * (cn * d_cn).sum(-1, keepdim=True))
    dx = dx + torch.einsum("mn,bhrmd->bhrnd", pool, d_c_rep)
    unfold = lambda t: _unfold_tokens(t, p["hw"], fold_h, fold_w).to(feat.dtype)  # noqa: E731
    out = (unfold(dx), unfold(dv), dab)
    return (*out, _assign_map(p, fold_h, fold_w)) if return_assign else out


# ---------------------------------------------------------------------------
# wrappers: CPU -> plain version; CUDA -> kernel (or raise)
# ---------------------------------------------------------------------------

def _check_args(name, feat, tensors, alpha_beta, geo):
    b, h, w, c = feat.shape
    if feat.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: dtype {feat.dtype} not supported")
    for tname, t in tensors.items():
        _check(tname, t, (b, h, w, c), feat.dtype, feat.device)
    _check("alpha_beta", alpha_beta, (2,), torch.float32, feat.device)
    if not pallas_supported(feat.shape, **geo):
        raise ValueError(f"{name}: shape {tuple(feat.shape)} with {geo} is not one the "
                         "kernel takes (pallas_supported)")


def cluster_mix_fwd(feat, value, alpha_beta, *, heads, fold_h, fold_w, proposal_h,
                    proposal_w, return_assign=False):
    """Cluster mix forward (K7).  feat, value (B,H,W,C) bf16|f32 in one
    dtype, alpha_beta (2,) f32.  Returns what `cluster_mix_fused_plain`
    returns."""
    geo = dict(heads=heads, fold_h=fold_h, fold_w=fold_w, proposal_h=proposal_h,
               proposal_w=proposal_w)
    if feat.device.type == "cpu":
        return cluster_mix_fused_plain(feat, value, alpha_beta, return_assign=return_assign,
                                       **geo)
    if feat.device.type != "cuda":
        raise ValueError(f"cluster_mix: unsupported device {feat.device}")
    from asy_vrnet_tpu_torch.ops import kernels

    _check_args("cluster_mix", feat, {"feat": feat, "value": value}, alpha_beta, geo)
    b, h, w, c = feat.shape
    feat, value = _aligned(feat), _aligned(value)
    out = torch.empty_like(feat)
    assign = (torch.empty((b, h, w, heads), dtype=torch.int8, device=feat.device)
              if return_assign else None)
    fast = kernels.cluster_mix_fast(c // heads, proposal_h * proposal_w)
    kernels.cluster_mix(feat, value, alpha_beta, out, assign, fast=fast, **geo)
    LAUNCHES["cluster_mix"] += 1
    PATHS["cluster_mix/fast" if fast else "cluster_mix/general"] += 1
    return (out, assign) if return_assign else out


def cluster_mix_bwd(feat, value, g, alpha_beta, *, heads, fold_h, fold_w, proposal_h,
                    proposal_w, return_assign=False):
    """Cluster mix backward (K7b).  feat, value, g (B,H,W,C) bf16|f32 in one
    dtype, alpha_beta (2,) f32.  Returns what `cluster_mix_bwd_plain`
    returns.  The kernel writes one [d alpha, d beta] row per block; one
    torch sum reduces them (no float atomics: two runs give the same bits)."""
    geo = dict(heads=heads, fold_h=fold_h, fold_w=fold_w, proposal_h=proposal_h,
               proposal_w=proposal_w)
    if feat.device.type == "cpu":
        return cluster_mix_bwd_plain(feat, value, g, alpha_beta, return_assign=return_assign,
                                     **geo)
    if feat.device.type != "cuda":
        raise ValueError(f"cluster_mix_bwd: unsupported device {feat.device}")
    from asy_vrnet_tpu_torch.ops import kernels

    _check_args("cluster_mix_bwd", feat, {"feat": feat, "value": value, "g": g},
                alpha_beta, geo)
    b, h, w, c = feat.shape
    feat, value, g = _aligned(feat), _aligned(value), _aligned(g)
    dx, dv = torch.empty_like(feat), torch.empty_like(feat)
    dab = torch.empty((b * heads * fold_h * fold_w, 2), dtype=torch.float32,
                      device=feat.device)
    assign = (torch.empty((b, h, w, heads), dtype=torch.int8, device=feat.device)
              if return_assign else None)
    fast = kernels.cluster_mix_fast(c // heads, proposal_h * proposal_w)
    kernels.cluster_mix_bwd(feat, value, g, alpha_beta, dx, dv, dab, assign, fast=fast,
                            **geo)
    LAUNCHES["cluster_mix_bwd"] += 1
    PATHS["cluster_mix_bwd/fast" if fast else "cluster_mix_bwd/general"] += 1
    out = (dx, dv, dab.sum(0))
    return (*out, assign) if return_assign else out


# ---------------------------------------------------------------------------
# the entry Cluster calls (counterpart of cluster_mix_pallas) and its
# autograd Function (counterpart of the custom VJP `_cluster_fused`)
# ---------------------------------------------------------------------------

def _alpha_beta(alpha, beta):
    return torch.stack([alpha.reshape(()), beta.reshape(())]).float()


class _ClusterMixFused(torch.autograd.Function):
    """K7 forward, K7b backward; saves only the inputs (full remat)."""

    @staticmethod
    def forward(ctx, feat, value, alpha, beta, geo):
        ctx.geo = geo
        ctx.save_for_backward(feat, value, alpha, beta)
        return cluster_mix_fwd(feat, value, _alpha_beta(alpha, beta), **geo)

    @staticmethod
    def backward(ctx, g):
        feat, value, alpha, beta = ctx.saved_tensors
        g = g.to(feat.dtype).contiguous()
        dx, dv, dab = cluster_mix_bwd(feat, value, g, _alpha_beta(alpha, beta), **ctx.geo)
        return (dx, dv, dab[0].reshape(alpha.shape).to(alpha.dtype),
                dab[1].reshape(beta.shape).to(beta.dtype), None)


def cluster_mix_fused(feat, value, sim_alpha, sim_beta, *, heads, fold_h, fold_w,
                      proposal_h, proposal_w):
    """`cluster_mix_pallas`: K7/K7b where `pallas_supported` takes the shape,
    else the plain `cluster_mix` (whose result is f32; K7's is in feat's
    dtype).  feat, value NHWC; differentiable in feat, value, alpha, beta."""
    geo = dict(heads=heads, fold_h=fold_h, fold_w=fold_w, proposal_h=proposal_h,
               proposal_w=proposal_w)
    if not pallas_supported(feat.shape, **geo):
        return cluster_mix(feat, value, sim_alpha, sim_beta, **geo)
    alpha = torch.as_tensor(sim_alpha, dtype=torch.float32, device=feat.device)
    beta = torch.as_tensor(sim_beta, dtype=torch.float32, device=feat.device)
    feat, value = feat.contiguous(), value.contiguous()
    if _needs_grad(feat, value, alpha, beta):
        return _ClusterMixFused.apply(feat, value, alpha, beta, geo)
    return cluster_mix_fwd(feat, value, _alpha_beta(alpha, beta), **geo)
