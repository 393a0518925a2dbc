"""The two fused ClusterBlock halves (counterpart of
`asy_vrnet_tpu/ops/block_pallas.py`), forward and backward, each a
hand-written CUDA kernel with a plain PyTorch twin:

  mixer half (K2): x + ls1 * fc2(cluster_mix(fc1(GN1(x)), fc_v(GN1(x))))
                   plus the per-sample moments of its output; in training
                   also the residual pack its backward consumes
  MLP half   (K1): x + ls2 * fc2(GELU(fc1(GN2(x))))  with pre-reduced stats
  mixer backward (K6 from K2's pack, K6r with the full forward remat), MLP
                   backward (K5, optionally from K1's z1): the cotangent of
                   the normalised input, the folded-weight gradients summed
                   over the batch and the per-sample sums the GroupNorm
                   backward needs

GroupNorm(1)'s per-sample statistics are a cross-tile reduction, so they come
in as (B, 2) [mean, rstd]; the GN affine folds into the input-side weights
and LayerScale into the output-side ones (`_fold_in`/`_fold_out`).  The mixer
half also returns its output's GN statistics, which the MLP half consumes, so
a block reads its input from device memory once per half.

`fused_mixer_block_stats` and `fused_mlp_block_pre` are what ClusterBlock
calls.  Under autograd they are `torch.autograd.Function`s that follow the
JAX package's custom VJPs: the kernels compute the folded-weight gradients,
and unfolding them to the GN affine, the 1x1 weights and LayerScale, and the
GroupNorm input gradient, stay plain torch ops.

Two switches steer what the train forward keeps for the backward, read as
the JAX package reads them (once per autograd forward):
  ASY_MIXER_BWD_RESIDUALS (default "1"): K2 writes its residual pack and K6
    consumes it; "0": no pack, and the backward is K6r, which rebuilds the
    whole forward (assignment included) from x;
  ASY_MLP_BWD_RESIDUALS (default "0"): "1": K1 also writes the pre-GELU z1
    and K5 reads it instead of recomputing fc1.
Under `ModelConfig.train_remat` a checkpointed span's recompute takes the
decisions its forward took (`span_state`, set by models/remat.py).

Layout at every public function is NHWC (B, H, W, C), contiguous; the model
passes the NHWC view of its channels_last tensors.  The wrappers take CPU
tensors through the plain version and CUDA tensors through the kernel (or
raise); each counts its kernel launches in LAUNCHES, one key per kernel
variant, where it launches.  The inference forms of K2 and K1 reach their
launch through the PyTorch operators of `ops/custom_ops.py`, so a replay of
an exported program counts too and tracing counts nothing.
"""
from __future__ import annotations

import contextlib
import os
import threading
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from asy_vrnet_tpu_torch.ops.cluster import _fold_tokens, _pool_matrix, _unfold_tokens

_GN_EPS = 1e-5

# kernel launches per wrapper; plain-version calls are not counted.  K6r is
# mixer_block_bwd_remat, the z1 variants of K1 and K5 are *_z1
LAUNCHES = {"mixer_block": 0, "mlp_block": 0, "mixer_block_bwd": 0, "mlp_block_bwd": 0,
            "mixer_block_bwd_remat": 0, "mlp_block_z1": 0, "mlp_block_bwd_z1": 0}
# the same launches of K2, K1, K6, K6r and K5 (either variant) by the path
# they took: K2's feat, K6's and K6r's feat, dxn-share and dWf products on
# tensor cores ("tc") or CUDA cores ("fma"); K1 on tensor cores with t tokens
# per CTA ("mma<t>") or on CUDA cores ("fma"); K5 on tensor cores in
# thread-block clusters ("cluster") or on CUDA cores ("fma")
PATHS = {"mixer_block/tc": 0, "mixer_block/fma": 0, "mlp_block/mma16": 0,
         "mlp_block/mma32": 0, "mlp_block/mma64": 0, "mlp_block/fma": 0,
         "mixer_block_bwd/tc": 0, "mixer_block_bwd/fma": 0, "mixer_block_bwd_remat/tc": 0,
         "mixer_block_bwd_remat/fma": 0, "mlp_block_bwd/cluster": 0, "mlp_block_bwd/fma": 0,
         "mlp_block_bwd_z1/cluster": 0, "mlp_block_bwd_z1/fma": 0}


def _use_bwd_residuals() -> bool:
    """`block_pallas.py::_use_bwd_residuals`: the mixer half's residual pack
    (on unless ASY_MIXER_BWD_RESIDUALS=0)."""
    return os.environ.get("ASY_MIXER_BWD_RESIDUALS", "1") != "0"


def _use_mlp_residuals() -> bool:
    """`block_pallas.py::_use_mlp_residuals`: the MLP half's z1 residual (off
    unless ASY_MLP_BWD_RESIDUALS=1)."""
    return os.environ.get("ASY_MLP_BWD_RESIDUALS", "0") == "1"


class _Span(threading.local):
    """What a checkpointed span fixes for its recompute (models/remat.py),
    per thread (a CUDA backward, and so the recompute, runs in autograd's
    device thread):
      switches   (mixer pack, MLP z1) as the span's forward read them, or None;
      recompute  the span is being recomputed in the backward;
      tail       the block being run produces the span's output.
    Checkpoint keeps only what a recompute saves, so the MLP half at the tail
    of a recomputed span saves its inputs and skips K1 (whose output would
    be dropped), unless it must rebuild z1: one mixer forward per block, as
    JAX's "blocks" remat recomputes."""
    switches = None
    recompute = False
    tail = False


_SPAN = _Span()


def residual_switches() -> tuple[bool, bool]:
    """(mixer residual pack, MLP z1): pinned by the enclosing span, else
    read from the environment."""
    pinned = _SPAN.switches
    return pinned if pinned is not None else (_use_bwd_residuals(), _use_mlp_residuals())


@contextlib.contextmanager
def span_state(**state):
    """Set fields of `_SPAN` for the duration (nests)."""
    old = {k: getattr(_SPAN, k) for k in state}
    for k, v in state.items():
        setattr(_SPAN, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(_SPAN, k, v)


def gn1_stats(x: torch.Tensor) -> torch.Tensor:
    """Per-sample GroupNorm(1) statistics over all non-batch dims: (B, 2) f32
    [mean, rstd] with var = E[x^2] - mu^2 (block_pallas.py:65-71)."""
    xf = x.float().reshape(x.shape[0], -1)
    mu = xf.mean(dim=1)
    var = (xf * xf).mean(dim=1) - mu * mu
    return torch.stack([mu, torch.rsqrt(var + _GN_EPS)], dim=-1)


def _stats_from_moments(osum: torch.Tensor, n: int) -> torch.Tensor:
    """(B, 2) [sum, sum of squares] over n elements -> (B, 2) [mean, rstd]."""
    mu = osum[:, 0] / n
    var = osum[:, 1] / n - mu * mu
    return torch.stack([mu, torch.rsqrt(var + _GN_EPS)], dim=-1)


def _fold_in(gn_scale, gn_bias, w, b):
    """Fold the GN affine into an input-side matmul: returns (w_eff, b_eff)."""
    return gn_scale[:, None] * w, gn_bias @ w + b


def _fold_out(w, b, ls):
    """Fold LayerScale into an output-side matmul."""
    return w * ls[None, :], b * ls


# ---------------------------------------------------------------------------
# which shapes take the fused path: the JAX package's predicates, copied so
# both packages take the same branch for the same shape
# ---------------------------------------------------------------------------

_TARGET_TOKENS = 2048
_MAX_TOKENS_PER_REGION = 8192
_MAX_SIM_ROWS = 512


def _group_w(fold_w: int, region_tokens: int) -> int:
    best = 1
    cap = max(_TARGET_TOKENS, region_tokens)
    for gw in range(1, fold_w + 1):
        if fold_w % gw == 0 and gw * region_tokens <= cap:
            best = gw
    return best


def pallas_supported(shape, *, heads, fold_h, fold_w, proposal_h, proposal_w) -> bool:
    """`cluster_pallas.py::pallas_supported` on the NHWC shape of feat: the
    shapes the stand-alone cluster mix kernel takes."""
    b, h, w, c = shape
    if h % fold_h or w % fold_w or c % heads:
        return False
    rh, rw = h // fold_h, w // fold_w
    n = rh * rw
    if not (8 <= n <= _MAX_TOKENS_PER_REGION):
        return False
    d = c // heads
    if d < 8:
        return False
    gw = _group_w(fold_w, n)
    hb = gw * heads * proposal_h * proposal_w
    return hb <= _MAX_SIM_ROWS


def mixer_block_supported(shape, *, heads, head_dim, fold_h, fold_w,
                          proposal_h, proposal_w) -> bool:
    """`block_pallas.py::mixer_block_supported`: `pallas_supported` at the
    block's inner width."""
    b, h, w, c = shape
    return pallas_supported((b, h, w, heads * head_dim), heads=heads, fold_h=fold_h,
                            fold_w=fold_w, proposal_h=proposal_h, proposal_w=proposal_w)


def mlp_block_supported(shape) -> bool:
    b, h, w, c = shape
    return h * w >= 8


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round to the working dtype and compute on in f32."""
    return t.to(dtype).float()


def _normalise(x, stats):
    """f32 (x - mean) * rstd with per-sample (B, 2) stats."""
    return (x.float() - stats[:, 0, None, None, None]) * stats[:, 1, None, None, None]


def _regions(t, fold_h, fold_w):
    """NHWC (B,H,W,K) -> (B, R, N, K) region tokens, and (rh, rw)."""
    t, hw = _fold_tokens(t, 1, fold_h, fold_w)
    return t[:, 0], hw


def _from_regions(t, hw, fold_h, fold_w):
    """(B, R, N, K) -> NHWC (B,H,W,K); inverse of _regions."""
    return _unfold_tokens(t[:, None], hw, fold_h, fold_w)


def _mixer_planes(x, stats, wf, bf, wv, bv, alpha_beta, *, heads, fold_h, fold_w,
                  proposal_h, proposal_w, assign=None, normalise_first=False):
    """The mixer half's forward interior in the TPU kernel's own formulation
    (`_mixer_block_fwd_body`): centers pooled in input space and projected,
    first-max assignment on the pre-sigmoid logit, aggregation in input
    space.  f32, with the working dtype's roundings where that kernel casts
    to its matrix-unit dtype.  Region layout: tokens (B, R, N, ...), centers
    (B, R, heads, M, ...).  `assign` (B, H, W, heads), if given, replaces the
    first max (a test feeds a kernel's own assignment, as near-ties in bf16
    can fall either way).  `normalise_first` takes the similarity of the
    TPU's folded kernel (`_mixer_block_fwd_body_folded`), which only the
    ablation tool runs: featn = rnd(feat * rnd(inv)) per head, cos = rnd(cn)
    . featn (then `raw` is None).  Returns a namespace of the planes the
    forward and the remat backward read."""
    dt = x.dtype
    rnd = lambda t: _round(t, dt)  # noqa: E731
    b, h, w, c = x.shape
    inner = wf.shape[1]
    d = inner // heads
    m = proposal_h * proposal_w
    alpha, beta = alpha_beta[0], alpha_beta[1]
    wf, wv = wf.float(), wv.float()
    heads_of = lambda t: t.reshape(*t.shape[:-1], heads, d)  # noqa: E731

    xn, region_hw = _regions(_normalise(x, stats), fold_h, fold_w)
    xnb = rnd(xn)                                     # (B,R,N,C)
    pool = rnd(_pool_matrix(region_hw, (proposal_h, proposal_w), x.device, torch.float32))
    cinb = rnd(torch.einsum("mn,brnc->brmc", pool, xnb))
    c_rep = heads_of(cinb @ wf + bf).transpose(2, 3)  # (B,R,h,M,D)
    vc = heads_of(cinb @ wv + bv).transpose(2, 3)
    inv_c = torch.rsqrt((c_rep * c_rep).sum(-1, keepdim=True) + 1e-12)
    feat = heads_of(xnb @ wf + bf)                    # (B,R,N,h,D)
    featb = rnd(feat)
    inv = torch.rsqrt(rnd(feat * feat).sum(-1) + 1e-12)   # (B,R,N,h)
    invr = rnd(inv)
    cnb = rnd(c_rep * inv_c)
    if normalise_first:
        featn = rnd(feat * invr[..., None])
        raw, cos = None, torch.einsum("brhmd,brnhd->brnhm", cnb, featn)
    else:
        featn = None
        raw = torch.einsum("brhmd,brnhd->brnhm", cnb, featb)
        cos = raw * invr[..., None]
    logit = beta + alpha * cos
    arg = logit.argmax(-1) if assign is None else _regions(assign, fold_h, fold_w)[0].long()
    pick = lambda t: t.gather(-1, arg[..., None])[..., 0]  # noqa: E731
    sgb = torch.sigmoid(pick(logit))                  # (B,R,N,h) winner sigmoid
    mask = F.one_hot(arg, m).float()                  # (B,R,N,h,M)
    simb = mask * rnd(sgb)[..., None]
    rs = (mask * sgb[..., None]).sum(2)               # (B,R,h,M)
    icnt = 1.0 / (mask.sum(2) + 1.0)
    aggx = torch.einsum("brnhm,brnc->brhmc", simb, xnb)
    agg = (torch.einsum("brhmc,chd->brhmd", rnd(aggx), wv.reshape(c, heads, d))
           + rs[..., None] * bv.reshape(heads, 1, d))
    return SimpleNamespace(
        xn=xn, xnb=xnb, region_hw=region_hw, pool=pool, cinb=cinb, c_rep=c_rep,
        inv_c=inv_c, cnb=cnb, vc=vc, feat=feat, featb=featb, featn=featn, inv=inv,
        invr=invr, cos=cos, arg=arg, cbest=pick(cos), raw=None if raw is None else pick(raw),
        sgb=sgb, mask=mask, simb=simb, rs=rs, icnt=icnt, aggx=aggx,
        oc=(agg + vc) * icnt[..., None])


def _mixer_out(x, p, w2, b2, heads, fold_h, fold_w):
    """The dispatch after `_mixer_planes`: (out NHWC in x.dtype, the rounded
    mixed centers)."""
    dt = x.dtype
    c = x.shape[-1]
    d = w2.shape[0] // heads
    oc = _round(p.oc, dt)
    ocw = _round(torch.einsum("brhmd,hdc->brhmc", oc, w2.float().reshape(heads, d, c)), dt)
    y = torch.einsum("brnhm,brhmc->brnc", p.simb, ocw) + b2
    return (x.float() + _from_regions(y, p.region_hw, fold_h, fold_w)).to(dt), oc


def mixer_block_plain(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta, *, heads,
                      fold_h, fold_w, proposal_h, proposal_w,
                      return_assign=False, return_residuals=False):
    """Plain mixer half on folded weights (`_mixer_planes`, then the dispatch
    of the fc2-projected centers, `_mixer_out`).  Returns (out, moments (B,2)
    [sum, sum sq] of the stored output) [, assignments (B, heads, H, W)
    int64] [, residual pack].

    The residual pack (training) is what `mixer_block_bwd` consumes:
    (cbest (B,H,W,heads) x.dtype, the winning cosine per (token, head);
     argf (B,H,W,heads) int8, the winning proposal;
     c_rep (B, R, heads*M, head_dim) x.dtype, the raw pooled centers;
     oc (B, R, heads*M, head_dim) x.dtype, the mixed centers
     (S.V + V_c) / (count + 1)), R = fold_h*fold_w regions row-major, center
    rows head-major (h*M + m)."""
    dt = x.dtype
    geo = dict(heads=heads, fold_h=fold_h, fold_w=fold_w, proposal_h=proposal_h,
               proposal_w=proposal_w)
    p = _mixer_planes(x, stats, wf, bf, wv, bv, alpha_beta, **geo)
    b = x.shape[0]
    d = wf.shape[1] // heads
    out, oc = _mixer_out(x, p, w2, b2, heads, fold_h, fold_w)
    nhwc = lambda t: _from_regions(t, p.region_hw, fold_h, fold_w)  # noqa: E731
    ob = out.float()
    moments = torch.stack([ob.sum(dim=(1, 2, 3)), (ob * ob).sum(dim=(1, 2, 3))], -1)
    if return_residuals:
        rows = lambda t: t.reshape(b, -1, heads * proposal_h * proposal_w, d).to(dt)  # noqa: E731
        return out, moments, (nhwc(p.cbest).to(dt), nhwc(p.arg).to(torch.int8),
                              rows(p.c_rep), rows(oc))
    if return_assign:
        return out, moments, nhwc(p.arg).permute(0, 3, 1, 2)
    return out, moments


def mlp_block_plain(x, stats, w1, b1, w2, b2, return_z1=False):
    """Plain MLP half on folded weights (exact-erf GELU), in f32 with the
    working dtype's roundings at the kernel's matmul operands.  With
    `return_z1`, also the pre-GELU z1 (B,H,W,hid) rounded to x.dtype: the
    train residual `_mlp_block_kernel` stores (GELU itself takes the f32 z1)."""
    dt = x.dtype
    z = _round(_normalise(x, stats), dt) @ w1.float() + b1
    y = _round(F.gelu(z), dt) @ w2.float() + b2
    out = (x.float() + y).to(dt)
    return (out, z.to(dt)) if return_z1 else out


def _gelu_and_grad(z):
    """Exact-erf GELU and its derivative Phi(z) + z*phi(z)."""
    cdf = 0.5 * (1.0 + torch.erf(z * 0.7071067811865476))
    return z * cdf, cdf + z * torch.exp(-0.5 * z * z) * 0.3989422804014327


def mlp_block_bwd_plain(x, g, stats, w1, b1, w2, z1=None):
    """Plain MLP-half backward on folded weights (`_mlp_bwd_kernel` of the
    JAX package), rounding where that kernel casts to its matrix-unit dtype.
    x, g (B,H,W,C) in one dtype.  z1 None: fc1 rematerialised; else the
    forward's stored z1 (x.dtype), whose GELU and GELU' are taken on
    z1.float() (in bf16 not the remat's f32 z1, as in that kernel).  Returns
    (dxn in x.dtype, dW1 (C,hid), db1 (hid,), dW2 (hid,C), db2 (C,), sums
    (B, 2) [sum dxn, sum dxn*xn] taken from the f32 dxn), all but dxn f32 and
    summed over the batch."""
    dt = x.dtype
    xn = _normalise(x, stats)
    xnb = _round(xn, dt).reshape(-1, x.shape[-1])
    gb = g.float().reshape(-1, x.shape[-1])
    z = xnb @ w1.float() + b1 if z1 is None else z1.float().reshape(-1, w1.shape[1])
    act, dgelu = _gelu_and_grad(z)
    dz1 = (gb @ w2.float().t()) * dgelu
    dz1b = _round(dz1, dt)
    dxn = (dz1b @ w1.float().t()).reshape(x.shape)
    sums = torch.stack([dxn.sum(dim=(1, 2, 3)), (dxn * xn).sum(dim=(1, 2, 3))], -1)
    return (dxn.to(dt), xnb.t() @ dz1b, dz1.sum(0), _round(act, dt).t() @ gb,
            gb.sum(0), sums)


def _mixer_bwd_tail(p, g, wf, wv, bv, w2, alpha, *, heads, fold_h, fold_w, cn_rep, oc,
                    cosw, raw_w):
    """The backward dataflow after the forward planes are rebuilt
    (`_mixer_bwd_tail` of the JAX package), shared by the residual and the
    remat twin.  `p` holds the planes of `_mixer_planes` that both rebuild;
    cn_rep (B,R,h,M,D) f32 the raw centers, oc the mixed centers, cosw
    (B,R,N,h) the winning cosine; raw_w the winning raw product (the remat
    plane), or None: then the raw plane's cotangent is rebuilt as
    cosw / invr on the winner, exact because dcos is winner-masked."""
    dt = g.dtype
    rnd = lambda t: _round(t, dt)  # noqa: E731
    b, c = g.shape[0], g.shape[-1]
    inner = wf.shape[1]
    d = inner // heads
    m = p.mask.shape[-1]
    wf, wv, w2 = wf.float(), wv.float(), w2.float()
    gb = _regions(g.float(), fold_h, fold_w)[0]
    r = gb.shape[1]
    xn, xnb, mask, sgb, simb, icnt = p.xn, p.xnb, p.mask, p.sgb, p.simb, p.icnt
    inv_c = torch.rsqrt((cn_rep * cn_rep).sum(-1, keepdim=True) + 1e-12)
    cn = cn_rep * inv_c
    ocb = rnd(oc)

    # y = sim^T (oc @ w2): cotangents of sim and of the fc2-projected centers
    w2h = w2.reshape(heads, d, c)
    ocw = torch.einsum("brhmd,hdc->brhmc", ocb, w2h)
    dsim = torch.einsum("brhmc,brnc->brnhm", rnd(ocw), gb)
    docwb = rnd(torch.einsum("brnhm,brnc->brhmc", simb, gb))
    doc = torch.einsum("brhmc,hdc->brhmd", docwb, w2h)
    dw2 = torch.einsum("brhmd,brhmc->hdc", ocb, docwb).reshape(inner, c)

    # oc = (aggx @ wv + rs*bv + vc) * icnt
    dagg = doc * icnt[..., None]                      # (B,R,h,M,D), also dvc
    daggb = rnd(dagg)
    wvh = wv.reshape(c, heads, d)
    daggxb = rnd(torch.einsum("brhmd,chd->brhmc", daggb, wvh))
    dwv = torch.einsum("brhmc,brhmd->chd", rnd(p.aggx), daggb)
    drs = (dagg * bv.reshape(heads, 1, d)).sum(-1)       # (B,R,h,M)
    dbv = torch.einsum("brhm,brhmd->hd", rnd(p.rs), daggb)

    # aggx = sim @ xn, rs = rowsum(sim)
    dsim = dsim + torch.einsum("brhmc,brnc->brnhm", daggxb, xnb) + drs[:, :, None]
    dxn = torch.einsum("brnhm,brhmc->brnc", simb, daggxb)

    # sim = sigmoid(beta + alpha*cos) on the winner; cos = raw * invr
    sig = (dsim * mask).sum(-1) * sgb * (1.0 - sgb)   # (B,R,N,h)
    dab = torch.stack([(sig * cosw).sum(), sig.sum()])
    dcos = sig * alpha
    drawb = rnd(dcos * p.invr)
    dinvr = dcos * (raw_w if raw_w is not None else cosw * (1.0 / p.invr))
    wsel = mask * drawb[..., None]                    # draw on the winner row
    dcn = torch.einsum("brnhm,brnhd->brhmd", wsel, p.featb)
    dfeat = torch.einsum("brnhm,brhmd->brnhd", wsel, rnd(cn))
    dnorm2 = rnd(rnd(dinvr) * (-0.5) * p.inv * p.inv * p.inv)
    dfeat = (dfeat + 2.0 * p.feat * dnorm2[..., None]).flatten(-2)   # (B,R,N,I)

    # cn = c_rep * inv_c; c_rep = pool(xn) @ wf + bf; vc = pool(xn) @ wv + bv
    d_c_rep = inv_c * (dcn - cn * (cn * dcn).sum(-1, keepdim=True))
    dcp = d_c_rep.permute(0, 1, 3, 2, 4).reshape(b, r, m, inner)
    dvp = dagg.permute(0, 1, 3, 2, 4).reshape(b, r, m, inner)
    dcpb, dvpb = rnd(dcp), rnd(dvp)
    dwf = torch.einsum("brmc,brmi->ci", p.cinb, dcpb)
    dwv = dwv.reshape(c, inner) + torch.einsum("brmc,brmi->ci", p.cinb, dvpb)
    dbf = dcp.sum((0, 1, 2))
    dbv = dbv.reshape(inner) + dvp.sum((0, 1, 2))
    dcin = rnd(dcpb @ wf.t() + dvpb @ wv.t())         # (B,R,M,C)
    dxn = dxn + torch.einsum("mn,brmc->brnc", p.pool, dcin)

    # feat = xn @ wf + bf
    dfb = rnd(dfeat)
    dxn = dxn + dfb @ wf.t()
    dwf = dwf + torch.einsum("brnc,brni->ci", xnb, dfb)
    dbf = dbf + dfeat.sum((0, 1, 2))

    sums = torch.stack([dxn.sum((1, 2, 3)), (dxn * xn).sum((1, 2, 3))], -1)
    return (_from_regions(dxn, p.region_hw, fold_h, fold_w).to(dt), dwf, dbf, dwv, dbv, dw2,
            gb.sum((0, 1, 2)), dab, sums)


def mixer_block_bwd_remat_plain(x, g, stats, wf, bf, wv, bv, w2, alpha_beta, *, heads,
                                fold_h, fold_w, proposal_h, proposal_w, assign=None,
                                return_assign=False):
    """Plain mixer-half backward with the full forward remat (K6r), step by
    step after the JAX package's `_mixer_bwd_kernel` + `_mixer_bwd_tail`:
    every forward plane is rebuilt from x (`_mixer_planes`), and the tail
    reads the remat's own f32 planes: the raw centers, the winning cosine and
    raw product, the mixed centers.  `assign` as in `_mixer_planes`.
    Returns what `mixer_block_bwd_plain` returns [, the assignment (B,H,W,
    heads) int8]."""
    geo = dict(heads=heads, fold_h=fold_h, fold_w=fold_w)
    p = _mixer_planes(x, stats, wf, bf, wv, bv, alpha_beta, proposal_h=proposal_h,
                      proposal_w=proposal_w, assign=assign, **geo)
    out = _mixer_bwd_tail(p, g, wf, wv, bv, w2, alpha_beta[0], cn_rep=p.c_rep, oc=p.oc,
                          cosw=p.cbest, raw_w=p.raw, **geo)
    if return_assign:
        return (*out, _from_regions(p.arg, p.region_hw, fold_h, fold_w).to(torch.int8))
    return out


def mixer_block_bwd_plain(x, g, stats, wf, bf, wv, bv, w2, alpha_beta, residuals,
                          *, heads, fold_h, fold_w, proposal_h, proposal_w):
    """Plain mixer-half backward on folded weights.  With a residual pack
    (see `mixer_block_plain`) step by step after the JAX package's
    `_mixer_bwd_kernel_res` + `_mixer_bwd_tail` (K6): feat, the per-head
    token norms and the pooled tokens are rebuilt from x; the assignment, the
    winning cosines and both center sets come from the pack.  With
    `residuals` None, `mixer_block_bwd_remat_plain` (K6r).  Roundings to
    x.dtype where that kernel casts to its matrix-unit dtype.  x, g (B,H,W,C)
    in one dtype.

    Returns (dxn in x.dtype, dWf (C,I), dbf (I,), dWv (C,I), dbv (I,),
    dW2 (I,C), db2 (C,), dab (2,) [d alpha, d beta], sums (B,2) [sum dxn,
    sum dxn*xn] from the f32 dxn); all but dxn f32 and summed over the batch."""
    geo = dict(heads=heads, fold_h=fold_h, fold_w=fold_w)
    if residuals is None:
        return mixer_block_bwd_remat_plain(x, g, stats, wf, bf, wv, bv, w2, alpha_beta,
                                           proposal_h=proposal_h, proposal_w=proposal_w, **geo)
    dt = x.dtype
    rnd = lambda t: _round(t, dt)  # noqa: E731
    cbest, argf, c_rep, oc = residuals
    b, h, w, c = x.shape
    inner = wf.shape[1]
    d = inner // heads
    m = proposal_h * proposal_w
    alpha, beta = alpha_beta[0], alpha_beta[1]
    regions = lambda t: _regions(t, fold_h, fold_w)  # noqa: E731
    heads_of = lambda t: t.reshape(*t.shape[:-1], heads, d)  # noqa: E731

    # slim remat: feat tokens, per-head norms, pooled tokens
    xn, region_hw = regions(_normalise(x, stats))
    xnb = rnd(xn)
    feat = heads_of(xnb @ wf.float() + bf)            # (B,R,N,h,D)
    inv = torch.rsqrt(rnd(feat * feat).sum(-1) + 1e-12)   # (B,R,N,h)
    pool = rnd(_pool_matrix(region_hw, (proposal_h, proposal_w), x.device, torch.float32))

    # stored residuals -> the similarity plane (winner only) and the centers
    cb = regions(cbest.float())[0]                    # (B,R,N,h)
    mask = F.one_hot(regions(argf.long())[0], m).float()   # (B,R,N,h,M)
    sgb = torch.sigmoid(beta + alpha * cb)
    sim = mask * sgb[..., None]
    r = xn.shape[1]
    p = SimpleNamespace(
        xn=xn, xnb=xnb, region_hw=region_hw, pool=pool,
        cinb=rnd(torch.einsum("mn,brnc->brmc", pool, xnb)), feat=feat, featb=rnd(feat),
        inv=inv, invr=rnd(inv), sgb=sgb, mask=mask, simb=rnd(sim), rs=sim.sum(2),
        icnt=1.0 / (mask.sum(2) + 1.0), aggx=torch.einsum("brnhm,brnc->brhmc", rnd(sim), xnb))
    rows = lambda t: t.float().reshape(b, r, heads, m, d)  # noqa: E731
    return _mixer_bwd_tail(p, g, wf, wv, bv, w2, alpha, cn_rep=rows(c_rep), oc=rows(oc),
                           cosw=cb, raw_w=None, **geo)


# ---------------------------------------------------------------------------
# wrappers: CPU -> plain version; CUDA -> kernel (or raise)
# ---------------------------------------------------------------------------

def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_mixer_args(name, x, stats, wf, bf, wv, bv, w2, alpha_beta, heads,
                      fold_h, fold_w):
    b, h, w, c = x.shape
    inner = wf.shape[1]
    f32, dev = torch.float32, x.device
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: dtype {x.dtype} not supported")
    _check("x", x, (b, h, w, c), x.dtype, dev)
    _check("stats", stats, (b, 2), f32, dev)
    _check("wf", wf, (c, inner), x.dtype, dev)
    _check("bf", bf, (inner,), f32, dev)
    _check("wv", wv, (c, inner), x.dtype, dev)
    _check("bv", bv, (inner,), f32, dev)
    _check("w2", w2, (inner, c), x.dtype, dev)
    _check("alpha_beta", alpha_beta, (2,), f32, dev)
    if inner % heads or h % fold_h or w % fold_w:
        raise ValueError(f"{name}: heads/folds do not divide the shape")


def _residual_shapes(x, heads, inner, fold_h, fold_w, proposal_h, proposal_w):
    b, h, w, _ = x.shape
    centers = (b, fold_h * fold_w, heads * proposal_h * proposal_w, inner // heads)
    return (b, h, w, heads), centers


def mixer_block(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta, *, heads,
                fold_h, fold_w, proposal_h, proposal_w, return_assign=False,
                return_residuals=False):
    """Mixer half on folded weights.  x (B,H,W,C) bf16|f32; wf/wv (C,I) and
    w2 (I,C) in x's dtype; biases, stats (B,2) and alpha_beta (2,) f32.
    Returns (out (B,H,W,C), moments (B,2) f32 [sum, sum sq] of the stored
    output) [, assignments (B, heads, H, W)] [, residual pack, laid out as
    in `mixer_block_plain`].  On the card the inference form goes through
    the registered operator `asy_vrnet::mixer_block` (`ops/custom_ops.py`),
    so `torch.export` and graph capture see one op; the forms with the
    assignments or the residual pack launch the same kernel directly."""
    kw = dict(heads=heads, fold_h=fold_h, fold_w=fold_w,
              proposal_h=proposal_h, proposal_w=proposal_w)
    if x.device.type == "cpu":
        return mixer_block_plain(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta,
                                 return_assign=return_assign,
                                 return_residuals=return_residuals, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"mixer_block: unsupported device {x.device}")
    if return_assign or return_residuals:
        return mixer_block_launch(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta,
                                  return_assign=return_assign,
                                  return_residuals=return_residuals, **kw)
    return torch.ops.asy_vrnet.mixer_block.default(
        x, stats, wf, bf, wv, bv, w2, b2, alpha_beta, heads, fold_h, fold_w,
        proposal_h, proposal_w)


def mixer_block_launch(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta, *, heads,
                       fold_h, fold_w, proposal_h, proposal_w, return_assign=False,
                       return_residuals=False):
    """K2 on CUDA tensors: checks, geometry, outputs, the launch and its
    count.  What `mixer_block` returns."""
    from asy_vrnet_tpu_torch.ops import kernels

    kw = dict(heads=heads, fold_h=fold_h, fold_w=fold_w,
              proposal_h=proposal_h, proposal_w=proposal_w)
    _check_mixer_args("mixer_block", x, stats, wf, bf, wv, bv, w2, alpha_beta,
                      heads, fold_h, fold_w)
    b, h, w, c = x.shape
    f32, dev = torch.float32, x.device
    _check("b2", b2, (c,), f32, dev)
    out = torch.empty_like(x)
    regions = fold_h * fold_w
    g = kernels.mixer_groups(x, wf.shape[1], heads, fold_h, fold_w, proposal_h, proposal_w)
    tc = kernels.mixer_feat_on_tensor_cores(c, wf.shape[1] // heads, x.dtype)
    part = torch.empty((b, regions * g, 2), dtype=f32, device=dev)
    per_token, centers = _residual_shapes(x, heads, wf.shape[1], fold_h, fold_w,
                                          proposal_h, proposal_w)
    assign = (torch.empty(per_token, dtype=torch.int8, device=dev)
              if return_assign or return_residuals else None)
    pack = None
    if return_residuals:
        pack = (torch.empty(per_token, dtype=x.dtype, device=dev), assign,
                torch.empty(centers, dtype=x.dtype, device=dev),
                torch.empty(centers, dtype=x.dtype, device=dev))
    kernels.mixer_block(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta, out,
                        part, assign, pack, tc=tc, **kw)
    LAUNCHES["mixer_block"] += 1
    PATHS["mixer_block/tc" if tc else "mixer_block/fma"] += 1
    moments = part.sum(dim=1)
    if return_residuals:
        return out, moments, pack
    if return_assign:
        return out, moments, assign.permute(0, 3, 1, 2).long()
    return out, moments


def _check_mlp_args(name, x, stats, w1, b1, w2, z1=None):
    b, h, w, c = x.shape
    hid = w1.shape[1]
    f32, dev = torch.float32, x.device
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: dtype {x.dtype} not supported")
    _check("x", x, (b, h, w, c), x.dtype, dev)
    _check("stats", stats, (b, 2), f32, dev)
    _check("w1", w1, (c, hid), x.dtype, dev)
    _check("b1", b1, (hid,), f32, dev)
    _check("w2", w2, (hid, c), x.dtype, dev)
    if z1 is not None:
        _check("z1", z1, (b, h, w, hid), x.dtype, dev)


def _aligned(t):
    """t, or a copy of it where its storage does not start on 16 bytes (K5
    and K7/K7b stage tiles with 16-byte copies and read vectors)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def mlp_block(x, stats, w1, b1, w2, b2, return_z1=False):
    """MLP half on folded weights.  x (B,H,W,C) bf16|f32; w1 (C,hid) and w2
    (hid,C) in x's dtype; biases and stats (B,2) f32.  With `return_z1`
    (training under ASY_MLP_BWD_RESIDUALS=1) returns (out, z1 (B,H,W,hid) in
    x.dtype), the pre-GELU activations K5 then reads.  On the card the form
    without z1 goes through the registered operator `asy_vrnet::mlp_block`
    (`ops/custom_ops.py`); the z1 form launches the same kernel directly."""
    if x.device.type == "cpu":
        return mlp_block_plain(x, stats, w1, b1, w2, b2, return_z1=return_z1)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_block: unsupported device {x.device}")
    if return_z1:
        return mlp_block_launch(x, stats, w1, b1, w2, b2, return_z1=True)
    return torch.ops.asy_vrnet.mlp_block.default(x, stats, w1, b1, w2, b2)


def mlp_block_launch(x, stats, w1, b1, w2, b2, return_z1=False):
    """K1 on CUDA tensors: checks, geometry, outputs, the launch and its
    count.  What `mlp_block` returns."""
    from asy_vrnet_tpu_torch.ops import kernels

    _check_mlp_args("mlp_block", x, stats, w1, b1, w2)
    _check("b2", b2, (x.shape[-1],), torch.float32, x.device)
    out = torch.empty_like(x)
    z1 = x.new_empty((*x.shape[:3], w1.shape[1])) if return_z1 else None
    tokens = kernels.mlp_tokens(x, w1, w2)
    kernels.mlp_block(x, stats, w1, b1, w2, b2, out, z1, tokens)
    LAUNCHES["mlp_block_z1" if return_z1 else "mlp_block"] += 1
    PATHS[f"mlp_block/mma{tokens}" if tokens else "mlp_block/fma"] += 1
    return (out, z1) if return_z1 else out


def mlp_block_bwd(x, g, stats, w1, b1, w2, z1=None):
    """MLP-half backward on folded weights (K5).  x, g (B,H,W,C) bf16|f32 in
    one dtype; w1 (C,hid) and w2 (hid,C) in x's dtype; b1 and stats (B,2)
    f32; z1 (B,H,W,hid) in x's dtype, K1's stored pre-GELU activations, or
    None (fc1 recomputed).  Returns what `mlp_block_bwd_plain` returns.  The
    kernel writes one row of weight-gradient partials and GroupNorm sums per
    thread-block cluster (cluster path) or per block (FMA path); torch sums
    reduce them (no float atomics: two runs give the same bits)."""
    if x.device.type == "cpu":
        return mlp_block_bwd_plain(x, g, stats, w1, b1, w2, z1)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_block_bwd: unsupported device {x.device}")
    from asy_vrnet_tpu_torch.ops import kernels

    _check_mlp_args("mlp_block_bwd", x, stats, w1, b1, w2, z1)
    b, h, w, c = x.shape
    hid = w1.shape[1]
    _check("g", g, (b, h, w, c), x.dtype, x.device)
    geo = kernels.mlp_bwd_launch(b, h * w, c, hid, x.dtype, x.device)
    f32, dev, o = torch.float32, x.device, c * hid
    cs = geo["cluster"]
    if cs:
        x, g, w1, w2 = (_aligned(t) for t in (x, g, w1, w2))
        z1 = None if z1 is None else _aligned(z1)
        part = torch.empty((geo["clusters"], geo["row_floats"]), dtype=f32, device=dev)
    else:
        part = torch.empty((b * geo["chunks"], 2 * o + hid + c + 2), dtype=f32, device=dev)
    dxn = torch.empty_like(x)
    kernels.mlp_block_bwd(x, g, stats, w1, b1, w2, z1, dxn, part, chunks=geo["chunks"],
                          cluster=cs, clusters=geo["clusters"], tile=geo["tile"])
    key = "mlp_block_bwd" if z1 is None else "mlp_block_bwd_z1"
    LAUNCHES[key] += 1
    PATHS[f"{key}/{'cluster' if cs else 'fma'}"] += 1
    if cs:  # one row per cluster: [dW1 | dW2 | db1 | db2 | per-sample sums]
        tot = part.sum(0)
        sums = tot[2 * o + hid + c:].view(b, 2)
    else:
        tot = part[:, :-2].sum(0)
        sums = part[:, -2:].view(b, geo["chunks"], 2).sum(1)
    db2 = tot[2 * o + hid:2 * o + hid + c]
    return (dxn, tot[:o].view(c, hid), tot[2 * o:2 * o + hid], tot[o:2 * o].view(hid, c),
            db2, sums)


def mixer_block_bwd(x, g, stats, wf, bf, wv, bv, w2, alpha_beta, residuals, *,
                    heads, fold_h, fold_w, proposal_h, proposal_w, return_assign=False):
    """Mixer-half backward on folded weights: K6 from the forward's residual
    pack, or with `residuals` None K6r, which rebuilds the whole forward
    (the assignment K2 made included) from x.  x, g (B,H,W,C) bf16|f32 in one
    dtype; wf/wv (C,I), w2 (I,C) in x's dtype; bf, bv, stats (B,2),
    alpha_beta (2,) f32.  Returns what `mixer_block_bwd_plain` returns;
    with `return_assign` (K6r only, a check the train path never asks for)
    also the assignment it rebuilt, (B,H,W,heads) int8.  K6r keeps its
    winners in buffers of this call (9 bytes a (token, head)), freed when it
    returns.  Partials (one row per block) are reduced by torch sums (no
    float atomics: two runs give the same bits)."""
    kw = dict(heads=heads, fold_h=fold_h, fold_w=fold_w,
              proposal_h=proposal_h, proposal_w=proposal_w)
    if return_assign and residuals is not None:
        raise ValueError("mixer_block_bwd: return_assign needs the remat backward")
    if x.device.type == "cpu":
        if residuals is None:
            return mixer_block_bwd_remat_plain(x, g, stats, wf, bf, wv, bv, w2, alpha_beta,
                                               return_assign=return_assign, **kw)
        return mixer_block_bwd_plain(x, g, stats, wf, bf, wv, bv, w2, alpha_beta,
                                     residuals, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"mixer_block_bwd: unsupported device {x.device}")
    from asy_vrnet_tpu_torch.ops import kernels

    _check_mixer_args("mixer_block_bwd", x, stats, wf, bf, wv, bv, w2, alpha_beta,
                      heads, fold_h, fold_w)
    b, h, w, c = x.shape
    inner = wf.shape[1]
    f32, dev = torch.float32, x.device
    _check("g", g, (b, h, w, c), x.dtype, dev)
    per_token, centers = _residual_shapes(x, heads, inner, fold_h, fold_w,
                                          proposal_h, proposal_w)
    if residuals is not None:
        for name, t, shape, dtype in zip(("cbest", "argf", "c_rep", "oc"), residuals,
                                         (per_token, per_token, centers, centers),
                                         (x.dtype, torch.int8, x.dtype, x.dtype)):
            _check(name, t, shape, dtype, dev)
    regions = fold_h * fold_w
    m = proposal_h * proposal_w
    remat = residuals is None
    groups = kernels.mixer_bwd_groups(c, inner, heads, b * regions, proposal_h, proposal_w,
                                      remat, dev, x.dtype)
    tiles = kernels.mixer_bwd_tiles(h * w, c)
    tc = kernels.mixer_feat_on_tensor_cores(c, inner // heads, x.dtype)
    dxn = torch.empty_like(x)
    scratch = torch.empty((groups, b, h, w, c), dtype=f32, device=dev)
    dcin = torch.empty((b * regions, groups, m, c), dtype=f32, device=dev)
    wpart = torch.empty((b * regions, 3 * c * inner + 2 * inner), dtype=f32, device=dev)
    dab = torch.empty((b * regions * groups, 2), dtype=f32, device=dev)
    epart = torch.empty((b, tiles, 2 + c), dtype=f32, device=dev)
    assign = torch.empty(per_token, dtype=torch.int8, device=dev) if remat else None
    win = torch.empty((*per_token, 2), dtype=f32, device=dev) if remat else None
    kernels.mixer_block_bwd(x, g, stats, wf, bf, wv, bv, w2, alpha_beta, residuals,
                            dxn, scratch, dcin, wpart, dab, epart, assign, win, groups=groups,
                            tiles=tiles, tc=tc, **kw)
    key = "mixer_block_bwd_remat" if remat else "mixer_block_bwd"
    LAUNCHES[key] += 1
    PATHS[f"{key}/{'tc' if tc else 'fma'}"] += 1
    tot = wpart.sum(0)
    o = c * inner
    out = (dxn, tot[:o].view(c, inner), tot[3 * o:3 * o + inner], tot[o:2 * o].view(c, inner),
           tot[3 * o + inner:], tot[2 * o:3 * o].view(inner, c), epart[..., 2:].sum((0, 1)),
           dab.sum(0), epart[..., :2].sum(1))
    return (*out, assign) if return_assign else out


# ---------------------------------------------------------------------------
# the entries ClusterBlock calls (counterparts of fused_mixer_block_stats and
# fused_mlp_block_pre, lane_fold=1) and their autograd Functions
# ---------------------------------------------------------------------------

def _mixer_operands(x, gn_scale, gn_bias, wf, bf, wv, bv, w2, b2, ls1, alpha, beta):
    """Folded kernel operands: (wf, bf, wv, bv, w2, b2, alpha_beta), matmul
    weights in x's dtype, the rest f32."""
    f32, dt = torch.float32, x.dtype
    wf_e, bf_e = _fold_in(gn_scale, gn_bias, wf, bf)
    wv_e, bv_e = _fold_in(gn_scale, gn_bias, wv, bv)
    w2_e, b2_e = _fold_out(w2, b2, ls1)
    alpha_beta = torch.stack([alpha.reshape(()), beta.reshape(())]).to(f32)
    return (wf_e.to(dt).contiguous(), bf_e.to(f32), wv_e.to(dt).contiguous(),
            bv_e.to(f32), w2_e.to(dt).contiguous(), b2_e.to(f32), alpha_beta)


def _mlp_operands(x, gn_scale, gn_bias, w1, b1, w2, b2, ls2):
    f32, dt = torch.float32, x.dtype
    w1_e, b1_e = _fold_in(gn_scale, gn_bias, w1, b1)
    w2_e, b2_e = _fold_out(w2, b2, ls2)
    return (w1_e.to(dt).contiguous(), b1_e.to(f32), w2_e.to(dt).contiguous(),
            b2_e.to(f32))


def _gn_input_grad(x, g, stats, dxn, sums):
    """GroupNorm(1) input gradient plus the residual path (`_fused_*_bwd`
    phase 2 of the JAX package), from the kernel's per-sample sums:
    dx = g + rstd * (dxn - mean(dxn) - xn * mean(dxn * xn))."""
    n = x[0].numel()
    rstd = stats[:, 1, None, None, None]
    m1 = (sums[:, 0] / n)[:, None, None, None]
    m2 = (sums[:, 1] / n)[:, None, None, None]
    return (g.float() + rstd * (dxn.float() - m1 - _normalise(x, stats) * m2)).to(x.dtype)


def _unfold_in(gn_scale, gn_bias, w, dw_e, db_e):
    """Gradients through w_e = gs[:,None]*w, b_e = gb @ w + b: (dw, dgs, dgb);
    db = db_e."""
    return (gn_scale[:, None] * dw_e + gn_bias[:, None] * db_e[None, :],
            (dw_e * w).sum(1), w @ db_e)


def _unfold_out(w, b, ls, dw_e, db_e):
    """Gradients through w_e = w*ls, b_e = b*ls: (dw, db, dls)."""
    return dw_e * ls[None, :], db_e * ls, (dw_e * w).sum(0) + db_e * b


class _FusedMixerBlockStats(torch.autograd.Function):
    """`fused_mixer_block_stats` under autograd: the train forward (K2, with
    its residual pack unless ASY_MIXER_BWD_RESIDUALS=0) and
    `_fused_mixer_block_bwd` of the JAX package (K6 from the pack, K6r
    without one; then the unfold and the GroupNorm input gradient in torch).
    The stats output is not differentiable: it only feeds the chained MLP
    half, whose backward rebuilds the stats' dependence on x analytically."""

    @staticmethod
    def forward(ctx, x, gn_scale, gn_bias, wf, bf, wv, bv, w2, b2, ls1, alpha, beta, geo):
        stats = gn1_stats(x)
        ops = _mixer_operands(x, gn_scale, gn_bias, wf, bf, wv, bv, w2, b2, ls1, alpha, beta)
        ctx.residuals = residual_switches()[0]       # read once, as JAX reads it per trace
        if ctx.residuals:
            out, moments, pack = mixer_block(x, stats, *ops, return_residuals=True, **geo)
        else:
            (out, moments), pack = mixer_block(x, stats, *ops, **geo), ()
        ostats = _stats_from_moments(moments, x[0].numel())
        ctx.geo = geo
        ctx.save_for_backward(x, gn_scale, gn_bias, wf, bf, wv, bv, w2, b2, ls1,
                              alpha, beta, stats, *pack)
        ctx.mark_non_differentiable(ostats)
        return out, ostats

    @staticmethod
    def backward(ctx, g, _gstats):
        (x, gs, gb, wf, bf, wv, bv, w2, b2, ls1, alpha, beta, stats,
         *pack) = ctx.saved_tensors
        wf_e, bf_e, wv_e, bv_e, w2_e, _, ab = _mixer_operands(
            x, gs, gb, wf, bf, wv, bv, w2, b2, ls1, alpha, beta)
        g = g.to(x.dtype).contiguous()
        dxn, dwf_e, dbf_e, dwv_e, dbv_e, dw2_e, db2_e, dab, sums = mixer_block_bwd(
            x, g, stats, wf_e, bf_e, wv_e, bv_e, w2_e, ab,
            tuple(pack) if ctx.residuals else None, **ctx.geo)
        dwf, dgs, dgb = _unfold_in(gs, gb, wf, dwf_e, dbf_e)
        dwv, dgs_v, dgb_v = _unfold_in(gs, gb, wv, dwv_e, dbv_e)
        dw2, db2, dls1 = _unfold_out(w2, b2, ls1, dw2_e, db2_e)
        return (_gn_input_grad(x, g, stats, dxn, sums), dgs + dgs_v, dgb + dgb_v, dwf,
                dbf_e, dwv, dbv_e, dw2, db2, dls1, dab[0].reshape(alpha.shape),
                dab[1].reshape(beta.shape), None)


class _FusedMlpBlockPre(torch.autograd.Function):
    """`fused_mlp_block_pre` under autograd: K1 forward (writing z1 under
    ASY_MLP_BWD_RESIDUALS=1), and `_fused_mlp_block_bwd` of the JAX package
    (K5, reading z1 if it was kept; then the unfold and the GroupNorm input
    gradient in torch).  No gradient flows to the stats."""

    @staticmethod
    def forward(ctx, x, stats, gn_scale, gn_bias, w1, b1, w2, b2, ls2):
        ctx.z1 = residual_switches()[1]              # read once, as JAX reads it per trace
        ops = _mlp_operands(x, gn_scale, gn_bias, w1, b1, w2, b2, ls2)
        saved = (x, stats, gn_scale, gn_bias, w1, b1, w2, b2, ls2)
        if ctx.z1:
            out, z1 = mlp_block(x, stats, *ops, return_z1=True)
            saved += (z1,)
        elif _SPAN.recompute and _SPAN.tail:
            out = torch.empty_like(x)                # dropped by checkpoint (see _SPAN)
        else:
            out = mlp_block(x, stats, *ops)
        ctx.save_for_backward(*saved)
        return out

    @staticmethod
    def backward(ctx, g):
        x, stats, gs, gb, w1, b1, w2, b2, ls2, *z1 = ctx.saved_tensors
        w1_e, b1_e, w2_e, _ = _mlp_operands(x, gs, gb, w1, b1, w2, b2, ls2)
        g = g.to(x.dtype).contiguous()
        dxn, dw1_e, db1_e, dw2_e, db2_e, sums = mlp_block_bwd(
            x, g, stats, w1_e, b1_e, w2_e, z1[0] if ctx.z1 else None)
        dw1, dgs, dgb = _unfold_in(gs, gb, w1, dw1_e, db1_e)
        dw2, db2, dls2 = _unfold_out(w2, b2, ls2, dw2_e, db2_e)
        return (_gn_input_grad(x, g, stats, dxn, sums), None, dgs, dgb, dw1, db1_e, dw2,
                db2, dls2)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def fused_mixer_block_stats(x, gn_scale, gn_bias, wf, bf, wv, bv, w2, b2, ls1,
                            alpha, beta, heads, fold_h, fold_w, proposal_h,
                            proposal_w):
    """Mixer half from canonical params.  x NHWC; weights in (in, out) matmul
    layout, f32.  Returns (out, gn_stats_of_out (B, 2)).  Differentiable in
    x and every parameter; without autograd it writes no residuals."""
    args = (x, gn_scale, gn_bias, wf, bf, wv, bv, w2, b2, ls1, alpha, beta)
    geo = dict(heads=heads, fold_h=fold_h, fold_w=fold_w, proposal_h=proposal_h,
               proposal_w=proposal_w)
    if _needs_grad(*args):
        return _FusedMixerBlockStats.apply(*args, geo)
    out, moments = mixer_block(x, gn1_stats(x), *_mixer_operands(*args), **geo)
    return out, _stats_from_moments(moments, x[0].numel())


def fused_mlp_block_pre(x, stats, gn_scale, gn_bias, w1, b1, w2, b2, ls2):
    """MLP half from canonical params and pre-reduced stats of x (NHWC).
    Differentiable in x and every parameter, not in the stats."""
    args = (x, stats, gn_scale, gn_bias, w1, b1, w2, b2, ls2)
    if _needs_grad(*args):
        return _FusedMlpBlockPre.apply(*args)
    return mlp_block(x, stats, *_mlp_operands(x, gn_scale, gn_bias, w1, b1, w2, b2, ls2))
