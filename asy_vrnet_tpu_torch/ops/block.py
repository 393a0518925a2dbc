"""The two fused ClusterBlock halves (counterpart of
`asy_vrnet_tpu/ops/block_pallas.py`), each a hand-written CUDA kernel with a
plain PyTorch twin:

  mixer half (K2): x + ls1 * fc2(cluster_mix(fc1(GN1(x)), fc_v(GN1(x))))
                   plus the per-sample moments of its output
  MLP half   (K1): x + ls2 * fc2(GELU(fc1(GN2(x))))  with pre-reduced stats

GroupNorm(1)'s per-sample statistics are a cross-tile reduction, so they come
in as (B, 2) [mean, rstd]; the GN affine folds into the input-side weights
and LayerScale into the output-side ones (`_fold_in`/`_fold_out`).  The mixer
half also returns its output's GN statistics, which the MLP half consumes, so
a block reads its input from device memory once per half.

Layout at every public function is NHWC (B, H, W, C), contiguous; the model
passes the NHWC view of its channels_last tensors.  `mixer_block` and
`mlp_block` take CPU tensors through the plain version and CUDA tensors
through the kernel (or raise); each counts its kernel launches in LAUNCHES.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from asy_vrnet_tpu_torch.ops.cluster import cluster_mix

_GN_EPS = 1e-5

# kernel launches per wrapper; plain-version calls are not counted
LAUNCHES = {"mixer_block": 0, "mlp_block": 0}


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


def mixer_block_supported(shape, *, heads, head_dim, fold_h, fold_w,
                          proposal_h, proposal_w) -> bool:
    """`block_pallas.py::mixer_block_supported` (via `pallas_supported`)."""
    b, h, w, _ = shape
    if h % fold_h or w % fold_w:
        return False
    n = (h // fold_h) * (w // fold_w)
    if not (8 <= n <= _MAX_TOKENS_PER_REGION) or head_dim < 8:
        return False
    hb = _group_w(fold_w, n) * heads * proposal_h * proposal_w
    return hb <= _MAX_SIM_ROWS


def mlp_block_supported(shape) -> bool:
    b, h, w, c = shape
    return h * w >= 8


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round to the working dtype and compute on in f32."""
    return t.to(dtype).float()


def mixer_block_plain(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta, *, heads,
                      fold_h, fold_w, proposal_h, proposal_w,
                      return_assign=False):
    """Plain mixer half on folded weights: GN -> 1x1 -> cluster_mix -> fc2 ->
    residual, computed in f32 with the working dtype's roundings where the
    JAX package's `_mixer_block_ref` has them.  Returns (out, moments (B,2))
    [, assignments (B, heads, H, W)]."""
    dt = x.dtype
    xf = x.float()
    xn = (xf - stats[:, 0, None, None, None]) * stats[:, 1, None, None, None]
    xnb = _round(xn, dt)
    feat = _round(xnb @ wf.float() + bf, dt)
    value = _round(xnb @ wv.float() + bv, dt)
    mixed = cluster_mix(feat, value, alpha_beta[0], alpha_beta[1], heads=heads,
                        fold_h=fold_h, fold_w=fold_w, proposal_h=proposal_h,
                        proposal_w=proposal_w, return_assign=return_assign)
    if return_assign:
        mixed, assign = mixed
    y = _round(mixed, dt) @ w2.float() + b2
    out = (xf + y).to(dt)
    ob = out.float()
    moments = torch.stack([ob.sum(dim=(1, 2, 3)), (ob * ob).sum(dim=(1, 2, 3))], -1)
    if return_assign:
        return out, moments, assign
    return out, moments


def mlp_block_plain(x, stats, w1, b1, w2, b2):
    """Plain MLP half on folded weights (exact-erf GELU), in f32 with the
    working dtype's roundings at the kernel's matmul operands."""
    dt = x.dtype
    xf = x.float()
    xn = (xf - stats[:, 0, None, None, None]) * stats[:, 1, None, None, None]
    z = _round(xn, dt) @ w1.float() + b1
    y = _round(F.gelu(z), dt) @ w2.float() + b2
    return (xf + y).to(dt)


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


def mixer_block(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta, *, heads,
                fold_h, fold_w, proposal_h, proposal_w, return_assign=False):
    """Mixer half on folded weights.  x (B,H,W,C) bf16|f32; wf/wv (C,I) and
    w2 (I,C) in x's dtype; biases, stats (B,2) and alpha_beta (2,) f32.
    Returns (out (B,H,W,C), moments (B,2) f32 [sum, sum sq] of the stored
    output) [, assignments (B, heads, H, W)]."""
    kw = dict(heads=heads, fold_h=fold_h, fold_w=fold_w,
              proposal_h=proposal_h, proposal_w=proposal_w)
    if x.device.type == "cpu":
        return mixer_block_plain(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta,
                                 return_assign=return_assign, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"mixer_block: unsupported device {x.device}")
    from asy_vrnet_tpu_torch.ops import kernels

    b, h, w, c = x.shape
    inner = wf.shape[1]
    f32, dev = torch.float32, x.device
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"mixer_block: dtype {x.dtype} not supported")
    _check("x", x, (b, h, w, c), x.dtype, dev)
    _check("stats", stats, (b, 2), f32, dev)
    _check("wf", wf, (c, inner), x.dtype, dev)
    _check("bf", bf, (inner,), f32, dev)
    _check("wv", wv, (c, inner), x.dtype, dev)
    _check("bv", bv, (inner,), f32, dev)
    _check("w2", w2, (inner, c), x.dtype, dev)
    _check("b2", b2, (c,), f32, dev)
    _check("alpha_beta", alpha_beta, (2,), f32, dev)
    if inner % heads or h % fold_h or w % fold_w:
        raise ValueError("mixer_block: heads/folds do not divide the shape")
    out = torch.empty_like(x)
    regions = fold_h * fold_w
    g = kernels.mixer_cluster_size(heads, b * regions, dev)
    part = torch.empty((b, regions * g, 2), dtype=f32, device=dev)
    assign = (torch.empty((b, h, w, heads), dtype=torch.int8, device=dev)
              if return_assign else None)
    kernels.mixer_block(x, stats, wf, bf, wv, bv, w2, b2, alpha_beta, out,
                        part, assign, heads=heads, fold_h=fold_h,
                        fold_w=fold_w, proposal_h=proposal_h,
                        proposal_w=proposal_w)
    LAUNCHES["mixer_block"] += 1
    moments = part.sum(dim=1)
    if return_assign:
        return out, moments, assign.permute(0, 3, 1, 2).long()
    return out, moments


def mlp_block(x, stats, w1, b1, w2, b2):
    """MLP half on folded weights.  x (B,H,W,C) bf16|f32; w1 (C,hid) and w2
    (hid,C) in x's dtype; biases and stats (B,2) f32."""
    if x.device.type == "cpu":
        return mlp_block_plain(x, stats, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_block: unsupported device {x.device}")
    from asy_vrnet_tpu_torch.ops import kernels

    b, h, w, c = x.shape
    hid = w1.shape[1]
    f32, dev = torch.float32, x.device
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"mlp_block: dtype {x.dtype} not supported")
    _check("x", x, (b, h, w, c), x.dtype, dev)
    _check("stats", stats, (b, 2), f32, dev)
    _check("w1", w1, (c, hid), x.dtype, dev)
    _check("b1", b1, (hid,), f32, dev)
    _check("w2", w2, (hid, c), x.dtype, dev)
    _check("b2", b2, (c,), f32, dev)
    out = torch.empty_like(x)
    kernels.mlp_block(x, stats, w1, b1, w2, b2, out)
    LAUNCHES["mlp_block"] += 1
    return out


# ---------------------------------------------------------------------------
# the entries ClusterBlock calls (counterparts of fused_mixer_block_stats and
# fused_mlp_block_pre, lane_fold=1)
# ---------------------------------------------------------------------------

def fused_mixer_block_stats(x, gn_scale, gn_bias, wf, bf, wv, bv, w2, b2, ls1,
                            alpha, beta, heads, fold_h, fold_w, proposal_h,
                            proposal_w):
    """Mixer half from canonical params.  x NHWC; weights in (in, out) matmul
    layout, f32.  Returns (out, gn_stats_of_out (B, 2))."""
    f32, dt = torch.float32, x.dtype
    wf_e, bf_e = _fold_in(gn_scale, gn_bias, wf, bf)
    wv_e, bv_e = _fold_in(gn_scale, gn_bias, wv, bv)
    w2_e, b2_e = _fold_out(w2, b2, ls1)
    alpha_beta = torch.stack([alpha.reshape(()), beta.reshape(())]).to(f32)
    out, moments = mixer_block(
        x, gn1_stats(x), wf_e.to(dt).contiguous(), bf_e.to(f32),
        wv_e.to(dt).contiguous(), bv_e.to(f32), w2_e.to(dt).contiguous(),
        b2_e.to(f32), alpha_beta, heads=heads, fold_h=fold_h, fold_w=fold_w,
        proposal_h=proposal_h, proposal_w=proposal_w)
    return out, _stats_from_moments(moments, x[0].numel())


def fused_mlp_block_pre(x, stats, gn_scale, gn_bias, w1, b1, w2, b2, ls2):
    """MLP half from canonical params and pre-reduced stats of x (NHWC)."""
    f32, dt = torch.float32, x.dtype
    w1_e, b1_e = _fold_in(gn_scale, gn_bias, w1, b1)
    w2_e, b2_e = _fold_out(w2, b2, ls2)
    return mlp_block(x, stats, w1_e.to(dt).contiguous(), b1_e.to(f32),
                     w2_e.to(dt).contiguous(), b2_e.to(f32))
