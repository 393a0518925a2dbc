"""Context-Cluster token mixing, plain PyTorch (counterpart of
`asy_vrnet_tpu/ops/cluster.py`; reference semantics vr_coc.py:114-192).

    tokens:   (B, heads, R, N, D)   N = region tokens, M = proposals
    sim     = sigmoid(beta + alpha * cos(centers, tokens))       [B,h,R,M,N]
    mask    = one_hot(argmax_M sim)                              hard assign
    out_c   = (sim^T v + v_centers) / (count + 1)                aggregate
    out     = dispatch back to tokens via sim                    [B,h,R,N,D]

Layout at the public function is NHWC (B, H, W, heads*D), as in JAX.
"""
from __future__ import annotations

import torch

from asy_vrnet_tpu_torch.ops.resize import _adaptive_avg_matrix


def _fold_tokens(x: torch.Tensor, heads: int, fold_h: int, fold_w: int):
    """NHWC (B,H,W,heads*D) -> (B, heads, R, N, D); regions are contiguous
    (rh, rw) blocks, tokens row-major inside a region."""
    b, h, w, c = x.shape
    d = c // heads
    rh, rw = h // fold_h, w // fold_w
    x = x.reshape(b, fold_h, rh, fold_w, rw, heads, d)
    x = x.permute(0, 5, 1, 3, 2, 4, 6)
    return x.reshape(b, heads, fold_h * fold_w, rh * rw, d), (rh, rw)


def _unfold_tokens(x: torch.Tensor, hw: tuple[int, int], fold_h: int, fold_w: int):
    """(B, heads, R, N, D) -> NHWC (B,H,W,heads*D); inverse of _fold_tokens."""
    b, heads, r, n, d = x.shape
    rh, rw = hw
    x = x.reshape(b, heads, fold_h, fold_w, rh, rw, d)
    x = x.permute(0, 2, 4, 3, 5, 1, 6)
    return x.reshape(b, fold_h * rh, fold_w * rw, heads * d)


def _pool_matrix(region_hw, proposal_hw, device, dtype) -> torch.Tensor:
    """(M, N) adaptive-avg-pool matrix over a region's flattened tokens."""
    (rh, rw), (ph, pw) = region_hw, proposal_hw
    mh = _adaptive_avg_matrix(rh, ph)
    mw = _adaptive_avg_matrix(rw, pw)
    pool = (mh[:, None, :, None] * mw[None, :, None, :]).reshape(ph * pw, rh * rw)
    return torch.as_tensor(pool, device=device, dtype=dtype)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """L2-normalise the last dim in x's dtype, op by op as JAX does; the
    rsqrt is taken in f32 and rounded once (torch's bf16 rsqrt on the CPU is
    not correctly rounded)."""
    e = (x * x).sum(dim=-1, keepdim=True) + 1e-12
    return x * torch.rsqrt(e.float()).to(x.dtype)


def cluster_mix(
    feat: torch.Tensor,
    value: torch.Tensor,
    sim_alpha: torch.Tensor | float,
    sim_beta: torch.Tensor | float,
    *,
    heads: int,
    fold_h: int,
    fold_w: int,
    proposal_h: int,
    proposal_w: int,
    return_center: bool = False,
    return_assign: bool = False,
):
    """Cluster token mixing between the fc1/fc_v and fc2 projections.

    feat, value: NHWC (B,H,W,heads*head_dim).  Returns the dispatched NHWC map
    (same shape), or the per-region centers if return_center.  With
    return_assign, also the (B, heads, H, W) int64 index of each token's
    center (first-max ties, torch `.max` semantics).

    Dtypes follow the JAX package, whose alpha and beta are f32 params: the
    pooling and the cosine product stay in feat's dtype; sigmoid(beta +
    alpha * cos) and everything after it (mask, counts, aggregation, centers,
    dispatch) are f32, so the result is f32.  The caller casts it back to
    the compute dtype (JAX's fc2, a bf16 `nn.Conv`, does)."""
    b, h, w, c = feat.shape
    if h % fold_h or w % fold_w:
        raise ValueError(f"feature map {h}x{w} not divisible by fold {fold_h}x{fold_w}")
    x, region_hw = _fold_tokens(feat, heads, fold_h, fold_w)       # (B,h,R,N,D)
    v, _ = _fold_tokens(value, heads, fold_h, fold_w)
    pool = _pool_matrix(region_hw, (proposal_h, proposal_w), feat.device, feat.dtype)
    centers = torch.einsum("mn,bhrnd->bhrmd", pool, x)
    v_centers = torch.einsum("mn,bhrnd->bhrmd", pool, v)

    cos = torch.einsum("bhrmd,bhrnd->bhrmn", _normalize(centers), _normalize(x))
    f32 = torch.float32
    alpha = torch.as_tensor(sim_alpha, dtype=f32, device=feat.device)
    beta = torch.as_tensor(sim_beta, dtype=f32, device=feat.device)
    sim = torch.sigmoid(beta + alpha * cos.to(f32))

    m = sim.shape[-2]
    assign = torch.argmax(sim, dim=-2)                               # (B,h,R,N)
    mask = torch.nn.functional.one_hot(assign, m).movedim(-1, -2).to(sim.dtype)
    sim = sim * mask
    counts = mask.sum(dim=-1, keepdim=True)
    agg = torch.einsum("bhrmn,bhrnd->bhrmd", sim, v.to(f32))
    out_centers = (agg + v_centers.to(f32)) / (counts + 1.0)
    if return_center:
        return out_centers
    out = torch.einsum("bhrmn,bhrmd->bhrnd", sim, out_centers)
    out = _unfold_tokens(out, region_hw, fold_h, fold_w)
    if return_assign:
        a = _unfold_tokens(assign[..., None], region_hw, fold_h, fold_w)  # (B,H,W,h)
        return out, a.permute(0, 3, 1, 2)
    return out
