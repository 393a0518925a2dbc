"""Resize / pooling ops (counterpart of `asy_vrnet_tpu/ops/resize.py`).

The JAX package writes align-corners bilinear resizing as interpolation
matmuls for the TPU's matrix unit; on the GPU the natural op is
`F.interpolate(mode="bilinear", align_corners=True)`, which computes the
same function (torch `nn.Upsample` semantics, which the reference uses).
Adaptive average pooling and the PIL-bicubic resize of the on-device
letterbox keep the JAX package's matrix form: two small interpolation
matrices built with numpy, applied with `torch.matmul` over H and W.
Tensors here are NCHW (the model keeps them in `torch.channels_last`); the
JAX helpers take NHWC.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _adaptive_avg_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) averaging matrix matching torch AdaptiveAvgPool.

    torch window for output i: [floor(i*in/out), ceil((i+1)*in/out))."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        lo = (i * in_size) // out_size
        hi = -((-(i + 1) * in_size) // out_size)  # ceil
        w[i, lo:hi] = 1.0 / (hi - lo)
    return w


def _apply_hw_matrices(x: torch.Tensor, wh: np.ndarray, ww: np.ndarray) -> torch.Tensor:
    """(H2,H1) and (W2,W1) matrices over the H and W axes of NCHW x, in
    x's dtype (`_apply_hw_matrices` of the JAX package, which takes NHWC)."""
    wh_t = torch.as_tensor(wh, dtype=x.dtype, device=x.device)
    ww_t = torch.as_tensor(ww, dtype=x.dtype, device=x.device)
    return torch.matmul(torch.matmul(wh_t, x), ww_t.t())


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor with torch `nn.Upsample` semantics."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=align_corners)


def upsample2x(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """nn.Upsample(scale_factor=scale, mode='bilinear', align_corners=True)."""
    h, w = x.shape[-2:]
    return resize_bilinear(x, (h * scale, w * scale), align_corners=True)


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """Mean over H, W of NCHW."""
    return x.mean(dim=(2, 3), keepdim=keepdims)


def adaptive_avg_pool(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """AdaptiveAvgPool2d of NCHW x, exact torch window semantics, as the
    JAX package's averaging matrices."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    (h1, w1), (h2, w2) = x.shape[-2:], out_hw
    return _apply_hw_matrices(x, _adaptive_avg_matrix(h1, h2), _adaptive_avg_matrix(w1, w2))


@functools.lru_cache(maxsize=None)
def _bicubic_matrix_pil(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) matrix reproducing PIL BICUBIC down- and
    upscaling: a support-scaled cubic filter (a = -0.5) with per-row weight
    normalisation (the letterbox, utils/dataloader.py:140).  Built in
    float64, returned as float32."""

    def cubic(t: np.ndarray, a: float = -0.5) -> np.ndarray:
        at = np.abs(t)
        return np.where(
            at <= 1.0,
            (a + 2.0) * at**3 - (a + 3.0) * at**2 + 1.0,
            np.where(at < 2.0, a * at**3 - 5.0 * a * at**2 + 8.0 * a * at - 4.0 * a, 0.0),
        )

    w = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        ws = cubic((np.arange(lo, hi) + 0.5 - center) / filterscale)
        s = ws.sum()
        if s != 0:
            ws = ws / s
        w[i, lo:hi] = ws
    return w.astype(np.float32)


def resize_bicubic_pil(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """PIL-style BICUBIC resize of NCHW x (no clamping; the caller may
    clip)."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    (h1, w1), (h2, w2) = x.shape[-2:], out_hw
    return _apply_hw_matrices(x, _bicubic_matrix_pil(h1, h2), _bicubic_matrix_pil(w1, w2))
