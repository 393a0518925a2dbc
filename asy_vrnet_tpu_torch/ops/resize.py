"""Resize / pooling ops (counterpart of `asy_vrnet_tpu/ops/resize.py`).

The JAX package writes align-corners bilinear resizing as interpolation
matmuls for the TPU's matrix unit; on the GPU the natural op is
`F.interpolate(mode="bilinear", align_corners=True)`, which computes the
same function (torch `nn.Upsample` semantics, which the reference uses).
Tensors here are NCHW (the model keeps them in `torch.channels_last`).
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
