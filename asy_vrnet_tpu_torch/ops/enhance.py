"""Image enhancement on the device: dark-channel dehaze and ACE-style
sharpen (counterpart of `asy_vrnet_tpu/ops/enhance.py`; the reference's
OpenCV demos image_augmentation_test/dark_channel.py and sharpen.py).

Erosion and box filters are torch pools; the atmospheric-light estimate
takes a fixed number of the brightest dark-channel pixels.  Inputs are
float images in [0, 1], HWC.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _pool_hwc(x: torch.Tensor, pool) -> torch.Tensor:
    """Apply an NCHW pool to an HWC tensor."""
    return pool(x.permute(2, 0, 1)[None])[0].permute(1, 2, 0)


def _min_pool(x: torch.Tensor, size: int) -> torch.Tensor:
    """Per-channel min filter (erosion with a square kernel), HWC; the
    padding counts as +inf, as the JAX version's init value."""
    return _pool_hwc(x, lambda t: -F.max_pool2d(-t, size, stride=1, padding=size // 2))


def _box_filter(x: torch.Tensor, r: int) -> torch.Tensor:
    """Mean filter over an (r, r) window, HWC, divided by the count of
    in-image pixels (the JAX version's sum of ones).  The sums run in
    float64: the guided filter divides differences of these means by a
    local variance, and f32 sums over 61 x 61 windows put the dehazed image
    ~4e-5 off its float64 value (the JAX version's f32 sums ~4e-6)."""
    return _pool_hwc(x.double(), lambda t: F.avg_pool2d(
        t, r, stride=1, padding=r // 2, count_include_pad=False)).to(x.dtype)


def dark_channel(image: torch.Tensor, size: int = 15) -> torch.Tensor:
    """(H, W, 3) -> (H, W, 1) dark channel: min over RGB, then a min filter."""
    return _min_pool(image.amin(dim=-1, keepdim=True), size)


def _atmospheric_light(image: torch.Tensor, dark: torch.Tensor) -> torch.Tensor:
    h, w, _ = image.shape
    npx = max((h * w) // 1000, 1)
    # the npx largest dark-channel values, ties to the lower index as
    # lax.top_k breaks them (torch.topk promises no order on the card)
    idx = torch.sort(dark.reshape(-1), descending=True, stable=True).indices[:npx]
    return image.reshape(-1, 3)[idx].mean(dim=0)     # (3,)


def dehaze_dark_channel(image: torch.Tensor, size: int = 15, omega: float = 0.95,
                        guided_r: int = 61, guided_eps: float = 1e-4,
                        t0: float = 0.1) -> torch.Tensor:
    """Single-image haze removal (He et al.), HWC float in [0, 1]."""
    dark = dark_channel(image, size)
    a = _atmospheric_light(image, dark)
    te = 1.0 - omega * dark_channel(image / a, size)

    # guided filter with the gray image as guide
    gray = image.mean(dim=-1, keepdim=True)
    mean_i = _box_filter(gray, guided_r)
    mean_p = _box_filter(te, guided_r)
    mean_ip = _box_filter(gray * te, guided_r)
    cov_ip = mean_ip - mean_i * mean_p
    mean_ii = _box_filter(gray * gray, guided_r)
    var_i = mean_ii - mean_i * mean_i
    aa = cov_ip / (var_i + guided_eps)
    bb = mean_p - aa * mean_i
    t = _box_filter(aa, guided_r) * gray + _box_filter(bb, guided_r)

    t = t.clamp_min(t0)
    return ((image - a) / t + a).clamp(0.0, 1.0)


def unsharp_mask(image: torch.Tensor, radius: int = 5, amount: float = 1.0) -> torch.Tensor:
    """Classic unsharp sharpen, HWC float in [0, 1]."""
    blurred = _box_filter(image, radius)
    return (image + amount * (image - blurred)).clamp(0.0, 1.0)


def ace_enhance(image: torch.Tensor, radius: int = 31, gain: float = 3.0) -> torch.Tensor:
    """ACE-style local contrast enhancement (sharpen.py's capability): local
    mean removal with bounded gain, then a global [0, 1] stretch."""
    local_mean = _box_filter(image, radius)
    out = local_mean + (gain * (image - local_mean)).clamp(-1.0, 1.0)
    lo, hi = out.min(), out.max()
    return (out - lo) / (hi - lo + 1e-12)
