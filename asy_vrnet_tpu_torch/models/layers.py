"""Primitive layers (counterpart of `asy_vrnet_tpu/models/layers.py`).

Tensors are NCHW in `torch.channels_last` memory (NHWC bytes).  Parameters
stay float32; every op runs in the dtype of its input (bf16 on the card,
f32 for the CPU parity tests), casting weights at the call like the JAX
package's `dtype=` modules do.  Modules follow `self.training`: BatchNorm
normalises with batch statistics and updates its running ones, `DropPath` and
the `Mlp` dropout draw from an explicit `torch.Generator`.  Only the literal
(non space-to-depth) branches of the JAX layers are ported; the s2d/lane-fold
forms are TPU re-layouts.
"""
from __future__ import annotations

import math
import threading
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from asy_vrnet_tpu_torch.ops.block import gn1_stats
from asy_vrnet_tpu_torch.ops.resize import global_avg_pool


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """Channel shuffle of NCHW; identity when C % groups != 0 (vr_coc.py:70-80)."""
    b, c, h, w = x.shape
    if c % groups:
        return x
    x = x.reshape(b, groups, c // groups, h, w).transpose(1, 2)
    return x.reshape(b, c, h, w).contiguous(memory_format=torch.channels_last)


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "none":
        return lambda x: x
    if name == "silu":
        return F.silu
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, negative_slope=0.1)
    if name == "gelu":
        return F.gelu  # exact erf form, torch nn.GELU default
    raise ValueError(f"Unsupported act type: {name}")


class Conv2d(nn.Conv2d):
    """nn.Conv2d that runs in its input's dtype (f32 params, cast at call)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def bn_eval(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Inference BatchNorm from running stats.

    f32: (x - mean) * scale*rsqrt(var+eps) + bias, flax nn.BatchNorm's order.
    bf16: the JAX package's fast form (`layers.py::_s2d_batchnorm`): the
    per-channel multiplier and offset are computed in f32, cast, and applied
    as one x*mul + add in the compute dtype."""
    mul = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    shape = (1, -1, 1, 1)
    if x.dtype == torch.float32:
        return (x - bn.running_mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)
    add = bn.bias - bn.running_mean * mul
    return x * mul.to(x.dtype).view(shape) + add.to(x.dtype).view(shape)


class _RunningStats(threading.local):
    """`frozen` while a rematerialised span recomputes its forward in this
    thread (models/remat.py): the span's forward updated the running stats
    already, and flax discards the batch_stats of nn.remat's recompute."""
    frozen = False


RUNNING_STATS = _RunningStats()


def bn_train(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Training BatchNorm: normalise with the batch statistics (gradients flow
    through them) and update the running ones in place (not during a remat
    span's recompute).

    parity: flax keeps the *biased* batch variance in the running stats
    (`torch.nn.functional.batch_norm` would store the unbiased one), so the
    batch-stat form is written out.  Moments are f32, var = E[x^2] - E[x]^2.
    f32: flax nn.BatchNorm (variance clipped at 0, (x - mean) * mul + bias).
    bf16: the JAX package's fast form (`layers.py::_s2d_batchnorm`): one
    x*mul + add in the compute dtype, no clip."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = (xf * xf).mean(dim=(0, 2, 3)) - mean * mean
    shape = (1, -1, 1, 1)
    if x.dtype == torch.float32:
        var = var.clamp_min(0.0)
    if not RUNNING_STATS.frozen:
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            bn.running_var.mul_(1.0 - m).add_(var, alpha=m)
    mul = bn.weight * torch.rsqrt(var + bn.eps)
    if x.dtype == torch.float32:
        return (x - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)
    add = bn.bias - mean * mul
    return x * mul.to(x.dtype).view(shape) + add.to(x.dtype).view(shape)


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """BatchNorm in the module's mode: batch statistics when training."""
    return bn_train(x, bn) if bn.training else bn_eval(x, bn)


class BatchNorm2d(nn.BatchNorm2d):
    """Standalone torch-default BatchNorm2d (eps 1e-5, momentum 0.1)."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(channels, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(x, self)


class _DWConv(nn.Module):
    """Depthwise kxk + pointwise 1x1, both bias-free (normal_conv.py:23-33)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.dconv = Conv2d(cin, cin, k, stride, (k - 1) // 2, groups=cin, bias=False)
        self.pconv = Conv2d(cin, cout, 1, bias=False)

    def forward(self, x):
        return self.pconv(self.dconv(x))


class ConvBnAct(nn.Module):
    """Conv2d(bias=False) -> BatchNorm(eps 1e-3) -> act (normal_conv.py:36-52).

    ds_conv=True: the conv is a depthwise kxk + pointwise 1x1 pair."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 act: str = "relu", ds_conv: bool = False, groups: int = 1):
        super().__init__()
        if ds_conv:
            self.conv = _DWConv(cin, cout, k, stride)
        else:
            self.conv = Conv2d(cin, cout, k, stride, (k - 1) // 2,
                               groups=groups, bias=False)
        # torch BatchNorm2d(momentum=0.03), flax decay 0.97
        self.bn = nn.BatchNorm2d(cout, eps=1e-3, momentum=0.03)
        self.act = get_activation(act)

    def forward(self, x):
        return self.act(batch_norm(self.conv(x), self.bn))


class GroupNorm1(nn.GroupNorm):
    """GroupNorm with one group over all channels (vr_coc.py:105-111), with
    f32 statistics like flax's GroupNorm."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(1, channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        st = gn1_stats(x)
        mu = st[:, 0].view(-1, 1, 1, 1)
        rstd = st[:, 1].view(-1, 1, 1, 1)
        y = (x.float() - mu) * rstd
        y = y * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)
        return y.to(x.dtype)


def _bernoulli(shape, keep: float, like: torch.Tensor,
               generator: torch.Generator | None) -> torch.Tensor:
    """Boolean keep-mask drawn on `generator`'s device (the default generator
    of `like`'s device when None)."""
    dev = like.device if generator is None else generator.device
    return (torch.rand(shape, generator=generator, device=dev) < keep).to(like.device)


class Dropout(nn.Module):
    """Inverted dropout that follows `self.training` and draws from
    `self.generator` (set by `set_generator`; None = the default generator)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: torch.Generator | None = None

    def _mask_shape(self, x: torch.Tensor):
        return x.shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = _bernoulli(self._mask_shape(x), keep, x, self.generator)
        return torch.where(mask, x / keep, torch.zeros_like(x))


class DropPath(Dropout):
    """Per-sample stochastic depth (timm DropPath): one draw per sample."""

    def _mask_shape(self, x: torch.Tensor):
        return (x.shape[0],) + (1,) * (x.dim() - 1)


def set_generator(module: nn.Module, generator: torch.Generator | None) -> None:
    """Make every Dropout / DropPath under `module` draw from `generator`."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class Mlp(nn.Module):
    """1x1-conv MLP with exact GELU and dropout after each conv
    (vr_coc.py:195-223)."""

    def __init__(self, cin: int, hidden: int, cout: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = Conv2d(cin, hidden, 1)
        self.fc2 = Conv2d(hidden, cout, 1)
        self.drop = Dropout(drop)

    def forward(self, x):
        return self.drop(self.fc2(self.drop(F.gelu(self.fc1(x)))))


def eca_kernel_size(channels: int, b: int = 1, gamma: int = 2) -> int:
    """Adaptive 1D kernel size from channel count (eca.py:9-10)."""
    k = int(abs((math.log2(channels) + b) / gamma))
    return k if k % 2 else k + 1


class ECA(nn.Module):
    """Efficient Channel Attention: GAP -> 1D conv over channels -> sigmoid
    gate (eca.py:6-22)."""

    def __init__(self, channels: int):
        super().__init__()
        k = eca_kernel_size(channels)
        self.conv = nn.Conv1d(1, 1, k, padding=(k - 1) // 2, bias=False)

    def forward(self, x):
        pooled = global_avg_pool(x, keepdims=False)            # (B, C)
        y = F.conv1d(pooled[:, None, :], self.conv.weight.to(x.dtype),
                     padding=self.conv.padding)[:, 0, :]
        return x * torch.sigmoid(y)[:, :, None, None]


class ShuffleAttention(nn.Module):
    """Shuffle Attention (shuffle_attention.py:8-72), in the per-channel form
    of the JAX package (`layers.py:456-550`): both halves of each group are
    one per-channel affine-in-x sigmoid gate, then channel_shuffle(2)."""

    def __init__(self, channels: int, groups: int = 8):
        super().__init__()
        self.groups = groups
        if channels % (2 * groups):
            raise TypeError(
                f"ShuffleAttention: {channels} channels not divisible by "
                f"2*groups={2 * groups}")
        c2g = channels // (2 * groups)
        self.cweight = nn.Parameter(torch.zeros(1, c2g, 1, 1))
        self.cbias = nn.Parameter(torch.ones(1, c2g, 1, 1))
        self.sweight = nn.Parameter(torch.zeros(1, c2g, 1, 1))
        self.sbias = nn.Parameter(torch.ones(1, c2g, 1, 1))
        self.gn = nn.GroupNorm(c2g, c2g)
        within = torch.arange(channels) % (2 * c2g)
        self.register_buffer("_ci", within % c2g, persistent=False)
        self.register_buffer("_spatial", (within // c2g).bool(), persistent=False)

    def forward(self, x):
        ci = self._ci
        spread = lambda p: p.reshape(-1)[ci].view(1, -1, 1, 1)  # noqa: E731
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        m2 = (xf * xf).mean(dim=(2, 3), keepdim=True)
        var = m2 - mean * mean
        rstd = torch.rsqrt(var + 1e-5)
        sw = spread(self.sweight)
        a_sp = sw * spread(self.gn.weight) * rstd
        t_sp = spread(self.sbias) + sw * spread(self.gn.bias) - a_sp * mean
        t_ch = spread(self.cweight) * mean + spread(self.cbias)
        sel = self._spatial.view(1, -1, 1, 1)
        a = torch.where(sel, a_sp, torch.zeros_like(a_sp)).to(x.dtype)
        t = torch.where(sel, t_sp, t_ch).to(x.dtype)
        return channel_shuffle(x * torch.sigmoid(x * a + t), 2)
