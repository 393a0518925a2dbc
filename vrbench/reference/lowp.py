"""Rounding for the control: the reference computed one precision below the
configuration's bf16 compute dtype.  The program keeps its activations and
the operands of its products in bf16; the control keeps both in fp8: both
operands of every convolution and matrix product, and every module's output,
are rounded to fp8 e4m3 with a scale per tensor (amax to 448), and in the
backward the gradients that reach them to fp8 e5m2 (amax to 57344).  The
arithmetic itself stays f32."""
from __future__ import annotations

import torch

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return ((t * scale).to(dtype).to(t.dtype) / scale)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, _E5M2_MAX)


def fp8(t: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(t)


# the control: Env(**CONTROL) in the reference
CONTROL = {"rounding": fp8}
