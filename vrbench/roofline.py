"""Peaks of one H100 SXM and the least time of the fused ClusterBlock
kernels, counted from their shapes: each input read once, each output
written once, the products the mathematics needs (the arithmetic of
`chip_smoke.py`'s `*_bounds`, kept here so the yardstick does not move with
the program).  A kernel's roofline share is its bound over its device time.
"""
from __future__ import annotations

from typing import NamedTuple

PEAK_FLOPS = 989e12      # dense bf16 tensor cores
PEAK_FLOPS_F32 = 67e12   # f32 outside the tensor cores
PEAK_BYTES = 3.35e12     # HBM3

WIDTHS = {"nano": 0.25, "tiny": 0.375, "s": 0.50, "m": 0.75, "l": 1.00}
# coc_small: layers, widths before scaling, MLP ratios, heads, fold
COC = {"coc_small": (2, 2, 6, 2), "coc_dryrun": (1, 1, 1, 1)}
EMBED, RATIOS, HEADS, FOLD, HEAD_DIM = (64, 128, 320, 512), (8, 8, 4, 4), (4, 4, 8, 8), (8, 4, 2, 1), 32


class Block(NamedTuple):
    """One fused ClusterBlock: NHWC (b, h, w, c), its mixer's heads x
    head_dim and fold, the MLP's hidden width."""
    b: int
    h: int
    w: int
    c: int
    heads: int
    head_dim: int
    fold: int
    hid: int


def blocks(model_cfg: dict, batch: int) -> list[Block]:
    """The model's fused ClusterBlocks in forward order: both backbone
    streams of each stage, then the det FPN's p5, p4, p3 CoCConv blocks."""
    width = WIDTHS[model_cfg["phi"]]
    dims = [int(d * width) for d in EMBED]
    h0, w0 = model_cfg["input_size"]
    out = []
    for i, n in enumerate(COC[model_cfg["variant"]]):
        s = 4 * 2 ** i
        out += [Block(batch, h0 // s, w0 // s, dims[i], HEADS[i], HEAD_DIM, FOLD[i],
                      int(dims[i] * RATIOS[i]))] * (2 * n)
    c2, c3, c4, c5 = dims
    for s, c in ((32, c5), (16, 2 * c4), (8, 2 * c3)):
        out.append(Block(batch, h0 // s, w0 // s, c, 4, 24, 2, 4 * c))
    return out


def mixer_bounds(b, h, w, c, heads, d, fold):
    """K2: per token fc1 / fc_v (2*C*I), the cosines and sims (2*I*(M+1)),
    the norms (4*C*heads); per region the centers' pooling and dispatch
    (8*M*C*I).  Bytes: x in, out out (bf16), three weights."""
    t, inner, m = b * h * w, heads * d, 4
    regions = b * fold * fold
    flops = t * (2 * c * inner + 2 * inner * (m + 1) + 4 * c * heads) + regions * 8 * m * c * inner
    return flops, 2 * t * c * 2 + 3 * c * inner * 2


def mlp_bounds(b, h, w, c, hid):
    """K1: 4*C*hid per token; x in, out out (bf16), w1, w2."""
    t = b * h * w
    return 4 * t * c * hid, 2 * t * c * 2 + 2 * c * hid * 2


def mixer_bwd_bounds(b, h, w, c, heads, d, fold, m=4):
    """K6: per token feat, d feat @ wf^T and dWf (6*C*I), the winners'
    terms (10*C per head), the norms (4*I), the pooling (2*C).  Bytes: x, g,
    dxn (bf16), the pack (cosine bf16 + proposal int8 per (token, head); two
    center sets), wf, wv, w2 (bf16), the f32 weight gradients."""
    t, inner, regions = b * h * w, heads * d, b * fold * fold
    flops = t * (6 * c * inner + 10 * c * heads + 4 * inner + 2 * c)
    byts = (3 * t * c * 2 + 3 * c * inner * 2 + (3 * c * inner + 2 * inner + c) * 4
            + 3 * t * heads + 2 * regions * heads * m * d * 2)
    return flops, byts


def mlp_bwd_bounds(b, h, w, c, hid):
    """K5: 8*C*hid per token; x, g, dxn (bf16), w1, w2 (bf16), the f32
    weight gradients."""
    t = b * h * w
    return 8 * t * c * hid, 3 * t * c * 2 + 2 * c * hid * 2 + (2 * c * hid + hid + c) * 4


def bound_ms(flops: float, byts: float, peak: float = PEAK_FLOPS) -> float:
    return max(flops / peak, byts / PEAK_BYTES) * 1e3


def blocks_bound_ms(model_cfg: dict, batch: int, backward: bool) -> float:
    """Σ bound ms of K2 and K1 over the model's blocks, and with `backward`
    of K6 and K5 too (one train step)."""
    total = 0.0
    for k in blocks(model_cfg, batch):
        geo = (k.b, k.h, k.w, k.c)
        total += bound_ms(*mixer_bounds(*geo, k.heads, k.head_dim, k.fold))
        total += bound_ms(*mlp_bounds(*geo, k.hid))
        if backward:
            total += bound_ms(*mixer_bwd_bounds(*geo, k.heads, k.head_dim, k.fold))
            total += bound_ms(*mlp_bwd_bounds(*geo, k.hid))
    return total
