"""Cluster token mixer and the pre-norm residual ClusterBlock (counterpart of
`asy_vrnet_tpu/models/cluster_block.py`; reference vr_coc.py:128-300).

Where the shape allows (`mixer_block_supported` and `mlp_block_supported`,
the JAX package's predicates) and `fused=True`, each residual half of the
block is one fused op (`ops/block.py`: a CUDA kernel on the card, its plain
twin on the CPU).  Otherwise the module path runs: GN1 -> Cluster (fc1/fc_v
-> plain `cluster_mix` -> fc2) -> LayerScale -> +x; GN2 -> Mlp ->
LayerScale -> +x.  Both paths read the same parameters.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from asy_vrnet_tpu_torch.models.layers import Conv2d, DropPath, GroupNorm1, Mlp
from asy_vrnet_tpu_torch.ops.block import (
    fused_mixer_block_stats,
    fused_mlp_block_pre,
    mixer_block_supported,
    mlp_block_supported,
)
from asy_vrnet_tpu_torch.ops.cluster import cluster_mix


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _matmul_w(conv: nn.Conv2d) -> torch.Tensor:
    """1x1 conv weight (O, I, 1, 1) -> (I, O) matmul layout."""
    return conv.weight[:, :, 0, 0].t()


class Cluster(nn.Module):
    """Context-cluster token mixer (vr_coc.py:128-192)."""

    def __init__(self, dim: int, out_dim: int, proposal_w: int = 2,
                 proposal_h: int = 2, fold_w: int = 2, fold_h: int = 2,
                 heads: int = 4, head_dim: int = 24):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.fold_h, self.fold_w = heads, fold_h, fold_w
        self.proposal_h, self.proposal_w = proposal_h, proposal_w
        self.fc1 = Conv2d(dim, inner, 1)
        self.fc2 = Conv2d(inner, out_dim, 1)
        self.fc_v = Conv2d(dim, inner, 1)
        self.sim_alpha = nn.Parameter(torch.ones(1))
        self.sim_beta = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        value = _nhwc(self.fc_v(x))
        feat = _nhwc(self.fc1(x))
        out = cluster_mix(
            feat, value, self.sim_alpha.to(x.dtype), self.sim_beta.to(x.dtype),
            heads=self.heads, fold_h=self.fold_h, fold_w=self.fold_w,
            proposal_h=self.proposal_h, proposal_w=self.proposal_w,
        )
        return self.fc2(_nchw(out).contiguous(memory_format=torch.channels_last))


class ClusterBlock(nn.Module):
    """GN1 -> Cluster -> LayerScale -> +x; GN1 -> MLP -> LayerScale -> +x
    (vr_coc.py:226-275).  Inference only: dropout and DropPath are identities.
    Input and output are NCHW in channels_last memory."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 layer_scale_init_value: float = 1e-5, proposal_w: int = 2,
                 proposal_h: int = 2, fold_w: int = 2, fold_h: int = 2,
                 heads: int = 4, head_dim: int = 24, fused: bool = True):
        super().__init__()
        self.dim, self.heads, self.head_dim = dim, heads, head_dim
        self.fold_h, self.fold_w = fold_h, fold_w
        self.proposal_h, self.proposal_w = proposal_h, proposal_w
        self.fused = fused
        self.norm1 = GroupNorm1(dim)
        self.token_mixer = Cluster(dim, dim, proposal_w, proposal_h, fold_w,
                                   fold_h, heads, head_dim)
        self.norm2 = GroupNorm1(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        self.drop_path = DropPath(drop_path)
        self.layer_scale_1 = nn.Parameter(layer_scale_init_value * torch.ones(dim))
        self.layer_scale_2 = nn.Parameter(layer_scale_init_value * torch.ones(dim))

    def fused_ok(self, x: torch.Tensor) -> bool:
        b, c, h, w = x.shape
        shape = (b, h, w, c)
        return self.fused and mixer_block_supported(
            shape, heads=self.heads, head_dim=self.head_dim,
            fold_h=self.fold_h, fold_w=self.fold_w,
            proposal_h=self.proposal_h, proposal_w=self.proposal_w,
        ) and mlp_block_supported(shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_ok(x):
            tm, mlp = self.token_mixer, self.mlp
            y, stats = fused_mixer_block_stats(
                _nhwc(x), self.norm1.weight, self.norm1.bias,
                _matmul_w(tm.fc1), tm.fc1.bias, _matmul_w(tm.fc_v), tm.fc_v.bias,
                _matmul_w(tm.fc2), tm.fc2.bias, self.layer_scale_1,
                tm.sim_alpha, tm.sim_beta, self.heads, self.fold_h,
                self.fold_w, self.proposal_h, self.proposal_w,
            )
            y = fused_mlp_block_pre(
                y, stats, self.norm2.weight, self.norm2.bias,
                _matmul_w(mlp.fc1), mlp.fc1.bias, _matmul_w(mlp.fc2),
                mlp.fc2.bias, self.layer_scale_2,
            )
            return _nchw(y)
        ls = lambda p: p.to(x.dtype).view(1, -1, 1, 1)  # noqa: E731
        x = x + self.drop_path(self.token_mixer(self.norm1(x)) * ls(self.layer_scale_1))
        return x + self.drop_path(self.mlp(self.norm2(x)) * ls(self.layer_scale_2))
