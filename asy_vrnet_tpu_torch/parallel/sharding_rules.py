"""Parameter sharding over the mesh's "model" axis (the port's counterpart of
`asy_vrnet_tpu/parallel/sharding_rules.py`).

The JAX package's rule: a kernel leaf of two or more axes whose output
channels (flax's last axis) number at least `min_channels` and split evenly
over "model" is sharded on that axis; everything else is replicated.  The
port selects the same leaves through the weight bridge's key map
(`utils/weights.py`): a port parameter is sharded where its flax leaf would
be, on the axis that holds the output channels (dim 0 of a conv weight).

`shard_params` keeps each selected weight as this rank's slice of its
output channels and gathers the whole weight over "model" wherever the
model reads it (a parametrization), as GSPMD's inserted all-gather hands a
conv its operand: a conv on slices of weight, bias and input is not the
conv of the whole (the sharded output channels would each need every input
channel).  The forward is the replicated forward.  A sharded model's
state_dict names the slices `<module>.parametrizations.weight.original`.
"""
from __future__ import annotations

from typing import Mapping, Optional, Union

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh
from torch.nn.utils import parametrize

from asy_vrnet_tpu_torch.utils.weights import flax_leaf, flax_path_for

MeshLike = Union[DeviceMesh, Mapping[str, int]]


def _axis_size(mesh: MeshLike, axis: str) -> int:
    if isinstance(mesh, DeviceMesh):
        return mesh.mesh.shape[mesh.mesh_dim_names.index(axis)]
    return int(mesh[axis])


def param_sharding_rules(model: nn.Module, mesh: MeshLike,
                         min_channels: int = 64) -> dict[str, Optional[int]]:
    """Port parameter name -> the dim sharded over "model", or None where
    the parameter is replicated.  `mesh` is a DeviceMesh or the mapping of
    axis sizes (JAX's `Mesh.shape`), which needs no process group."""
    model_size = _axis_size(mesh, "model")
    rules = {}
    for key, p in model.named_parameters():
        leaf = flax_path_for(key)[-1]
        shape = flax_leaf(leaf, p).shape
        dim = None
        if model_size > 1 and len(shape) >= 2:
            out_ch = shape[-1]
            if out_ch >= min_channels and out_ch % model_size == 0:
                # the port keeps a conv kernel (O, I, kh, kw); other leaves
                # in flax's own layout
                dim = 0 if leaf == "kernel" and p.dim() == 4 else p.dim() - 1
        rules[key] = dim
    return rules


class _Gather(torch.autograd.Function):
    """The whole tensor from every rank's slice along `dim`.  Backward: this
    rank's slice of the gradient (every rank of the group runs the op on
    the same data, so each one's gradient is already whole)."""

    @staticmethod
    def forward(ctx, shard, group, rank, size, dim):
        parts = [torch.empty_like(shard) for _ in range(size)]
        dist.all_gather(parts, shard.contiguous(), group=group)
        ctx.slice = (dim, rank * shard.shape[dim], shard.shape[dim])
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(*ctx.slice), None, None, None, None


class _GatheredShard(nn.Module):
    """Parametrization: the stored tensor is this rank's output-channel
    slice; reading the parameter gathers the whole one."""

    def __init__(self, group, rank: int, size: int, dim: int):
        super().__init__()
        self.group, self.rank, self.size, self.dim = group, rank, size, dim

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(shard, self.group, self.rank, self.size, self.dim)

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        return full.chunk(self.size, self.dim)[self.rank].clone()


def shard_params(model: nn.Module, mesh: DeviceMesh, min_channels: int = 64) -> nn.Module:
    """Hold every parameter `param_sharding_rules` selects as this rank's
    slice over "model", gathered at use; in place, returns the model."""
    group, rank = mesh.get_group("model"), mesh.get_local_rank("model")
    size = _axis_size(mesh, "model")
    for key, dim in param_sharding_rules(model, mesh, min_channels).items():
        if dim is None:
            continue
        owner, _, name = key.rpartition(".")
        parametrize.register_parametrization(model.get_submodule(owner), name,
                                             _GatheredShard(group, rank, size, dim),
                                             unsafe=True)
    return model
