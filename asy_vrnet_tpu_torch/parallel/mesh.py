"""Data-parallel training over N ranks, one process per card (the port's
counterpart of `asy_vrnet_tpu/parallel/mesh.py`).

The JAX package runs one GSPMD program over a ("data", "model") mesh: the
state replicated, the batch sharded over "data", every batch reduction
global.  Here each rank is a process with its own card (or, over gloo, the
CPU or a card it shares), and the program is the port's own train step on
the rank's rows of the global batch with its batch reductions made global
(`collectives`): the parallel step on a global batch gives what the
single-process step gives on that batch, up to the order of the sums.  The
model is not wrapped (no DistributedDataParallel), so its state_dict keys,
and with them the checkpoints, are the same on 1 and on N ranks.

Set-up for one rank: `init_rank` (backend and device explicit: "nccl" for
`cuda:r`, "gloo" for the CPU or for ranks that share a card), `make_mesh`,
`replicate_state`, then the steps of `build_parallel_train_step` /
`build_parallel_eval_step` on `shard_batch`'s rows; `shutdown` at the end.
The ranks of one host start from `torch.multiprocessing.spawn` (the CLI's
`--num-devices`), which stops the others when one fails.
"""
from __future__ import annotations

import socket
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from asy_vrnet_tpu_torch.parallel import collectives
from asy_vrnet_tpu_torch.parallel.sharding_rules import _axis_size, _GatheredShard
from asy_vrnet_tpu_torch.train.checkpoint import _generator
from asy_vrnet_tpu_torch.train.state import TrainState


def free_port() -> int:
    """A free TCP port on this host, for the ranks' rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_rank(rank: int, world: int, backend: str, device: str | torch.device,
              init_method: str) -> torch.device:
    """Join the process group as `rank` of `world` over `backend` ("nccl"
    or "gloo") with `device` as this rank's device; -> the device."""
    dev = torch.device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device per rank, got {dev}")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            **kw)
    return dev


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(num_devices: Optional[int] = None, model_parallel: int = 1,
              devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """("data", "model") mesh of `num_devices` ranks (default: every rank of
    the process group, or of `devices`, the global ranks in mesh order);
    model_parallel=1 gives pure data parallelism."""
    n = num_devices or (len(devices) if devices is not None else dist.get_world_size())
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    if n > len(ranks):
        raise ValueError(f"a mesh of {n} devices from {len(ranks)} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type,
                      torch.tensor(ranks[:n]).reshape(n // model_parallel, model_parallel),
                      mesh_dim_names=("data", "model"))


def data_group(mesh: DeviceMesh) -> collectives.DataGroup:
    """The mesh's "data" axis as seen from this rank."""
    return collectives.DataGroup(mesh.get_group("data"), mesh.get_local_rank("data"),
                                 mesh.mesh.shape[0])


def shard_batch(batch: dict, mesh: DeviceMesh) -> dict:
    """This rank's contiguous rows [r*B/n, (r+1)*B/n) of every entry of a
    global batch (numpy arrays, tensors or lists), as a P("data") sharding
    splits it."""
    g = data_group(mesh)
    out = {}
    for k, v in batch.items():
        if len(v) % g.size:
            raise ValueError(f"shard_batch: {k} has {len(v)} rows, not a multiple of the "
                             f"{g.size} data ranks")
        b = len(v) // g.size
        out[k] = v[g.rank * b:(g.rank + 1) * b]
    return out


def _broadcast(tensors: list[torch.Tensor], src: int, device: torch.device) -> None:
    """Broadcast `tensors` from rank `src` in place: one flat broadcast per
    dtype, staged on `device` (NCCL takes only CUDA tensors)."""
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault(t.dtype, []).append(t)
    for ts in buckets.values():
        flat = torch._utils._flatten_dense_tensors([t.detach().to(device) for t in ts])
        dist.broadcast(flat, src)
        with torch.no_grad():
            for t, r in zip(ts, torch._utils._unflatten_dense_tensors(flat, ts)):
                t.copy_(r)


def replicate_state(state: TrainState, mesh: DeviceMesh) -> TrainState:
    """Every rank takes the mesh's first rank's state, in place: parameters
    and buffers, optimiser state, EMA, log-variance, the counters and the
    dropout generator's state.  The optimiser state must have the same
    entries on every rank (it is checked).  Training over a "model" axis is
    not implemented: a mesh with one, or a model whose weights
    `shard_params` sliced, is refused (the first rank's slices would
    overwrite every other rank's)."""
    if _axis_size(mesh, "model") > 1 or any(isinstance(m, _GatheredShard)
                                             for m in state.model.modules()):
        raise NotImplementedError(
            'replicate_state: training over a "model" axis (shard_params) is not '
            "implemented; train data-parallel only (model_parallel=1)")
    src = int(mesh.mesh.flatten()[0])
    dev = state.log_var.device
    opt = state.optimizer
    params = [p for grp in opt.param_groups for p in grp["params"]]
    opt_entries = [(i, k, v) for i, p in enumerate(params)
                   for k, v in sorted(opt.state.get(p, {}).items()) if torch.is_tensor(v)]
    layout = [(i, k, tuple(v.shape), str(v.dtype)) for i, k, v in opt_entries]
    gen = _generator(state.model)
    meta = [layout, state.ema_updates, state.step, None if gen is None else gen.get_state()]
    dist.broadcast_object_list(meta, src)
    if meta[0] != layout:
        raise ValueError("replicate_state: the optimiser state differs between the ranks")
    _broadcast([*state.model.state_dict().values(), *(v for _, _, v in opt_entries),
                state.log_var, *state.ema.values()], src, dev)
    state.ema_updates, state.step = meta[1], meta[2]
    if gen is not None:
        gen.set_state(meta[3].cpu())
    return state


def _in_group(fn: Callable, mesh: DeviceMesh) -> Callable:
    group = data_group(mesh)

    def run(*args: Any, **kwargs: Any):
        with collectives.data_group(group):
            return fn(*args, **kwargs)

    return run


def build_parallel_train_step(train_step: Callable, mesh: DeviceMesh) -> Callable:
    """train_step(state, rows) -> (state, metrics) on this rank's rows of the
    global batch (`shard_batch`), with the batch reductions and the gradient
    sum over the mesh's "data" axis; the state must be replicated
    (`replicate_state`) and stays so; the metrics are the global batch's."""
    return _in_group(train_step, mesh)


def build_parallel_eval_step(eval_step: Callable, mesh: DeviceMesh) -> Callable:
    """eval_step(state, rows, ...) -> the global batch's val metrics."""
    return _in_group(eval_step, mesh)
