"""Checkpoints: the full train state (torch.save), the weights-only npz export
and the partial, shape-checked load (the port's counterpart of
`asy_vrnet_tpu/train/checkpoint.py`).

The reference saves weights-only state_dicts (utils/utils_fit.py:213-226) and
resumes by key and shape (train.py:309-326).  The JAX package keeps its full
state in an orbax checkpoint, which the port cannot read without JAX; the
port's full state is its own `<ckpt_dir>/step_<N>.pt` (N is the epoch, as the
JAX package names its directories): model weights and BN stats, optimiser
state, log-var, EMA and its counter, step, epoch and the state of the
dropout generator where the model has one.  The weights-only npz is JAX's
flat 'params/...', 'batch_stats/...' layout and crosses in both directions.
"""
from __future__ import annotations

import os
from typing import Any, Mapping, Optional

import numpy as np
import torch

from asy_vrnet_tpu_torch.models.layers import Dropout
from asy_vrnet_tpu_torch.train.state import TrainState
from asy_vrnet_tpu_torch.utils.weights import flax_from_port, npz_tree


def _generator(model: torch.nn.Module) -> Optional[torch.Generator]:
    """The explicit generator the model's dropout draws from, or None."""
    for m in model.modules():
        if isinstance(m, Dropout) and m.generator is not None:
            return m.generator
    return None


def save_checkpoint(ckpt_dir: str, state: TrainState, epoch: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{int(epoch)}.pt"))
    gen = _generator(state.model)
    torch.save({
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "log_var": state.log_var.detach(),
        "ema": state.ema,
        "ema_updates": float(state.ema_updates),
        "step": int(state.step),
        "epoch": int(epoch),
        "generator": None if gen is None else gen.get_state(),
    }, path)
    return path


def restore_checkpoint(path: str, state: TrainState) -> int:
    """Load a `save_checkpoint` file into `state`, in place, onto the
    state's device.  -> the epoch it was saved after."""
    dev = state.log_var.device
    ck = torch.load(path, map_location=dev, weights_only=True)
    state.model.load_state_dict(ck["model"], strict=True)
    state.optimizer.load_state_dict(ck["optimizer"])
    with torch.no_grad():
        state.log_var.copy_(ck["log_var"])
        if set(ck["ema"]) != set(state.ema):
            raise ValueError(f"{path}: its EMA entries differ from the model's")
        for k, v in state.ema.items():
            v.copy_(ck["ema"][k])
    state.ema_updates = float(ck["ema_updates"])
    state.step = int(ck["step"])
    gen = _generator(state.model)
    if ck["generator"] is not None:
        if gen is None:
            raise ValueError(f"{path} holds a dropout generator's state; the model has none")
        gen.set_state(ck["generator"].cpu())
    return int(ck["epoch"])


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        stem, ext = os.path.splitext(name)
        if ext == ".pt" and stem.startswith("step_") and stem[5:].isdigit():
            steps.append(int(stem[5:]))
    if not steps:
        return None
    return os.path.join(ckpt_dir, f"step_{max(steps)}.pt")


def save_weights(path: str, variables: Mapping[str, torch.Tensor]) -> None:
    """Weights-only npz (flat {'params/...': arr, 'batch_stats/...': arr},
    the JAX package's layout) from port tensors by state_dict key: a
    `state_dict()` or `eval_variables`."""
    flat = {}
    for collection, tree in flax_from_port(variables).items():
        stack = [((collection,), tree)]
        while stack:
            prefix, node = stack.pop()
            for k, v in node.items():
                if isinstance(v, dict):
                    stack.append((prefix + (k,), v))
                else:
                    flat["/".join(prefix + (k,))] = v
    np.savez(path, **flat)


def load_weights(path: str) -> dict:
    """-> nested {'params': ..., 'batch_stats': ...} trees of numpy arrays."""
    return npz_tree(path)


def partial_load(target_params: Any, source: Any, verbose: bool = True):
    """Load leaves from `source` into `target_params` (nested dicts of
    arrays) when the path exists and the shape matches; keep the target leaf
    otherwise (train.py:309-326).  -> (tree, loaded paths, kept paths)."""
    loaded, skipped = [], []

    def walk(tgt, src, path=""):
        if isinstance(tgt, dict):
            out = {}
            for k, v in tgt.items():
                sub = src.get(k) if isinstance(src, dict) else None
                out[k] = walk(v, sub, f"{path}/{k}")
            return out
        if src is not None and np.shape(src) == np.shape(tgt):
            loaded.append(path)
            return np.asarray(src, dtype=np.asarray(tgt).dtype)
        skipped.append(path)
        return tgt

    result = walk(target_params, source or {})
    if verbose:
        print(f"partial_load: {len(loaded)} loaded, {len(skipped)} kept")
    return result, loaded, skipped
