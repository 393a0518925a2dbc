"""flax variables -> port state_dict bridge, and the weights-only npz loader.

The port's `nn.Module` tree uses the reference's torch state_dict keys, so a
flax leaf path maps to a port key with the same rules as the JAX package's
torch -> flax converter (`asy_vrnet_tpu/utils/weights.py:27-128`; this module
keeps its own copy of that mapping).  `state_dict_from_flax` inverts the
JAX package's leaf transforms:

  conv kernel   (kh,kw,I,O) -> (O,I,kh,kw)     [incl. depthwise (k,k,1,C)]
  ShuffleAttn   cweight/cbias/sweight/sbias (C,) -> (1,C,1,1)
  Cluster       sim_alpha/sim_beta () -> (1,)
  BN            scale/bias & mean/var -> weight/bias & running_mean/var
                (+ a zero `num_batches_tracked`, which flax does not keep)

`train_state_from_flax` carries a whole JAX train state across (weights, BN
stats, optimiser momentum, log-var, EMA, counters) and `flax_from_train_state`
goes back for weights, BN stats and EMA.  The JAX optimiser keeps each
accumulator as ONE flat vector in `ravel_pytree` leaf order (dict keys
sorted, depth first); `split_flat` cuts it by that order and maps each piece
like the weight it belongs to.
"""
from __future__ import annotations

import re
from typing import Any, Iterator, Mapping

import numpy as np
import torch


def _torch_module_prefix(parts: list[str]) -> list[str]:
    """flax module path -> reference torch module path components."""
    out: list[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p in ("neck", "backbone"):
            out.append("backbone")
        elif m := re.fullmatch(r"stage(\d)_radar", p):
            s = int(m.group(1))
            out.append(f"network_radar.{3 * s if s < 3 else 9}")
        elif m := re.fullmatch(r"stage(\d)", p):
            s = int(m.group(1))
            out.append(f"network.{3 * s if s < 3 else 9}")
        elif m := re.fullmatch(r"block(\d+)", p):
            out.append(m.group(1))
        elif m := re.fullmatch(r"fusion(\d)_image", p):
            out.append(f"network.{3 * int(m.group(1)) + 1}")
        elif m := re.fullmatch(r"fusion(\d)_radar", p):
            out.append(f"network_radar.{3 * int(m.group(1)) + 1}")
        elif m := re.fullmatch(r"reducer(\d)_radar", p):
            out.append(f"network_radar.{3 * int(m.group(1)) + 2}")
        elif m := re.fullmatch(r"reducer(\d)", p):
            out.append(f"network.{3 * int(m.group(1)) + 2}")
        elif m := re.fullmatch(r"branch(\d)_conv", p):
            out.append("branch5_conv" if m.group(1) == "5" else f"branch{m.group(1)}.0")
        elif m := re.fullmatch(r"branch(\d)_bn", p):
            out.append("branch5_bn" if m.group(1) == "5" else f"branch{m.group(1)}.1")
        elif p == "conv_cat_conv":
            out.append("conv_cat.0")
        elif p == "conv_cat_bn":
            out.append("conv_cat.1")
        elif p in ("upsample5_4", "upsample4_3", "upsample3_2", "upsample2_0",
                   "p5_4_det", "p4_3_det") and i + 1 < len(parts) and parts[i + 1] == "conv":
            out.append(f"{p}.upsample.0")
            i += 1  # the BaseConv inside the reference's Sequential
        elif m := re.fullmatch(r"stem(\d)", p):
            out.append(f"stems.{m.group(1)}")
        elif m := re.fullmatch(r"cls_conv(\d)_(\d)", p):
            out.append(f"cls_convs.{m.group(1)}.{m.group(2)}")
        elif m := re.fullmatch(r"reg_conv(\d)_(\d)", p):
            out.append(f"reg_convs.{m.group(1)}.{m.group(2)}")
        elif m := re.fullmatch(r"cls_pred(\d)", p):
            out.append(f"cls_preds.{m.group(1)}")
        elif m := re.fullmatch(r"reg_pred(\d)", p):
            out.append(f"reg_preds.{m.group(1)}")
        elif m := re.fullmatch(r"obj_pred(\d)", p):
            out.append(f"obj_preds.{m.group(1)}")
        elif p in ("dconv", "pconv"):
            # the ds ConvBnAct nests dconv/pconv under .conv (reference DWConv)
            out.append(f"conv.{p}")
        else:
            out.append(p)
        i += 1
    return out


_LEAF_MAP = {
    ("bn", "scale"): "weight",
    ("bn", "bias"): "bias",
    ("bn", "mean"): "running_mean",
    ("bn", "var"): "running_var",
    ("gn", "scale"): "weight",
    ("gn", "bias"): "bias",
}

# ShuffleAttention gate params: (C,) in flax, (1,C,1,1) in torch
_SA_LEAVES = ("cweight", "cbias", "sweight", "sbias")


def torch_key_for(path: tuple[str, ...]) -> str:
    """flax leaf path (without the 'params'/'batch_stats' root) -> port key."""
    parts = list(path)
    leaf = parts.pop()
    tail = parts[-1] if parts else ""
    parent = parts[-2] if len(parts) >= 2 else ""
    # the 'bn'/'gn' wrapper levels of standalone BatchNorm2d / GroupNorm1
    # vanish in torch; the 'bn' inside ConvBnAct is kept
    if tail in ("bn", "gn") and (parent.startswith("norm") or parent.endswith("_bn")):
        return ".".join(_torch_module_prefix(parts[:-1])) + "." + _LEAF_MAP[(tail, leaf)]
    prefix = ".".join(_torch_module_prefix(parts))
    if (tail, leaf) in _LEAF_MAP:
        return prefix + "." + _LEAF_MAP[(tail, leaf)]
    if leaf == "kernel":
        return prefix + ".weight"
    if leaf == "conv_w":  # ECA
        return prefix + ".conv.weight"
    if leaf in ("gn_scale", "gn_bias"):  # ShuffleAttention's own GroupNorm
        return prefix + ".gn." + ("weight" if leaf == "gn_scale" else "bias")
    return prefix + "." + leaf


def _to_torch_leaf(leaf_name: str, value: np.ndarray) -> np.ndarray:
    value = np.array(value, np.float32)
    if leaf_name == "kernel" and value.ndim == 4:
        return np.ascontiguousarray(np.transpose(value, (3, 2, 0, 1)))
    if leaf_name in _SA_LEAVES:
        return value.reshape(1, -1, 1, 1)
    if leaf_name in ("sim_alpha", "sim_beta"):
        return value.reshape(1)
    return value


def _walk(tree: Mapping[str, Any], path=()) -> Iterator[tuple[tuple[str, ...], Any]]:
    """Leaves depth first with sorted keys: JAX's pytree leaf order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def state_dict_from_flax(params: Mapping[str, Any],
                         batch_stats: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Nested flax dicts of arrays -> port state_dict (f32 CPU tensors)."""
    sd: dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for path, leaf in _walk(tree):
            key = torch_key_for(path)
            if key in sd:
                raise ValueError(f"two flax leaves map to {key}")
            sd[key] = torch.from_numpy(_to_torch_leaf(path[-1], np.asarray(leaf)))
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def load_npz(path: str) -> tuple[dict, dict]:
    """Weights-only npz (flat 'params/...', 'batch_stats/...' keys, as the
    JAX package's `train/checkpoint.py::save_weights` writes) ->
    (params, batch_stats) nested dicts of numpy arrays."""
    out: dict = {"params": {}, "batch_stats": {}}
    with np.load(path) as flat:
        for key in flat.files:
            parts = key.split("/")
            node = out.setdefault(parts[0], {})
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[key]
    return out["params"], out["batch_stats"]


def load_npz_into(model: torch.nn.Module, path: str) -> None:
    """Strictly load a weights-only npz into a port model."""
    model.load_state_dict(state_dict_from_flax(*load_npz(path)), strict=True)


def _shape(leaf) -> tuple[int, ...]:
    """Shape of an array or of anything that only describes one."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def split_flat(vec: np.ndarray, params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """One flat per-parameter vector in the JAX leaf order of `params` ->
    {port key: tensor shaped and laid out like that port parameter}."""
    vec = np.asarray(vec)
    out: dict[str, torch.Tensor] = {}
    offset = 0
    for path, leaf in _walk(params):
        shape = _shape(leaf)
        n = int(np.prod(shape, dtype=np.int64))
        piece = vec[offset:offset + n].reshape(shape)
        out[torch_key_for(path)] = torch.from_numpy(_to_torch_leaf(path[-1], piece))
        offset += n
    if offset != vec.size:
        raise ValueError(f"flat vector has {vec.size} entries, the parameters {offset}")
    return out


def _from_torch_leaf(leaf_name: str, value: torch.Tensor, shape) -> np.ndarray:
    """Inverse of `_to_torch_leaf`, into the flax leaf's `shape`."""
    value = value.detach().cpu().numpy().astype(np.float32)
    if leaf_name == "kernel" and value.ndim == 4:
        value = np.transpose(value, (2, 3, 1, 0))
    return np.array(value.reshape(shape), order="C")   # keeps 0-d leaves 0-d


def flax_from_state_dict(sd: Mapping[str, torch.Tensor], like: Mapping[str, Any]) -> dict:
    """Port tensors by state_dict key -> a nested flax dict with the structure
    and leaf shapes of `like`: a tree of arrays (the `params` of `load_npz`)
    or of shape descriptions (anything with `.shape`)."""
    out: dict = {}
    for path, leaf in _walk(like):
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _from_torch_leaf(path[-1], sd[torch_key_for(path)], _shape(leaf))
    return out


def train_state_from_flax(state, params, batch_stats, opt_state_flat: Mapping[str, Any],
                          log_var, ema_params, ema_batch_stats, ema_updates, step) -> None:
    """Load a JAX train state (numpy arrays) into the port's `TrainState`, in
    place.  `opt_state_flat` holds the optimiser's flat accumulators:
    {"trace": v} for SGD, {"mu": m, "nu": v, "count": n} for Adam."""
    model, opt = state.model, state.optimizer
    dev = next(model.parameters()).device
    model.load_state_dict(state_dict_from_flax(params, batch_stats), strict=True)
    ema = state_dict_from_flax(ema_params, ema_batch_stats)
    with torch.no_grad():
        for k, v in state.ema.items():
            v.copy_(ema[k])
        state.log_var.copy_(torch.from_numpy(np.array(log_var, np.float32)))
    state.ema_updates = float(ema_updates)
    state.step = int(step)

    named = dict(model.named_parameters())
    if isinstance(opt, torch.optim.SGD):
        fields = {"momentum_buffer": "trace"}
    elif isinstance(opt, torch.optim.Adam):
        fields = {"exp_avg": "mu", "exp_avg_sq": "nu"}
    else:
        raise TypeError(f"no bridge for optimiser {type(opt).__name__}")
    for port_field, flax_field in fields.items():
        for key, piece in split_flat(opt_state_flat[flax_field], params).items():
            opt.state[named[key]][port_field] = piece.to(dev)
    if isinstance(opt, torch.optim.Adam):
        for p in named.values():
            opt.state[p]["step"] = torch.tensor(float(opt_state_flat["count"]))


def flax_from_train_state(state, like_params, like_batch_stats) -> dict:
    """The port's weights, BN stats and their EMA as nested flax dicts
    (structure taken from `like_params` / `like_batch_stats`)."""
    live = state.model.state_dict()
    return {"params": flax_from_state_dict(live, like_params),
            "batch_stats": flax_from_state_dict(live, like_batch_stats),
            "ema_params": flax_from_state_dict(state.ema, like_params),
            "ema_batch_stats": flax_from_state_dict(state.ema, like_batch_stats)}
