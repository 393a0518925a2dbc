"""Reference-style weight re-initialisation (the port's counterpart of
`asy_vrnet_tpu/utils/init.py`; `weights_init`, nets/yolo_training.py:482-501,
wired at train.py:298): every conv weight gets normal / xavier / kaiming /
orthogonal init and every BatchNorm gets weight ~ N(1, 0.02), bias = 0;
everything else (GroupNorm, LayerScale, sim_alpha/beta, attention affines,
biases) keeps its value.

The draws are the JAX package's, bit for bit: one `np.random.default_rng(seed)`
walked in the flax leaf order (dict keys sorted, depth first), each conv
drawn in the flax shape (kh, kw, I, O) with flax fans, then laid out as the
port's (O, I, kh, kw).  The port's keys name their flax paths through
`utils/weights.py::flax_path_for`.
"""
from __future__ import annotations

import numpy as np
import torch

from asy_vrnet_tpu_torch.utils.weights import (
    _to_torch_leaf,
    flax_collection,
    flax_leaf,
    flax_path_for,
)

INIT_TYPES = ("none", "normal", "xavier", "kaiming", "orthogonal")


def _conv_init(rng: np.random.Generator, shape, init_type: str,
               gain: float) -> np.ndarray:
    if len(shape) == 4:           # (kh, kw, I, O)
        fan_in = shape[0] * shape[1] * shape[2]
        fan_out = shape[0] * shape[1] * shape[3]
        rows, cols = shape[3], shape[0] * shape[1] * shape[2]
    else:                         # ECA Conv1d weight (1, 1, k): fan = k
        fan_in = int(np.prod(shape[:-1])) * shape[-1] // shape[0]
        fan_out = fan_in
        rows, cols = shape[0], int(np.prod(shape[1:]))
    if init_type == "normal":
        return rng.normal(0.0, gain, shape)
    if init_type == "xavier":
        std = gain * np.sqrt(2.0 / (fan_in + fan_out))
        return rng.normal(0.0, std, shape)
    if init_type == "kaiming":    # a=0, mode='fan_in' -> std = sqrt(2/fan_in)
        return rng.normal(0.0, np.sqrt(2.0 / fan_in), shape)
    if init_type == "orthogonal":
        # torch orthogonalises the (O, I*kh*kw) flattening; build that matrix
        # and transpose back into the flax layout
        flat = rng.normal(0.0, 1.0, (max(rows, cols), min(rows, cols)))
        q, r = np.linalg.qr(flat)
        q = q * np.sign(np.diag(r))
        q = q.T if rows < cols else q
        w_t = gain * q.reshape((rows, cols))       # (O, I*kh*kw)
        if len(shape) == 4:
            w = w_t.reshape(shape[3], shape[2], shape[0], shape[1])
            return np.transpose(w, (2, 3, 1, 0))
        return w_t.reshape(shape)
    raise NotImplementedError(f"initialization method [{init_type}]")


@torch.no_grad()
def reinit_params(model: torch.nn.Module, seed: int, init_type: str = "normal",
                  init_gain: float = 0.02) -> None:
    """Re-initialise `model`'s conv weights and BatchNorm affines the
    reference way, in place."""
    if init_type in ("none", None):
        return
    if init_type not in INIT_TYPES:
        raise NotImplementedError(f"initialization method [{init_type}]")
    rng = np.random.default_rng(seed)
    sd = model.state_dict()
    leaves = sorted((flax_path_for(k), k) for k in sd
                    if not k.endswith("num_batches_tracked") and flax_collection(k) == "params")
    for path, key in leaves:
        name = path[-1]
        shape = flax_leaf(name, sd[key]).shape
        if (name == "kernel" and len(shape) == 4) or name == "conv_w":
            new = _conv_init(rng, shape, init_type, init_gain)
        elif len(path) >= 2 and path[-2] == "bn" and name == "scale":
            new = rng.normal(1.0, 0.02, shape)
        elif len(path) >= 2 and path[-2] == "bn" and name == "bias":
            new = np.zeros(shape)
        else:
            continue
        value = _to_torch_leaf(name, np.asarray(new, np.float32))
        sd[key].copy_(torch.from_numpy(value).reshape(sd[key].shape))
