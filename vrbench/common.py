"""What the traffic drivers share: seeded generators, the seeded weights
with BatchNorm statistics calibrated on the cell's own inputs, the program's
configuration objects, and the arithmetic of the comparisons."""
from __future__ import annotations

import contextlib
import hashlib
import statistics

import torch

from vrbench.reference.model import EfficientVRNet
from vrbench.weights import make_weights

VAR_FLOOR = 0.05


@contextlib.contextmanager
def no_tf32():
    """f32 products in f32: the reference's matmuls and convolutions."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator on `device` for one named stream of draws of the seed."""
    h = hashlib.sha256(f"{seed}/{stream}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(h[:8], "little") >> 1)
    return g


@torch.no_grad()
def seeded_weights(model_cfg: dict, seed: int, device, image, radar) -> dict:
    """`make_weights`, then each BatchNorm's running stats set to the batch
    statistics of one train-mode forward of the reference over
    (image, radar), the variance floored at `VAR_FLOOR`: an eval-mode
    forward then sees activations of the scale a trained model's would have,
    and no channel that was near constant on the few calibration rows (a
    pooled branch, an empty stretch of a radar map) is amplified a
    hundredfold."""
    sd = make_weights(model_cfg, seed, device)
    ref = EfficientVRNet(model_cfg).to(device)
    ref.load_state_dict(sd)
    bns = [m for m in ref.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    ref.train()
    with no_tf32():
        ref(image, radar)
    for m in bns:
        m.running_var.clamp_(min=VAR_FLOOR)
    out = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    del ref
    return out


def program_config(cfg: dict):
    """The port's `Config` for a configuration file."""
    from asy_vrnet_tpu_torch.config import Config

    return Config.from_dict({k: cfg[k] for k in ("model", "loss", "optim")})


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """{leaf: |‖prog‖ - ‖ref‖| / max(‖ref‖, the median leaf's ‖ref‖)}: the
    gap of each leaf's norm against the reference's."""
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}



def norms(tensors: dict) -> dict:
    """{key: f64 norm}, read back in one copy."""
    keys = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[k].double()) for k in keys])
    return dict(zip(keys, vals.tolist()))


def model_flops(model_cfg: dict) -> float:
    """FLOPs of the reference forward for one image at the configuration's
    input size, as `FlopCounterMode` counts them (convolutions and matrix
    products), on the meta device: the same count whatever implements the
    work."""
    from torch.utils.flop_counter import FlopCounterMode

    h, w = model_cfg["input_size"]
    with torch.device("meta"):
        model = EfficientVRNet(model_cfg)
        with FlopCounterMode(display=False) as counter:
            model(torch.empty(1, h, w, 3), torch.empty(1, h, w, 4))
    return float(counter.get_total_flops())
