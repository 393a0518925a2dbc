"""Seeded weights for both sides: one state_dict under the upstream repo's
key names, drawn on the run's device from `--seed` in one call.

Conv kernels are He-normal (std sqrt(2 / fan_in)), so activations keep their
scale through the ReLU stacks with BatchNorm in either mode.  Scales and
shifts that start at constants in the upstream init (LayerScale 1e-5, the
cluster similarity's alpha 1 and beta 0, the gates' 0 / 1) get a spread
around a value a trained model holds, so that every block and gate does
work that the comparison can see: LayerScale ~0.2, so the ClusterBlocks'
residual branches are not silent.  The head's prediction convs are drawn
at half the He scale; their biases put the boxes' sides at about 12 strides
(log-size bias 2.5) and the objectness logit 1 lower (bias -1), so that a
few per cent of the anchors pass the serving threshold, a frame keeps some
tens of detections (under `max_det`), and NMS suppresses a fifth to a
third of the candidates, as the overlapping boxes of a detector do.
"""
from __future__ import annotations

import torch

from vrbench.reference.model import EfficientVRNet


# bias means of the head's prediction convs: reg (x, y, log w, log h), obj
HEAD_BIAS = {"reg_preds": (0.0, 0.0, 2.5, 2.5), "obj_preds": (-1.0,)}


def _kind(key: str, shape: tuple) -> tuple[float, float]:
    """(mean, std) of the entry's normal draw."""
    leaf = key.rsplit(".", 1)[-1]
    if len(shape) >= 2 and leaf == "weight":
        fan_in = 1
        for s in shape[1:]:
            fan_in *= s
        # the head's prediction convs at half scale: logits ~N(0, 0.5), so
        # boxes span about a third to three strides and scores straddle
        # the serving threshold
        return 0.0, (0.5 if "_preds." in key else 1.0) * (2.0 / fan_in) ** 0.5
    if leaf.startswith("layer_scale"):
        return 0.2, 0.05
    if leaf in ("sim_alpha", "cbias", "sbias"):
        return 1.0, 0.1
    if leaf in ("sim_beta", "cweight", "sweight"):
        return 0.0, 0.1
    if leaf == "running_var":
        return 1.0, 0.0
    if leaf == "running_mean":
        return 0.0, 0.0
    if leaf == "weight":            # BatchNorm, GroupNorm scales
        return 1.0, 0.02
    return 0.0, 0.02                # biases


def make_weights(model_cfg: dict, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """{key: f32 tensor on `device`} for every float entry of the model's
    state_dict, and each `num_batches_tracked` as a 0 int64."""
    with torch.device("meta"):
        shapes = {k: (tuple(v.shape), v.dtype) for k, v in
                  EfficientVRNet(model_cfg).state_dict().items()}
    floats = [k for k, (_, dt) in shapes.items() if dt.is_floating_point]
    total = sum(torch.Size(shapes[k][0]).numel() for k in floats)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    draw = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for k, (shape, dt) in shapes.items():
        if not dt.is_floating_point:
            out[k] = torch.zeros(shape, dtype=dt, device=device)
            continue
        n = torch.Size(shape).numel()
        mean, std = _kind(k, shape)
        out[k] = (draw[at:at + n] * std + mean).view(shape)
        head = k.split(".")[-3] if k.endswith(".bias") and k.count(".") >= 2 else None
        if head in HEAD_BIAS:
            out[k] += torch.tensor(HEAD_BIAS[head], device=device)
        at += n
    return out
