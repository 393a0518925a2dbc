"""Segmentation-only train step (the port's counterpart of
`asy_vrnet_tpu/train/seg_only.py`; utils_seg/utils_fit.py:13, the seg-only fit
variant the reference ships beside the joint path).

Trains the whole EfficientVRNet with only the segmentation head supervised:
the detection branch runs but gets no gradient.  Radar is optional (zeros
when the batch has none, a camera-only ablation).  The loss is the joint
step's `seg_loss_and_fscore`: on the card the fused seg-loss kernels (K4
forward, K4b backward), on the CPU their plain twins or the unfused losses.
"""
from __future__ import annotations

from typing import Callable

import torch

from asy_vrnet_tpu_torch.config import Config
from asy_vrnet_tpu_torch.data.preprocess import maybe_normalize_image_device
from asy_vrnet_tpu_torch.train.state import TrainState, apply_ema
from asy_vrnet_tpu_torch.train.train_step import (
    _batch_on,
    _check_state_device,
    seg_loss_and_fscore,
)
from asy_vrnet_tpu_torch.utils.device import resolve_device


def build_seg_train_step(cfg: Config, device: str | torch.device | None = None
                         ) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Returns train_step(state, batch) -> (state, metrics) on `device`
    (default: the card; raises without one); metrics are 0-d device tensors."""
    dev = resolve_device(device)
    radar_ch = cfg.model.radar_channels

    def train_step(state: TrainState, batch: dict):
        _check_state_device(state, dev)
        model, optimizer = state.model, state.optimizer
        batch = _batch_on(batch, dev)
        image = maybe_normalize_image_device(batch["image"])
        radar = batch.get("radar")
        if radar is None:
            b, h, w, _ = image.shape
            radar = torch.zeros((b, h, w, radar_ch), dtype=image.dtype, device=dev)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        _, seg = model(image, radar)
        loss, fsc = seg_loss_and_fscore(cfg, seg, batch)
        loss.backward()
        # the detection branch's gradient is zero, as jax.grad gives it: its
        # weights still take weight decay and the optimiser's state moves
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.step()
        state.step += 1
        if cfg.optim.ema:
            apply_ema(state, cfg.optim.ema_decay, cfg.optim.ema_tau)
        return state, {"loss": loss.detach(), "loss_seg": loss.detach(),
                       "f_score": fsc.detach()}

    return train_step
