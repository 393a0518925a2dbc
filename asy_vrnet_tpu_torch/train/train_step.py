"""The train and eval steps (counterpart of
`asy_vrnet_tpu/train/train_step.py`; reference utils/utils_fit.py:34-196).

One step: forward in train mode (both tasks), seg loss + f_score, SimOTA +
YOLOX loss, multitask combine, backward, optimiser update, ramped EMA.
Parameters are f32 and are cast at each call, so gradients arrive in f32 and
bf16 compute needs no autocast and no GradScaler.  Losses run in f32, except
that the fused seg loss reads the model's logits as bf16.  The step updates the
state in place and returns it.

Batch layout (numpy arrays or tensors, fixed shapes):
  image       (B, H, W, 3)  float32 ImageNet-normalised, or uint8
  radar       (B, H, W, 4)  float32, raw
  gt_boxes    (B, G, 4)     cxcywh absolute pixels
  gt_classes  (B, G)        int32
  gt_valid    (B, G)        bool
  seg_target  (B, H, W)     int32 with ignore == num_seg_classes
  seg_onehot  (B, H, W, S+1) float32, optional (trailing ignore channel)
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from asy_vrnet_tpu_torch.config import Config
from asy_vrnet_tpu_torch.data.preprocess import maybe_normalize_image_device
from asy_vrnet_tpu_torch.ops.losses_det import yolox_loss
from asy_vrnet_tpu_torch.ops.losses_seg import ce_loss, dice_loss, f_score, focal_loss
from asy_vrnet_tpu_torch.ops.losses_seg_fused import fused_seg_loss_and_fscore
from asy_vrnet_tpu_torch.train.optim import get_learning_rate
from asy_vrnet_tpu_torch.train.state import TrainState, apply_ema, eval_variables
from asy_vrnet_tpu_torch.utils.device import resolve_device, same_device

# the VRCoC backbone, which `freeze_backbone` freezes (train.py:439-440)
FROZEN_PREFIX = "backbone.backbone."


def seg_onehot_of(batch: dict, num_seg_classes: int) -> torch.Tensor:
    """(B,H,W,S+1) one-hot seg target with the trailing ignore channel, from
    the int map unless the batch carries a precomputed `seg_onehot`."""
    if "seg_onehot" in batch:
        return batch["seg_onehot"]
    return F.one_hot(batch["seg_target"].long(), num_seg_classes + 1).float()


def _cls_weights(cfg: Config, device) -> torch.Tensor | None:
    w = cfg.loss.cls_balance_weights
    return None if w is None else torch.tensor(w, dtype=torch.float32, device=device)


def segmentation_loss(cfg: Config, seg_logits, seg_target, seg_onehot):
    lcfg = cfg.loss
    weights = _cls_weights(cfg, seg_logits.device)
    n = cfg.model.num_seg_classes
    if lcfg.focal_loss:
        loss = focal_loss(seg_logits, seg_target, weights, n, lcfg.focal_alpha,
                          lcfg.focal_gamma)
    else:
        loss = ce_loss(seg_logits, seg_target, weights, n)
    if lcfg.dice_loss:
        loss = loss + dice_loss(seg_logits, seg_onehot)
    return loss


def seg_loss_and_fscore(cfg: Config, seg_logits, batch):
    """(loss_seg, f_score).  `LossConfig.use_pallas_seg` (the name is shared
    with the JAX package's configs) means here "use the fused seg-loss
    kernel": None = on CUDA tensors only, True/False force.  Under a bf16
    compute dtype the fused path reads the model's f32 output as bf16 (the
    values the model computed before its f32 cast) and returns a gradient
    that holds bf16 values, with no cast of the logits either way."""
    lcfg = cfg.loss
    use_fused = lcfg.use_pallas_seg
    if use_fused is None:
        use_fused = seg_logits.device.type == "cuda"
    if not use_fused:
        onehot = seg_onehot_of(batch, cfg.model.num_seg_classes)
        loss = segmentation_loss(cfg, seg_logits, batch["seg_target"], onehot)
        return loss, f_score(seg_logits, onehot)
    return fused_seg_loss_and_fscore(
        seg_logits, batch["seg_target"], _cls_weights(cfg, seg_logits.device),
        cfg.model.num_seg_classes, use_focal=lcfg.focal_loss,
        focal_alpha=lcfg.focal_alpha, focal_gamma=lcfg.focal_gamma,
        use_dice=lcfg.dice_loss, use_kernel=True,
        round_bf16=cfg.model.compute_dtype == "bfloat16")


def detection_loss(cfg: Config, det_outputs, batch):
    lcfg = cfg.loss
    return yolox_loss(
        det_outputs, batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"],
        strides=cfg.model.head_strides, num_classes=cfg.model.num_classes,
        center_radius=lcfg.center_radius, candidate_k=lcfg.simota_candidate_k,
        iou_weight=lcfg.iou_weight, obj_weight=lcfg.obj_weight,
        cls_weight=lcfg.cls_weight)


def combine_losses(cfg: Config, loss_det, loss_seg, log_var):
    """Multitask combine: the reference's fixed det + w*seg
    (utils/utils_fit.py:106) or Kendall uncertainty weighting with a
    persistent log-variance (utils/multitaskloss.py:12-18)."""
    if cfg.loss.multitask_mode == "uncertainty":
        return loss_det + torch.exp(-log_var) * loss_seg + log_var
    return loss_det + cfg.loss.seg_weight * loss_seg


def _batch_on(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def _check_state_device(state: TrainState, device: torch.device) -> None:
    have = next(state.model.parameters()).device
    if not same_device(have, device):
        raise ValueError(f"the train state lies on {have}, the step was built for {device}")


def build_train_step(cfg: Config, freeze_backbone: bool = False,
                     device: str | torch.device | None = None
                     ) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Returns train_step(state, batch) -> (state, metrics) on `device`
    (default: the card; raises without one).  Metrics are 0-d tensors on the
    device (reading one waits for the step).

    freeze_backbone: the VRCoC backbone's parameters get no gradient, no
    update (weight decay included) and their optimiser state stays as it
    was; its BatchNorm running stats still move, since the model still runs
    in train mode."""
    dev = resolve_device(device)
    uncertainty = cfg.loss.multitask_mode == "uncertainty"

    def train_step(state: TrainState, batch: dict):
        _check_state_device(state, dev)
        model, optimizer = state.model, state.optimizer
        batch = _batch_on(batch, dev)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        state.log_var.grad = None

        det, seg = model(maybe_normalize_image_device(batch["image"]), batch["radar"])
        loss_seg, fsc = seg_loss_and_fscore(cfg, seg, batch)
        loss_det, aux = detection_loss(cfg, det, batch)
        total = combine_losses(cfg, loss_det, loss_seg, state.log_var)
        total.backward()

        if freeze_backbone:
            # a parameter without a gradient is skipped by the optimiser:
            # no update, no weight decay, momentum left as it was
            for name, p in model.named_parameters():
                if name.startswith(FROZEN_PREFIX):
                    p.grad = None
        optimizer.step()
        if uncertainty:
            # plain SGD on the scalar log-var at the current learning rate
            with torch.no_grad():
                state.log_var -= get_learning_rate(optimizer) * state.log_var.grad
        state.step += 1
        if cfg.optim.ema:
            apply_ema(state, cfg.optim.ema_decay, cfg.optim.ema_tau)
        metrics = {"loss": total, "loss_det": loss_det, "loss_seg": loss_seg,
                   "num_fg": aux.num_fg, "f_score": fsc}
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def build_eval_step(cfg: Config, device: str | torch.device | None = None
                    ) -> Callable[..., dict]:
    """Returns eval_step(state, batch, use_ema=True) -> metrics (val losses +
    f_score) with running BN stats and, by default, the EMA weights
    (utils/utils_fit.py:144-196).  Nothing in the state changes."""
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict, use_ema: bool = True):
        _check_state_device(state, dev)
        model = state.model
        batch = _batch_on(batch, dev)
        was_training = model.training
        model.eval()
        try:
            det, seg = torch.func.functional_call(
                model, eval_variables(state, use_ema),
                (maybe_normalize_image_device(batch["image"]), batch["radar"]))
        finally:
            model.train(was_training)
        loss_seg, fsc = seg_loss_and_fscore(cfg, seg, batch)
        loss_det, aux = detection_loss(cfg, det, batch)
        return {"loss_det": loss_det, "loss_seg": loss_seg, "loss": loss_det + loss_seg,
                "f_score": fsc, "num_fg": aux.num_fg}

    return eval_step
