"""YOLOX detection loss with SimOTA assignment (counterpart of
`asy_vrnet_tpu/ops/losses_det.py`; reference nets/yolo_training.py:60-207).

Fixed shapes: GT boxes come padded to (B, G, 4) with a validity mask and the
loss terms are masked sums.  Weights and normalisation match get_losses
(yolo_training.py:190-207):

    loss = (1*sum iou_loss(fg) + 2*sum bce(obj, fg_target) + 2*sum bce(cls, fg))
           / max(total_num_fg, 1)

with iou_loss = 1 - iou^2 and cls targets soft-weighted by the matched IoU.
The JAX package looks the matched GT up with one-hot matrix products (a TPU
gather workaround); here it is a plain gather, which gives the same values.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from asy_vrnet_tpu_torch.ops.boxes import decode_for_loss, iou_loss_squared
from asy_vrnet_tpu_torch.ops.simota_fused import simota_assign_batched
from asy_vrnet_tpu_torch.parallel import collectives


class DetLossAux(NamedTuple):
    loss_iou: torch.Tensor
    loss_obj: torch.Tensor
    loss_cls: torch.Tensor
    num_fg: torch.Tensor


def _bce_with_logits(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return x.clamp_min(0.0) - x * t + torch.log1p(torch.exp(-x.abs()))


def yolox_loss(
    det_outputs: Sequence[torch.Tensor],  # 3x NHWC (B,h,w,5+C), raw head maps
    gt_boxes: torch.Tensor,               # (B, G, 4) cxcywh absolute pixels
    gt_classes: torch.Tensor,             # (B, G) int
    gt_valid: torch.Tensor,               # (B, G) bool
    strides: Sequence[int] = (8, 16, 32),
    num_classes: int | None = None,
    center_radius: float = 2.5,
    candidate_k: int = 10,
    iou_weight: float = 1.0,
    obj_weight: float = 2.0,
    cls_weight: float = 2.0,
) -> tuple[torch.Tensor, DetLossAux]:
    outputs, grids, svec = decode_for_loss(det_outputs, strides)
    outputs = outputs.float()
    c = outputs.shape[-1] - 5 if num_classes is None else num_classes

    bbox_preds = outputs[..., :4]          # (B, A, 4)
    obj_logits = outputs[..., 4]           # (B, A)
    cls_logits = outputs[..., 5:]          # (B, A, C)

    # no gradient flows through the assignment (the kernel on the card, its
    # plain twin on the CPU)
    assign = simota_assign_batched(
        bbox_preds, cls_logits, obj_logits, gt_boxes, gt_classes, gt_valid,
        grids, svec, center_radius=center_radius, candidate_k=candidate_k)

    fg = assign.fg_mask.float()                                   # (B, A)
    # in a parallel step the normaliser and the three sums are the global
    # batch's, and every rank computes the same loss from them
    total_fg = collectives.all_reduce_(assign.num_fg.sum())
    num_fg = total_fg.clamp_min(1.0)
    matched = assign.matched_gt                                   # (B, A) int64

    # regression: IoU^2 loss on positives against their matched GT box
    matched_boxes = gt_boxes.float().gather(1, matched[..., None].expand(-1, -1, 4))
    loss_iou = (iou_loss_squared(bbox_preds, matched_boxes) * fg).sum()

    # objectness: BCE over all anchors, target = fg mask
    loss_obj = _bce_with_logits(obj_logits, fg).sum()

    # classification: BCE on positives, soft target = one_hot * matched IoU
    matched_cls = gt_classes.long().gather(1, matched)            # (B, A)
    in_range = ((matched_cls >= 0) & (matched_cls < c))[..., None]
    cls_target = (F.one_hot(matched_cls.clamp(0, c - 1), c).float() * in_range
                  * assign.pred_iou[..., None])
    loss_cls = (_bce_with_logits(cls_logits, cls_target).sum(dim=-1) * fg).sum()
    loss_iou, loss_obj, loss_cls = collectives.global_sums(loss_iou, loss_obj, loss_cls)

    total = (iou_weight * loss_iou + obj_weight * loss_obj + cls_weight * loss_cls) / num_fg
    return total, DetLossAux(loss_iou / num_fg, loss_obj / num_fg, loss_cls / num_fg,
                             total_fg)


def pad_gt_boxes(boxes_list: Sequence, max_boxes: int, device=None):
    """Host-side helper: ragged per-image [N_i, 5] (cxcywh + class) arrays ->
    padded (B,G,4) f32, (B,G) int32, (B,G) bool tensors on `device`."""
    b = len(boxes_list)
    gb = np.zeros((b, max_boxes, 4), np.float32)
    gc = np.zeros((b, max_boxes), np.int32)
    gv = np.zeros((b, max_boxes), bool)
    for i, arr in enumerate(boxes_list):
        arr = np.asarray(arr, np.float32).reshape(-1, 5)
        n = min(len(arr), max_boxes)
        gb[i, :n] = arr[:n, :4]
        gc[i, :n] = arr[:n, 4].astype(np.int32)
        gv[i, :n] = True
    return tuple(torch.as_tensor(x, device=device) for x in (gb, gc, gv))
