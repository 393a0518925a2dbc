"""Greedy class-aware NMS with a fixed output shape (counterpart of
`asy_vrnet_tpu/ops/nms.py`), written by hand: no torchvision.

`max_out` rounds of select-and-suppress over all anchors: each round takes
the highest-score live anchor (lowest index on ties), emits it, and kills
every same-class anchor with IoU strictly above the threshold.  That is
greedy descending-score NMS, the first `max_out` boxes of torchvision's
result.  Rounds stop early once no image has a live anchor left; the output
keeps its (B, max_out) shape with invalid slots masked, so kept sets match
the JAX package's `nms_fixed` exactly.  `fixed_rounds=True` runs all
`max_out` rounds with no host read (for `torch.export` and graph capture):
once no image has a live anchor, a round writes index 0 and keep False and
leaves `live` as it was, so the result is the same.
"""
from __future__ import annotations

import torch


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
              valid: torch.Tensor, iou_threshold: float, max_out: int = 100,
              fixed_rounds: bool = False):
    """Batched greedy NMS.  boxes (B,A,4) xyxy, scores (B,A), classes (B,A)
    int, valid (B,A) bool.  Returns (indices (B,max_out) int64, keep (B,max_out)
    bool); invalid slots have index 0 and keep False.  `fixed_rounds`: no
    early exit (see the module docstring)."""
    bsz, a = scores.shape
    dev = scores.device
    neg_inf = torch.tensor(float("-inf"), device=dev)
    live = torch.where(valid, scores.float(), neg_inf)
    boxes = boxes.float()
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    arange_a = torch.arange(a, device=dev)[None]
    rows = torch.arange(bsz, device=dev)
    out_idx = torch.zeros((bsz, max_out), dtype=torch.int64, device=dev)
    out_keep = torch.zeros((bsz, max_out), dtype=torch.bool, device=dev)
    for r in range(max_out):
        i = torch.argmax(live, dim=1)                       # first max
        ok = live[rows, i] > neg_inf
        if not fixed_rounds and not bool(ok.any()):
            break
        b = boxes[rows, i]                                  # (B, 4)
        bx1, by1, bx2, by2 = (b[:, k:k + 1] for k in range(4))
        iw = (torch.minimum(x2, bx2) - torch.maximum(x1, bx1)).clamp_min(0.0)
        ih = (torch.minimum(y2, by2) - torch.maximum(y1, by1)).clamp_min(0.0)
        inter = iw * ih
        barea = (bx2 - bx1).clamp_min(0.0) * (by2 - by1).clamp_min(0.0)
        iou = inter / (areas + barea - inter).clamp_min(1e-16)
        kill = ((iou > iou_threshold) & (classes == classes[rows, i][:, None])) | (
            arange_a == i[:, None])
        live = torch.where(ok[:, None] & kill, neg_inf, live)
        out_idx[:, r] = torch.where(ok, i, torch.zeros_like(i))
        out_keep[:, r] = ok
    return out_idx, out_keep


def non_max_suppression(prediction: torch.Tensor, num_classes: int,
                        conf_thres: float = 0.5, nms_thres: float = 0.4,
                        max_out: int = 100,
                        fixed_rounds: bool = False) -> dict[str, torch.Tensor]:
    """Batched class-aware NMS over decoded predictions (B, A, 5+C)
    (utils/utils_bbox.py:86-131).  Returns a dict of (B, max_out) tensors:
    boxes_xyxy (normalised), scores (obj*cls), obj, class_conf, classes,
    valid.  `fixed_rounds`: see `nms_fixed`."""
    boxes_xyxy = torch.cat([prediction[..., :2] - prediction[..., 2:4] / 2.0,
                            prediction[..., :2] + prediction[..., 2:4] / 2.0], -1)
    obj = prediction[..., 4]
    cls_scores = prediction[..., 5:5 + num_classes]
    class_conf = cls_scores.amax(dim=-1)
    class_pred = torch.argmax(cls_scores, dim=-1)               # first max
    score = obj * class_conf
    idx, keep = nms_fixed(boxes_xyxy, score, class_pred, score >= conf_thres,
                          nms_thres, max_out, fixed_rounds)
    take = lambda t: torch.gather(t, 1, idx)  # noqa: E731
    return {
        "boxes_xyxy": torch.gather(boxes_xyxy, 1, idx[..., None].expand(-1, -1, 4)),
        "scores": take(score),
        "obj": take(obj),
        "class_conf": take(class_conf),
        "classes": take(class_pred),
        "valid": keep,
    }
