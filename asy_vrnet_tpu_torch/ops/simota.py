"""SimOTA dynamic label assignment for one image, in fixed shapes (counterpart
of `asy_vrnet_tpu/ops/simota.py`; reference nets/yolo_training.py:209-427).
This is the plain twin of the CUDA kernel in `ops/simota_fused.py`.

  - GT boxes are padded to (G, 4) with a validity mask;
  - the cost matrix covers *all* anchors, with additive big-M terms in place
    of the reference's gathers: 1e5 for anchors outside the centre/box
    intersection and 1e9 for anchors outside the fg prefilter or rows of
    invalid GTs;
  - per GT, dynamic k = clamp(int(sum of the top-k candidate IoUs), 1, k) and
    the first dynamic-k of the k lowest-cost anchors are matched;
  - an anchor matched to more than one GT keeps the minimum-cost GT.

Everything is f32 under `torch.no_grad`.  Ties decide results (a cost that
carries the 1e5 penalty has an f32 ulp of 0.0078), so every argmax and argmin
takes the FIRST index; `_first_argmax` / `_first_argmin` make that explicit
instead of leaning on a library's tie rule.  The arithmetic is written in the
order the fused kernel uses (class costs summed in class order, the IoU with
the 1e-12 floor on the union), so that both round alike.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_BIG = 1e9             # replaces data-dependent gathers
_CENTER_PENALTY = 1e5  # the reference's soft constraint (yolo_training.py:257)


class SimOTAResult(NamedTuple):
    fg_mask: torch.Tensor       # (A,) bool: the anchor is a positive
    matched_gt: torch.Tensor    # (A,) int64: index of the matched GT (0 if none)
    pred_iou: torch.Tensor      # (A,) f32: IoU with the matched GT (0 if none)
    num_fg: torch.Tensor        # () f32


def _first_argmax(x: torch.Tensor):
    """(G, A) -> (row max (G,), first index attaining it (G,))."""
    m = x.max(dim=1).values
    iota = torch.arange(x.shape[1], device=x.device)
    hit = torch.where(x == m[:, None], iota[None], x.shape[1])
    return m, hit.min(dim=1).values.clamp_max(x.shape[1] - 1)


def _first_argmin(x: torch.Tensor, dim: int = 1):
    m = x.min(dim=dim).values
    n = x.shape[dim]
    iota = torch.arange(n, device=x.device)
    iota = iota[None] if dim == 1 else iota[:, None]
    hit = torch.where(x == m.unsqueeze(dim), iota, n)
    return m, hit.min(dim=dim).values.clamp_max(n - 1)


def in_boxes_info(gt_boxes, gt_valid, grids, strides, center_radius: float = 2.5):
    """(fg_prefilter (A,), in_box (G,A), in_center (G,A)); parity with
    get_in_boxes_info (yolo_training.py:291-365)."""
    cx = ((grids[:, 0] + 0.5) * strides)[None, :]
    cy = ((grids[:, 1] + 0.5) * strides)[None, :]
    gcx, gcy, gw, gh = (gt_boxes[:, i:i + 1] for i in range(4))
    valid = gt_valid[:, None]
    in_box = ((cx > gcx - 0.5 * gw) & (cx < gcx + 0.5 * gw)
              & (cy > gcy - 0.5 * gh) & (cy < gcy + 0.5 * gh)) & valid
    r = (center_radius * strides)[None, :]
    in_center = ((cx > gcx - r) & (cx < gcx + r)
                 & (cy > gcy - r) & (cy < gcy + r)) & valid
    return (in_box | in_center).any(dim=0), in_box, in_center


def _pairwise_iou(gt_boxes, pred_boxes):
    """(G,4) x (A,4) cxcywh -> (G,A) IoU in the fused kernel's form: clamped
    overlaps and a 1e-12 floor on the union.  Equal to
    `boxes.pairwise_iou_cxcywh` wherever that one is finite."""
    gcx, gcy, gw, gh = (gt_boxes[:, i:i + 1] for i in range(4))
    px, py, pw, ph = (pred_boxes[None, :, i] for i in range(4))
    ixmin = torch.maximum(gcx - 0.5 * gw, px - 0.5 * pw)
    ixmax = torch.minimum(gcx + 0.5 * gw, px + 0.5 * pw)
    iymin = torch.maximum(gcy - 0.5 * gh, py - 0.5 * ph)
    iymax = torch.minimum(gcy + 0.5 * gh, py + 0.5 * ph)
    inter = (ixmax - ixmin).clamp_min(0.0) * (iymax - iymin).clamp_min(0.0)
    union = gw * gh + pw * ph - inter
    return inter / union.clamp_min(1e-12)


@torch.no_grad()
def simota_assign(pred_boxes, cls_logits, obj_logits, gt_boxes, gt_classes,
                  gt_valid, grids, strides, center_radius: float = 2.5,
                  candidate_k: int = 10, return_dynamic_ks: bool = False):
    """Single-image SimOTA.  pred_boxes (A,4) cxcywh absolute, cls_logits
    (A,C), obj_logits (A,) or (A,1), gt_boxes (G,4), gt_classes (G,) int,
    gt_valid (G,) bool, grids (A,2), strides (A,) -> SimOTAResult
    [, dynamic_ks (G,) int32, 0 for invalid GTs]."""
    f32 = torch.float32
    pred_boxes = pred_boxes.to(f32)
    cls_logits = cls_logits.to(f32)
    obj_logits = obj_logits.to(f32).reshape(-1)
    gt_boxes = gt_boxes.to(f32)
    gt_valid = gt_valid.bool()
    a, c = cls_logits.shape
    g = gt_boxes.shape[0]

    fg_pre, in_box, in_center = in_boxes_info(gt_boxes, gt_valid, grids, strides,
                                              center_radius)
    both = in_box & in_center                                        # (G, A)
    zero = torch.zeros((), dtype=f32, device=pred_boxes.device)
    ious = torch.where(gt_valid[:, None], _pairwise_iou(gt_boxes, pred_boxes), zero)
    iou_cost = -torch.log(ious + 1e-8)

    # BCE(sqrt(p_cls * p_obj), one-hot class) with torch's -100 log clamp,
    # summed over classes in class order
    obj_sig = torch.sigmoid(obj_logits)
    cls_cost = torch.zeros((g, a), dtype=f32, device=pred_boxes.device)
    for ci in range(c):
        p = torch.sqrt(torch.sigmoid(cls_logits[:, ci]) * obj_sig)[None, :]
        logp = torch.log(p).clamp_min(-100.0)
        log1mp = torch.log1p(-p).clamp_min(-100.0)
        t = (gt_classes == ci).to(f32)[:, None]
        cls_cost = cls_cost - (t * logp + (1.0 - t) * log1mp)

    invalid = (~fg_pre)[None, :] | (~gt_valid)[:, None]
    cost = (cls_cost + 3.0 * iou_cost + _CENTER_PENALTY * (~both).to(f32)
            + _BIG * invalid.to(f32))

    # dynamic k per GT: k rounds of first-index max-and-mask
    k = min(candidate_k, a)
    rows = torch.arange(g, device=cost.device)
    xm = torch.where(fg_pre[None, :], ious, zero)
    topk_sum = torch.zeros(g, dtype=f32, device=cost.device)
    for _ in range(k):
        m, idx = _first_argmax(xm)
        xm[rows, idx] = 0.0
        topk_sum = topk_sum + m
    dynamic_ks = topk_sum.to(torch.int32).clamp(1, k)                # truncates

    # per GT: the first dynamic_k of the k lowest-cost anchors, skipping
    # anchors that carry the big-M (outside the prefilter, or an invalid GT)
    xm = cost.clone()
    matching = torch.zeros((g, a), dtype=f32, device=cost.device)
    for j in range(k):
        m, idx = _first_argmin(xm)
        ok = (j < dynamic_ks) & (m < _BIG / 2)
        xm[rows, idx] = float("inf")
        matching[rows, idx] += ok.to(f32)

    # conflicts: an anchor matched to more than one GT keeps the first
    # minimum-cost GT over all rows
    conflict = matching.sum(dim=0) > 1.0
    _, best_gt = _first_argmin(cost, dim=0)
    resolved = (torch.arange(g, device=cost.device)[:, None] == best_gt[None, :]).to(f32)
    matching = torch.where(conflict[None, :], resolved, matching)

    fg_mask = matching.sum(dim=0) > 0.0
    _, matched_gt = _first_argmin(-matching, dim=0)                  # first argmax
    pred_iou = (matching * ious).sum(dim=0)
    result = SimOTAResult(fg_mask, matched_gt, pred_iou, fg_mask.to(f32).sum())
    if return_dynamic_ks:
        return result, torch.where(gt_valid, dynamic_ks, torch.zeros_like(dynamic_ks))
    return result
