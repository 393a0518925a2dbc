"""Box decode utilities (counterpart of `asy_vrnet_tpu/ops/boxes.py`;
reference utils/utils_bbox.py:5-84).  Anchor order: levels in (stride 8, 16,
32) order, each flattened row-major with x fastest."""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _level_grid(h: int, w: int) -> np.ndarray:
    """(h*w, 2) grid of (x, y) cell indices, x fastest."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1).astype(np.float32)


def make_grids_and_strides(level_hw: Sequence[tuple[int, int]],
                           strides: Sequence[float], device=None):
    """Concatenated (A,2) grid and (A,) stride vectors for all levels."""
    grids = np.concatenate([_level_grid(h, w) for h, w in level_hw], axis=0)
    svec = np.concatenate(
        [np.full((h * w,), s, np.float32) for (h, w), s in zip(level_hw, strides)])
    return (torch.as_tensor(grids, device=device),
            torch.as_tensor(svec, device=device))


def flatten_level_outputs(det_outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """3x NHWC (B,h,w,5+C) -> (B, A, 5+C), reference anchor order."""
    return torch.cat([o.reshape(o.shape[0], -1, o.shape[-1]) for o in det_outputs], 1)


def decode_for_loss(det_outputs: Sequence[torch.Tensor], strides: Sequence[float]):
    """Raw head maps -> absolute-pixel predictions for the YOLOX loss:
    (outputs (B,A,5+C) with xy/wh decoded and obj/cls raw logits, grid (A,2),
    stride (A,)); xy=(pred+grid)*stride, wh=exp(pred)*stride
    (yolo_training.py:99-111)."""
    level_hw = tuple((o.shape[1], o.shape[2]) for o in det_outputs)
    out = flatten_level_outputs(det_outputs)
    grid, svec = make_grids_and_strides(level_hw, strides, out.device)
    xy = (out[..., :2] + grid) * svec[None, :, None]
    wh = torch.exp(out[..., 2:4]) * svec[None, :, None]
    return torch.cat([xy, wh, out[..., 4:]], dim=-1), grid, svec


def decode_predictions(det_outputs: Sequence[torch.Tensor],
                       input_hw: tuple[int, int],
                       strides: Sequence[int] = (8, 16, 32)) -> torch.Tensor:
    """Raw head maps -> (B, A, 5+C) with normalised cxcywh + sigmoid scores.
    Like the reference, per-level stride is input_h / level_h (`strides` is
    accepted for signature parity with the JAX package)."""
    level_hw = tuple((o.shape[1], o.shape[2]) for o in det_outputs)
    eff_strides = tuple(input_hw[0] / h for h, _ in level_hw)
    out = flatten_level_outputs(det_outputs).float()
    grid, svec = make_grids_and_strides(level_hw, eff_strides, out.device)
    xy = (out[..., :2] + grid) * svec[None, :, None]
    wh = torch.exp(out[..., 2:4]) * svec[None, :, None]
    scores = torch.sigmoid(out[..., 4:])
    norm = torch.tensor([input_hw[1], input_hw[0], input_hw[1], input_hw[0]],
                        dtype=torch.float32, device=out.device)
    return torch.cat([torch.cat([xy, wh], -1) / norm, scores], dim=-1)


def cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    xy, wh = b[..., :2], b[..., 2:4]
    return torch.cat([xy - wh / 2.0, xy + wh / 2.0], dim=-1)


def pairwise_iou_cxcywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix between (M,4) and (N,4) cxcywh boxes (yolo_training.py:266-289,
    xyxy=False branch; same epsilon-free denominator)."""
    tl = torch.maximum(a[:, None, :2] - a[:, None, 2:] / 2, b[None, :, :2] - b[None, :, 2:] / 2)
    br = torch.minimum(a[:, None, :2] + a[:, None, 2:] / 2, b[None, :, :2] + b[None, :, 2:] / 2)
    area_a = a[:, 2:].prod(dim=-1)
    area_b = b[:, 2:].prod(dim=-1)
    valid = (tl < br).all(dim=-1).to(a.dtype)
    inter = (br - tl).prod(dim=-1) * valid
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def iou_loss_squared(pred_cxcywh: torch.Tensor, tgt_cxcywh: torch.Tensor) -> torch.Tensor:
    """Elementwise 1 - iou^2 loss (IOUloss, yolo_training.py:13-57)."""
    tl = torch.maximum(pred_cxcywh[..., :2] - pred_cxcywh[..., 2:] / 2,
                       tgt_cxcywh[..., :2] - tgt_cxcywh[..., 2:] / 2)
    br = torch.minimum(pred_cxcywh[..., :2] + pred_cxcywh[..., 2:] / 2,
                       tgt_cxcywh[..., :2] + tgt_cxcywh[..., 2:] / 2)
    area_p = pred_cxcywh[..., 2:].prod(dim=-1)
    area_g = tgt_cxcywh[..., 2:].prod(dim=-1)
    valid = (tl < br).all(dim=-1).to(pred_cxcywh.dtype)
    inter = (br - tl).prod(dim=-1) * valid
    iou = inter / (area_p + area_g - inter + 1e-16)
    return 1.0 - iou ** 2


def correct_boxes(boxes_xyxy_norm: np.ndarray, input_hw: tuple[int, int],
                  image_hw: tuple[int, int], letterbox: bool = True) -> np.ndarray:
    """Map normalised network-space xyxy boxes back to original-image pixel
    coords (y1, x1, y2, x2 order, like the reference), removing letterbox
    padding (utils/utils_bbox.py:5-30).  Host-side numpy."""
    boxes = np.asarray(boxes_xyxy_norm, np.float32)
    x1, y1, x2, y2 = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    box_yx = np.stack([(y1 + y2) / 2, (x1 + x2) / 2], axis=-1)
    box_hw = np.stack([y2 - y1, x2 - x1], axis=-1)
    input_shape = np.array(input_hw, np.float32)
    image_shape = np.array(image_hw, np.float32)
    if letterbox:
        new_shape = np.round(image_shape * np.min(input_shape / image_shape))
        offset = (input_shape - new_shape) / 2.0 / input_shape
        scale = input_shape / new_shape
        box_yx = (box_yx - offset) * scale
        box_hw = box_hw * scale
    mins = box_yx - box_hw / 2.0
    maxes = box_yx + box_hw / 2.0
    out = np.concatenate(
        [mins[..., 0:1], mins[..., 1:2], maxes[..., 0:1], maxes[..., 1:2]], axis=-1)
    out *= np.concatenate([image_shape, image_shape], axis=-1)
    return out
