"""Synthetic WaterScenes-format batches for tests and smoke runs (the port's
own copy of `asy_vrnet_tpu/data/synthetic.py::make_batch`, numpy only):
ImageNet-normalised images, raw 4-channel radar maps, padded GT boxes (cxcywh
absolute pixels + class) and seg targets with the trailing ignore class.  The
same generator and seed give the same batch in both packages."""
from __future__ import annotations

import numpy as np


def make_batch(
    rng: np.random.Generator,
    batch_size: int = 2,
    hw: tuple[int, int] = (64, 64),
    num_classes: int = 4,
    num_seg_classes: int = 9,
    max_boxes: int = 16,
    boxes_per_image: int = 3,
) -> dict:
    h, w = hw
    image = rng.standard_normal((batch_size, h, w, 3)).astype(np.float32)
    radar = (rng.standard_normal((batch_size, h, w, 4)) * 10.0).astype(np.float32)

    gt_boxes = np.zeros((batch_size, max_boxes, 4), np.float32)
    gt_classes = np.zeros((batch_size, max_boxes), np.int32)
    gt_valid = np.zeros((batch_size, max_boxes), bool)
    for b in range(batch_size):
        n = min(boxes_per_image, max_boxes)
        cxcy = rng.uniform(0.15 * w, 0.85 * w, (n, 2))
        wh = rng.uniform(0.08 * w, 0.3 * w, (n, 2))
        gt_boxes[b, :n, :2] = cxcy
        gt_boxes[b, :n, 2:] = wh
        gt_classes[b, :n] = rng.integers(0, num_classes, n)
        gt_valid[b, :n] = True

    seg_target = rng.integers(0, num_seg_classes + 1, (batch_size, h, w)).astype(np.int32)
    seg_onehot = np.eye(num_seg_classes + 1, dtype=np.float32)[seg_target]

    return {
        "image": image,
        "radar": radar,
        "gt_boxes": gt_boxes,
        "gt_classes": gt_classes,
        "gt_valid": gt_valid,
        "seg_target": seg_target,
        "seg_onehot": seg_onehot,
    }
