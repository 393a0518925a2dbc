"""Synthetic WaterScenes-format batches and on-disk datasets for tests and
smoke runs (the port's own copy of `asy_vrnet_tpu/data/synthetic.py`, numpy
and PIL only): ImageNet-normalised images, raw 4-channel radar maps, padded
GT boxes (cxcywh absolute pixels + class) and seg targets with the trailing
ignore class.  The same generator or seed gives the same batch, and the same
files, in both packages."""
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


def write_learnable_voc_dataset(
    root: str,
    num_images: int = 64,
    hw: tuple[int, int] = (64, 64),
    num_classes: int = 4,
    num_seg_classes: int = 9,
    seed: int = 0,
    boxes_per_image: tuple[int, int] = (1, 3),
) -> dict:
    """A LEARNABLE synthetic WaterScenes-format dataset (same on-disk layout
    as write_synthetic_voc_dataset) for convergence/overfit validation:

      - objects are solid rectangles whose fill colour encodes a seg class
        in 1..num_seg_classes-1 (background = 0), so segmentation is exactly
        decodable from the image;
      - the detection class is (seg_cls - 1) * num_classes //
        (num_seg_classes - 1), so every det class and every seg class occurs;
      - the radar map carries a strong co-located rectangle in channel 0 and
        the class index in channel 1 (the det FPN consumes the radar-stream
        taps, vr_coc.py taps — radar must carry object signal).

    Training to AP50 ~1.0 / high mIoU on this set is the strongest accuracy
    validation available without the unreleased WaterScenes data
    (utils/callbacks.py:223-226).
    """
    import os

    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = hw
    os.makedirs(os.path.join(root, "JPEGImages"), exist_ok=True)
    os.makedirs(os.path.join(root, "VOC2007", "SegmentationClass"), exist_ok=True)
    os.makedirs(os.path.join(root, "radar"), exist_ok=True)

    n_obj_cls = num_seg_classes - 1
    # maximally distinct colours per seg class (background stays dark)
    base_palette = np.asarray(
        [
            [230, 25, 75],     # red
            [60, 180, 75],     # green
            [0, 130, 200],     # blue
            [255, 225, 25],    # yellow
            [240, 50, 230],    # magenta
            [70, 240, 240],    # cyan
            [245, 130, 48],    # orange
            [255, 255, 255],   # white
            [170, 110, 40],    # brown
            [128, 128, 128],   # gray
        ],
        dtype=np.float64,
    )
    palette = base_palette[
        np.arange(n_obj_cls) % len(base_palette)
    ]                                                 # (n_obj_cls, 3)

    lines = []
    for i in range(num_images):
        img_id = f"{1700000000 + i:d}.{10000 + i:05d}"
        img = rng.normal(30.0, 6.0, (h, w, 3))
        seg = np.zeros((h, w), np.uint8)
        radar = rng.normal(0.0, 0.3, (4, h, w)).astype(np.float32)

        lo, hi = boxes_per_image
        n_boxes = int(rng.integers(lo, hi + 1))
        parts = [os.path.join(root, "JPEGImages", img_id + ".jpg")]
        for bi in range(n_boxes):
            # cycle seg classes so all of 1..n_obj_cls appear across the set
            seg_cls = 1 + (i * hi + bi) % n_obj_cls
            det_cls = (seg_cls - 1) * num_classes // n_obj_cls
            bw = int(rng.integers(max(12, w // 4), max(14, w // 2)))
            bh = int(rng.integers(max(12, h // 4), max(14, h // 2)))
            x1 = int(rng.integers(0, w - bw))
            y1 = int(rng.integers(0, h - bh))
            x2, y2 = x1 + bw, y1 + bh
            img[y1:y2, x1:x2] = palette[seg_cls - 1] + rng.normal(
                0.0, 4.0, (bh, bw, 3)
            )
            seg[y1:y2, x1:x2] = seg_cls
            radar[0, y1:y2, x1:x2] = 8.0
            radar[1, y1:y2, x1:x2] = float(det_cls + 1) * 2.0
            # seg class in channel 2: either stream can resolve the mask —
            # this validates the training machinery, not vision difficulty
            radar[2, y1:y2, x1:x2] = float(seg_cls)
            parts.append(f"{x1},{y1},{x2},{y2},{det_cls}")

        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            parts[0], quality=95
        )
        Image.fromarray(seg, mode="L").save(
            os.path.join(root, "VOC2007", "SegmentationClass", img_id + ".png")
        )
        np.savez(os.path.join(root, "radar", img_id + ".npz"), radar)
        lines.append(" ".join(parts))

    ann_path = os.path.join(root, "train.txt")
    with open(ann_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    classes_path = os.path.join(root, "classes.txt")
    with open(classes_path, "w") as f:
        f.write("\n".join(["pier", "vessel", "ship", "boat"][:num_classes]) + "\n")
    return {
        "annotation_path": ann_path,
        "classes_path": classes_path,
        "radar_root": os.path.join(root, "radar"),
        "seg_dataset_path": root,
    }


def write_synthetic_voc_dataset(
    root: str,
    num_images: int = 4,
    hw: tuple[int, int] = (128, 96),
    num_classes: int = 4,
    num_seg_classes: int = 9,
    seed: int = 0,
) -> dict:
    """Create a tiny on-disk dataset in the reference's layout:
        <root>/JPEGImages/<id>.jpg
        <root>/VOC2007/SegmentationClass/<id>.png
        <root>/radar/<id>.npz           (key 'arr_0', 4xHxW)
        <root>/train.txt                annotation lines
        <root>/classes.txt
    IDs follow the timestamp pattern the loader regexes for
    (utils/dataloader.py:74-76): 10 digits, dot, 5 digits.
    """
    import os

    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = hw
    os.makedirs(os.path.join(root, "JPEGImages"), exist_ok=True)
    os.makedirs(os.path.join(root, "VOC2007", "SegmentationClass"), exist_ok=True)
    os.makedirs(os.path.join(root, "radar"), exist_ok=True)

    lines = []
    for i in range(num_images):
        img_id = f"{1600000000 + i:d}.{10000 + i:05d}"
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        img_path = os.path.join(root, "JPEGImages", img_id + ".jpg")
        Image.fromarray(img).save(img_path)

        seg = rng.integers(0, num_seg_classes, (h, w)).astype(np.uint8)
        Image.fromarray(seg, mode="L").save(
            os.path.join(root, "VOC2007", "SegmentationClass", img_id + ".png")
        )

        radar = rng.standard_normal((4, h, w)).astype(np.float32)
        np.savez(os.path.join(root, "radar", img_id + ".npz"), radar)

        n_boxes = int(rng.integers(1, 4))
        parts = [img_path]
        for _ in range(n_boxes):
            x1 = int(rng.integers(0, w - 20))
            y1 = int(rng.integers(0, h - 20))
            x2 = int(rng.integers(x1 + 10, min(x1 + 60, w)))
            y2 = int(rng.integers(y1 + 10, min(y1 + 60, h)))
            cls = int(rng.integers(0, num_classes))
            parts.append(f"{x1},{y1},{x2},{y2},{cls}")
        lines.append(" ".join(parts))

    ann_path = os.path.join(root, "train.txt")
    with open(ann_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    classes_path = os.path.join(root, "classes.txt")
    with open(classes_path, "w") as f:
        f.write("\n".join(["pier", "vessel", "ship", "boat"][:num_classes]) + "\n")
    return {
        "annotation_path": ann_path,
        "classes_path": classes_path,
        "radar_root": os.path.join(root, "radar"),
        "seg_dataset_path": root,
    }
