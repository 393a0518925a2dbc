"""Segmentation-only dataset (utils_seg/dataloader.py:12-169 DeeplabDataset;
the port's own copy of `asy_vrnet_tpu/data/seg_dataset.py`).

The reference builds this dataset but comments it out of the joint training
path (train.py:513-514); it remains part of the capability surface for
seg-only experiments.  Aug pipeline (train mode): aspect-jittered random
scale, left-right flip, random placement on a gray canvas, Gaussian blur
p=0.25, rotation p=0.25, HSV jitter — mirrored here with numpy/cv2.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from asy_vrnet_tpu_torch.data.augment import hsv_jitter
from asy_vrnet_tpu_torch.data.preprocess import (
    cvt_color,
    letterbox_image,
    letterbox_label,
    normalize_image,
)


class SegOnlyDataset:
    def __init__(
        self,
        annotation_lines: Sequence[str],
        input_shape: tuple[int, int],
        num_classes: int,
        train: bool,
        dataset_path: str,
        seed: int = 0,
        host_normalize: bool = False,
    ):
        self.lines = [l.strip() for l in annotation_lines if l.strip()]
        self.input_shape = input_shape
        self.num_classes = num_classes
        self.train = train
        self.dataset_path = dataset_path
        # per-(seed, epoch, sample) RNG: deterministic and safe under
        # DataLoader worker threads (a shared Generator is neither)
        self.seed = seed
        self.epoch = 0
        # False: emit uint8, normalise on device (see WaterScenesDataset)
        self.host_normalize = host_normalize

    def __len__(self) -> int:
        return len(self.lines)

    def __getitem__(self, index: int) -> dict:
        from PIL import Image

        name = self.lines[index % len(self)].split()[0]
        jpg = Image.open(
            os.path.join(self.dataset_path, "VOC2007", "JPEGImages", name + ".jpg")
        )
        png = Image.open(
            os.path.join(self.dataset_path, "VOC2007", "SegmentationClass", name + ".png")
        )
        rng = np.random.default_rng((self.seed, self.epoch, index))
        jpg, png = self._random_data(jpg, png, rng)

        if self.host_normalize:
            img = normalize_image(np.asarray(jpg)).astype(np.float32)
        else:
            img = np.ascontiguousarray(np.asarray(jpg))
        seg = np.minimum(np.asarray(png), self.num_classes)
        if seg.dtype != np.uint8:
            seg = seg.astype(np.uint8 if self.num_classes < 255 else np.int32)
        # no seg_onehot: the step one-hots the target on the device
        # (train_step.seg_onehot_of)
        return {
            "image": img,
            "seg_target": seg,
            "image_id": name,
        }

    def _random_data(self, image, label, rng, jitter=0.3):
        from PIL import Image

        import cv2

        def _rand(a=0.0, b=1.0) -> float:
            return float(rng.uniform(a, b))

        image = cvt_color(image)
        label = Image.fromarray(np.asarray(label))
        h, w = self.input_shape
        if not self.train:
            image, _, _ = letterbox_image(image, (w, h))
            label = letterbox_label(label, (w, h))
            return image, label

        iw, ih = image.size
        new_ar = iw / ih * _rand(1 - jitter, 1 + jitter) / _rand(1 - jitter, 1 + jitter)
        scale = _rand(0.25, 2)
        if new_ar < 1:
            nh = int(scale * h)
            nw = max(int(nh * new_ar), 1)
        else:
            nw = int(scale * w)
            nh = max(int(nw / new_ar), 1)
        image = image.resize((nw, nh), Image.BICUBIC)
        label = label.resize((nw, nh), Image.NEAREST)

        if _rand() < 0.5:
            image = image.transpose(Image.FLIP_LEFT_RIGHT)
            label = label.transpose(Image.FLIP_LEFT_RIGHT)

        dx = int(_rand(0, max(w - nw, 0))) if w > nw else (w - nw) // 2
        dy = int(_rand(0, max(h - nh, 0))) if h > nh else (h - nh) // 2
        new_image = Image.new("RGB", (w, h), (128, 128, 128))
        new_label = Image.new("L", (w, h), 0)
        new_image.paste(image, (dx, dy))
        new_label.paste(label, (dx, dy))

        image_data = np.asarray(new_image, dtype=np.uint8)
        if _rand() < 0.25:
            image_data = cv2.GaussianBlur(image_data, (5, 5), 0)
        if _rand() < 0.25:
            angle = int(rng.integers(-10, 11))
            center = (w // 2, h // 2)
            m = cv2.getRotationMatrix2D(center, -angle, 1)
            image_data = cv2.warpAffine(
                image_data, m, (w, h), flags=cv2.INTER_CUBIC,
                borderValue=(128, 128, 128),
            )
            new_label = Image.fromarray(
                cv2.warpAffine(
                    np.asarray(new_label), m, (w, h),
                    flags=cv2.INTER_NEAREST, borderValue=(0,),
                )
            )
        image_data = hsv_jitter(image_data, rng, hue=0.1, sat=0.7, val=0.3)
        return Image.fromarray(image_data), new_label
