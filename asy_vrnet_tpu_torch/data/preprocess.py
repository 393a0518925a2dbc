"""Host-side preprocessing, numpy/PIL, and the device-side image normalise of
the train step (counterpart of `asy_vrnet_tpu/data/preprocess.py`; reference
utils/utils.py:9-53)."""
from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def cvt_color(image):
    """Ensure a PIL image is RGB (utils/utils.py:9-14)."""
    if len(np.shape(image)) == 3 and np.shape(image)[2] == 3:
        return image
    return image.convert("RGB")


def letterbox_image(image, size_wh: tuple[int, int], fill=(128, 128, 128)):
    """PIL BICUBIC letterbox with gray padding (utils/utils.py:19-32).
    Returns (new_image, nw, nh)."""
    from PIL import Image

    iw, ih = image.size
    w, h = size_wh
    scale = min(w / iw, h / ih)
    nw, nh = int(iw * scale), int(ih * scale)
    image = image.resize((nw, nh), Image.BICUBIC)
    new_image = Image.new("RGB", (w, h), fill)
    new_image.paste(image, ((w - nw) // 2, (h - nh) // 2))
    return new_image, nw, nh


def normalize_image(image: np.ndarray) -> np.ndarray:
    """/255, ImageNet mean/std (preprocess_input, utils/utils.py:43-47)."""
    image = np.asarray(image, np.float32) / 255.0
    return (image - IMAGENET_MEAN) / IMAGENET_STD


def maybe_normalize_image_device(image):
    """Device-side normalise for uint8 image batches (a torch tensor, NHWC);
    float batches pass through.  A lean input pipeline ships uint8 images (4x
    less host-to-device traffic) and the step normalises them; numerics match
    `normalize_image` to f32 rounding."""
    import torch

    if image.dtype == torch.uint8:
        x = image.float() / 255.0
        mean = torch.as_tensor(IMAGENET_MEAN, device=image.device)
        std = torch.as_tensor(IMAGENET_STD, device=image.device)
        return (x - mean) / std
    return image


def normalize_radar_minmax(data: np.ndarray) -> np.ndarray:
    """Global min-max to [0,1] + eps (preprocess_input_radar,
    utils/utils.py:50-53).  Parity: the reference applies it only in
    yolo.detect_image (yolo.py:134)."""
    rng = np.max(data) - np.min(data)
    return (data - np.min(data)) / rng + 1e-13


def get_classes(classes_path: str) -> tuple[list[str], int]:
    with open(classes_path, encoding="utf-8") as f:
        names = [c.strip() for c in f.readlines()]
    return names, len(names)
