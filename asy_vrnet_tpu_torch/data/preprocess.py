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


def letterbox_label(label, size_wh: tuple[int, int]):
    """NEAREST letterbox for segmentation labels, 0 padding
    (utils/dataloader.py:144-146)."""
    from PIL import Image

    iw, ih = label.size
    w, h = size_wh
    scale = min(w / iw, h / ih)
    nw, nh = int(iw * scale), int(ih * scale)
    label = label.resize((nw, nh), Image.NEAREST)
    new_label = Image.new("L", (w, h), 0)
    new_label.paste(label, ((w - nw) // 2, (h - nh) // 2))
    return new_label


def letterbox_boxes(
    boxes: np.ndarray, src_wh: tuple[int, int], dst_wh: tuple[int, int]
) -> np.ndarray:
    """Transform xyxy pixel boxes through the letterbox; drops degenerate
    boxes (utils/dataloader.py:168-177)."""
    if len(boxes) == 0:
        return np.zeros((0, 5), np.float32)
    boxes = np.asarray(boxes, np.float32).copy()
    iw, ih = src_wh
    w, h = dst_wh
    scale = min(w / iw, h / ih)
    nw, nh = int(iw * scale), int(ih * scale)
    dx, dy = (w - nw) // 2, (h - nh) // 2
    boxes[:, [0, 2]] = boxes[:, [0, 2]] * nw / iw + dx
    boxes[:, [1, 3]] = boxes[:, [1, 3]] * nh / ih + dy
    boxes[:, 0:2] = np.maximum(boxes[:, 0:2], 0)
    boxes[:, 2] = np.minimum(boxes[:, 2], w)
    boxes[:, 3] = np.minimum(boxes[:, 3], h)
    bw = boxes[:, 2] - boxes[:, 0]
    bh = boxes[:, 3] - boxes[:, 1]
    return boxes[np.logical_and(bw > 1, bh > 1)]


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


def boxes_xyxy_to_cxcywh(boxes: np.ndarray) -> np.ndarray:
    """In the dataset's convention (utils/dataloader.py:89-90)."""
    out = np.asarray(boxes, np.float32).copy()
    if len(out):
        out[:, 2:4] = out[:, 2:4] - out[:, 0:2]
        out[:, 0:2] = out[:, 0:2] + out[:, 2:4] / 2
    return out
