"""Training-time augmentations, numpy/PIL/cv2 on the host (the port's own copy
of `asy_vrnet_tpu/data/augment.py`).

Parity targets: the random branch of get_random_data (utils/dataloader.py:
186-249 — jitter/scale/place/flip/HSV), mosaic (:297-426, incl. the
merge_bboxes cut semantics), mixup (:428-436), and numpy re-implementations of
the albumentations weather transforms (:22-32 — rain/flare/fog; disabled by
default in the reference, train.py:498-508, and off by default here too).

Consistency note: the reference's random branch is dead code (an early return
precedes it) and never transformed the radar map or the seg label.  Here the
geometric ops (flip) are applied consistently to image, seg label and radar;
photometric ops touch only the image.  Mosaic/mixup operate on (image, boxes)
pairs exactly like the reference.
"""
from __future__ import annotations

import numpy as np


def _rand(rng, a=0.0, b=1.0):
    return float(rng.uniform(a, b))


def hsv_jitter(image_u8: np.ndarray, rng: np.random.Generator,
               hue: float = 0.1, sat: float = 0.7, val: float = 0.4) -> np.ndarray:
    """cv2-LUT HSV gain jitter (utils/dataloader.py:217-232)."""
    import cv2

    r = rng.uniform(-1, 1, 3) * np.array([hue, sat, val]) + 1
    h, s, v = cv2.split(cv2.cvtColor(image_u8, cv2.COLOR_RGB2HSV))
    x = np.arange(0, 256, dtype=r.dtype)
    lut_h = ((x * r[0]) % 180).astype(image_u8.dtype)
    lut_s = np.clip(x * r[1], 0, 255).astype(image_u8.dtype)
    lut_v = np.clip(x * r[2], 0, 255).astype(image_u8.dtype)
    out = cv2.merge((cv2.LUT(h, lut_h), cv2.LUT(s, lut_s), cv2.LUT(v, lut_v)))
    return cv2.cvtColor(out, cv2.COLOR_HSV2RGB)


def random_place(
    image, boxes: np.ndarray, input_hw: tuple[int, int],
    rng: np.random.Generator, jitter: float = 0.3,
    scale_range: tuple[float, float] = (0.25, 2.0),
):
    """Aspect-jittered random scale + random placement on a gray canvas, with
    box transform (utils/dataloader.py:186-247 minus flip/HSV).

    Returns (PIL image, boxes, (nw, nh, dx, dy))."""
    from PIL import Image

    h, w = input_hw
    iw, ih = image.size
    new_ar = iw / ih * _rand(rng, 1 - jitter, 1 + jitter) / _rand(rng, 1 - jitter, 1 + jitter)
    scale = _rand(rng, *scale_range)
    if new_ar < 1:
        nh = int(scale * h)
        nw = int(nh * new_ar)
    else:
        nw = int(scale * w)
        nh = int(nw / new_ar)
    nw, nh = max(nw, 1), max(nh, 1)
    image = image.resize((nw, nh), Image.BICUBIC)
    dx = int(_rand(rng, 0, max(w - nw, 0))) if w > nw else (w - nw) // 2
    dy = int(_rand(rng, 0, max(h - nh, 0))) if h > nh else (h - nh) // 2
    canvas = Image.new("RGB", (w, h), (128, 128, 128))
    canvas.paste(image, (dx, dy))

    boxes = np.asarray(boxes, np.float32).reshape(-1, 5).copy()
    if len(boxes):
        boxes[:, [0, 2]] = boxes[:, [0, 2]] * nw / iw + dx
        boxes[:, [1, 3]] = boxes[:, [1, 3]] * nh / ih + dy
        boxes[:, 0:2] = np.maximum(boxes[:, 0:2], 0)
        boxes[:, 2] = np.minimum(boxes[:, 2], w)
        boxes[:, 3] = np.minimum(boxes[:, 3], h)
        bw = boxes[:, 2] - boxes[:, 0]
        bh = boxes[:, 3] - boxes[:, 1]
        boxes = boxes[np.logical_and(bw > 1, bh > 1)]
    return canvas, boxes, (nw, nh, dx, dy)


def flip_horizontal(image_u8: np.ndarray, boxes: np.ndarray,
                    seg: np.ndarray | None = None,
                    radar_hwc: np.ndarray | None = None):
    """Consistent left-right flip of image/boxes/seg/radar."""
    w = image_u8.shape[1]
    image_u8 = image_u8[:, ::-1]
    boxes = np.asarray(boxes, np.float32).reshape(-1, 5).copy()
    if len(boxes):
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    out = [image_u8, boxes]
    out.append(seg[:, ::-1] if seg is not None else None)
    out.append(radar_hwc[:, ::-1] if radar_hwc is not None else None)
    return tuple(out)


def merge_mosaic_boxes(box_datas, cutx: int, cuty: int) -> np.ndarray:
    """Clip each quadrant's boxes to its region (utils/dataloader.py:251-295)."""
    merged = []
    for i, boxes in enumerate(box_datas):
        for box in np.asarray(boxes, np.float32).reshape(-1, 5):
            x1, y1, x2, y2, cls = box
            if i == 0:      # top-left
                if y1 > cuty or x1 > cutx:
                    continue
                y2 = min(y2, cuty) if y2 >= cuty >= y1 else y2
                x2 = min(x2, cutx) if x2 >= cutx >= x1 else x2
            elif i == 1:    # bottom-left
                if y2 < cuty or x1 > cutx:
                    continue
                y1 = max(y1, cuty) if y2 >= cuty >= y1 else y1
                x2 = min(x2, cutx) if x2 >= cutx >= x1 else x2
            elif i == 2:    # bottom-right
                if y2 < cuty or x2 < cutx:
                    continue
                y1 = max(y1, cuty) if y2 >= cuty >= y1 else y1
                x1 = max(x1, cutx) if x2 >= cutx >= x1 else x1
            else:           # top-right
                if y1 > cuty or x2 < cutx:
                    continue
                y2 = min(y2, cuty) if y2 >= cuty >= y1 else y2
                x1 = max(x1, cutx) if x2 >= cutx >= x1 else x1
            merged.append([x1, y1, x2, y2, cls])
    return np.asarray(merged, np.float32).reshape(-1, 5)


def mosaic(images, boxes_list, input_hw: tuple[int, int],
           rng: np.random.Generator, jitter: float = 0.3):
    """4-image mosaic composite (utils/dataloader.py:297-426 geometry)."""
    from PIL import Image

    h, w = input_hw
    off_x = _rand(rng, 0.3, 0.7)
    off_y = _rand(rng, 0.3, 0.7)
    cutx, cuty = int(w * off_x), int(h * off_y)

    canv_datas, box_datas = [], []
    for index, (image, boxes) in enumerate(zip(images, boxes_list)):
        iw, ih = image.size
        boxes = np.asarray(boxes, np.float32).reshape(-1, 5).copy()
        if _rand(rng) < 0.5 and len(boxes):
            image = image.transpose(Image.FLIP_LEFT_RIGHT)
            boxes[:, [0, 2]] = iw - boxes[:, [2, 0]]
        new_ar = iw / ih * _rand(rng, 1 - jitter, 1 + jitter) / _rand(rng, 1 - jitter, 1 + jitter)
        scale = _rand(rng, 0.4, 1.0)
        if new_ar < 1:
            nh = int(scale * h)
            nw = max(int(nh * new_ar), 1)
        else:
            nw = int(scale * w)
            nh = max(int(nw / new_ar), 1)
        image = image.resize((nw, nh), Image.BICUBIC)
        dx, dy = {
            0: (cutx - nw, cuty - nh),
            1: (cutx - nw, cuty),
            2: (cutx, cuty),
            3: (cutx, cuty - nh),
        }[index]
        canvas = Image.new("RGB", (w, h), (128, 128, 128))
        canvas.paste(image, (dx, dy))
        canv_datas.append(np.asarray(canvas))
        if len(boxes):
            boxes[:, [0, 2]] = boxes[:, [0, 2]] * nw / iw + dx
            boxes[:, [1, 3]] = boxes[:, [1, 3]] * nh / ih + dy
            boxes[:, 0:2] = np.maximum(boxes[:, 0:2], 0)
            boxes[:, 2] = np.minimum(boxes[:, 2], w)
            boxes[:, 3] = np.minimum(boxes[:, 3], h)
            bw = boxes[:, 2] - boxes[:, 0]
            bh = boxes[:, 3] - boxes[:, 1]
            boxes = boxes[np.logical_and(bw > 1, bh > 1)]
        box_datas.append(boxes)

    out = np.zeros((h, w, 3), np.uint8)
    out[:cuty, :cutx] = canv_datas[0][:cuty, :cutx]
    out[cuty:, :cutx] = canv_datas[1][cuty:, :cutx]
    out[cuty:, cutx:] = canv_datas[2][cuty:, cutx:]
    out[:cuty, cutx:] = canv_datas[3][:cuty, cutx:]
    return out, merge_mosaic_boxes(box_datas, cutx, cuty)


def mixup(image_1, boxes_1, image_2, boxes_2):
    """50/50 image blend, box union (utils/dataloader.py:428-436)."""
    out = (np.asarray(image_1, np.float32) * 0.5 + np.asarray(image_2, np.float32) * 0.5)
    b1 = np.asarray(boxes_1, np.float32).reshape(-1, 5)
    b2 = np.asarray(boxes_2, np.float32).reshape(-1, 5)
    if len(b1) == 0:
        boxes = b2
    elif len(b2) == 0:
        boxes = b1
    else:
        boxes = np.concatenate([b1, b2], axis=0)
    return out.astype(np.uint8), boxes


# ---------------------------------------------------------------------------
# Weather augmentations (albumentations-free re-implementations of
# RandomRain / RandomSunFlare / RandomFog, utils/dataloader.py:22-32)
# ---------------------------------------------------------------------------

def rain(image_u8: np.ndarray, rng: np.random.Generator,
         brightness: float = 0.9, drop_length: int = 12,
         density: float = 0.002) -> np.ndarray:
    h, w = image_u8.shape[:2]
    out = (image_u8.astype(np.float32) * brightness)
    n = max(1, int(h * w * density))
    xs = rng.integers(0, w, n)
    ys = rng.integers(0, max(h - drop_length, 1), n)
    slant = int(rng.integers(-3, 4))
    for i in range(drop_length):
        xi = np.clip(xs + (i * slant) // max(drop_length, 1), 0, w - 1)
        yi = np.clip(ys + i, 0, h - 1)
        out[yi, xi] = out[yi, xi] * 0.5 + 200 * 0.5
    return np.clip(out, 0, 255).astype(np.uint8)


def fog(image_u8: np.ndarray, rng: np.random.Generator,
        coef_range: tuple[float, float] = (0.2, 0.5)) -> np.ndarray:
    coef = _rand(rng, *coef_range)
    fog_color = 255.0
    out = image_u8.astype(np.float32) * (1 - coef) + fog_color * coef
    return np.clip(out, 0, 255).astype(np.uint8)


def sun_flare(image_u8: np.ndarray, rng: np.random.Generator,
              roi: tuple[float, float, float, float] = (0.4, 0.4, 1.0, 0.5),
              radius_frac: float = 0.15) -> np.ndarray:
    h, w = image_u8.shape[:2]
    cx = int(_rand(rng, roi[0], roi[2]) * (w - 1))
    cy = int(_rand(rng, roi[1], roi[3]) * (h - 1))
    r = max(int(radius_frac * max(h, w)), 2)
    ys, xs = np.mgrid[0:h, 0:w]
    dist2 = (xs - cx) ** 2 + (ys - cy) ** 2
    glow = np.clip(1.0 - dist2 / (r * r), 0.0, 1.0) ** 2
    out = image_u8.astype(np.float32) + 255.0 * glow[..., None]
    return np.clip(out, 0, 255).astype(np.uint8)


def apply_weather(image_u8: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Reference mixture: 15% rain, 15% flare, 35% fog, 35% none
    (the commented-out block, utils/dataloader.py:151-163)."""
    roll = int(rng.integers(0, 100))
    if roll < 15:
        return rain(image_u8, rng)
    if roll < 30:
        return sun_flare(image_u8, rng)
    if roll < 65:
        return fog(image_u8, rng)
    return image_u8
