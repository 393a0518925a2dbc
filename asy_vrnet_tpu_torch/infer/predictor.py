"""Detection wrapper (counterpart of `asy_vrnet_tpu/infer/predictor.py::
Detector`; reference yolo.py:20-452): PIL image + radar array -> letterbox
-> forward -> decode -> NMS -> boxes in original-image pixels.

Runs on the card unless `device="cpu"`.  `Segmenter`, `draw`, `heatmap`
and the CLIs are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from asy_vrnet_tpu_torch.config import ModelConfig
from asy_vrnet_tpu_torch.data.preprocess import (
    cvt_color,
    letterbox_image,
    normalize_image,
    normalize_radar_minmax,
)
from asy_vrnet_tpu_torch.models.efficient_vrnet import EfficientVRNet, create_model
from asy_vrnet_tpu_torch.ops.boxes import correct_boxes, decode_predictions
from asy_vrnet_tpu_torch.ops.nms import non_max_suppression


class Detector:
    """YOLO-wrapper equivalent: detection with decode + NMS on the device.

    `model` is a built EfficientVRNet, or None to build one from
    `model_config` (and `weights`, a weights-only npz) on `device`."""

    def __init__(
        self,
        model_config: ModelConfig,
        class_names: Sequence[str],
        model: Optional[EfficientVRNet] = None,
        weights: Optional[str] = None,
        device: str | torch.device | None = None,
        conf_thres: float = 0.3,
        nms_thres: float = 0.5,
        max_det: int = 100,
        radar_norm: str = "minmax",   # parity: the detect path normalises radar
        letterbox: bool = True,
    ):
        self.cfg = model_config
        self.model = model if model is not None else create_model(
            model_config, device, weights)
        self.device = next(self.model.parameters()).device
        self.class_names = list(class_names)
        self.conf_thres = conf_thres
        self.nms_thres = nms_thres
        self.max_det = max_det
        self.radar_norm = radar_norm
        self.letterbox = letterbox

    def _prep(self, image, radar: np.ndarray):
        """PIL image + (4,H,W)|(H,W,4) radar -> batched device inputs."""
        image = cvt_color(image)
        w0, h0 = image.size
        h, w = self.cfg.input_size
        if self.letterbox:
            boxed, nw, nh = letterbox_image(image, (w, h))
        else:
            from PIL import Image

            boxed = image.resize((w, h), Image.BICUBIC)
            nw, nh = w, h
        img = normalize_image(np.asarray(boxed))[None]
        radar = np.asarray(radar, np.float32)
        if radar.ndim == 3 and radar.shape[0] == self.cfg.radar_channels:
            radar = np.transpose(radar, (1, 2, 0))
        if self.radar_norm == "minmax":
            radar = normalize_radar_minmax(radar)
        to_dev = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        return to_dev(img), to_dev(radar[None]), (h0, w0), (nh, nw)

    @torch.no_grad()
    def detect(self, image, radar: np.ndarray, conf_thres: Optional[float] = None):
        """-> dict(boxes (N,4) pixels in the original image, scores, obj,
        class_conf, classes), numpy."""
        img, rad, (h0, w0), _ = self._prep(image, radar)
        det, _ = self.model(img, rad)
        pred = decode_predictions(det, self.cfg.input_size, self.cfg.head_strides)
        out = non_max_suppression(
            pred, self.cfg.num_classes,
            conf_thres=self.conf_thres if conf_thres is None else conf_thres,
            nms_thres=self.nms_thres, max_out=self.max_det)
        out = {k: v[0].cpu().numpy() for k, v in out.items()}
        valid = out["valid"]
        boxes = correct_boxes(out["boxes_xyxy"][valid], self.cfg.input_size,
                              (h0, w0), self.letterbox)
        return {
            "boxes": boxes,
            "scores": out["scores"][valid],
            "obj": out["obj"][valid],
            "class_conf": out["class_conf"][valid],
            "classes": out["classes"][valid],
        }
