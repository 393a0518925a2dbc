"""The fused on-device inference pipeline (counterpart of
`asy_vrnet_tpu/infer/pipeline.py`; BASELINE config 3):

  uint8 camera frames + raw radar points ->
  letterbox on the device (PIL bicubic as two interpolation matmuls) ->
  ImageNet normalisation -> radar RVEP projection (+ optional min-max) ->
  EfficientVRNet forward -> box decode -> NMS (all rounds) -> seg softmax
  (the exported program's graph, `infer/export.py::ServingGraph`).

The host supplies the raw frames and points and reads back the final
(max_det) detections; nothing in between returns to the host.  The reference
does all of this on the CPU in Python per frame (yolo.py:118-149).  The JAX
package jits the whole function; here it is a function on tensors of the
model's device.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from asy_vrnet_tpu_torch.config import ModelConfig
from asy_vrnet_tpu_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD
from asy_vrnet_tpu_torch.infer.export import ServingGraph
from asy_vrnet_tpu_torch.ops.radar import project_points_to_rvep
from asy_vrnet_tpu_torch.ops.resize import resize_bicubic_pil
from asy_vrnet_tpu_torch.utils.profiling import span


@functools.lru_cache(maxsize=None)
def _imagenet(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The ImageNet mean and std on `device`, copied there once."""
    return (torch.as_tensor(IMAGENET_MEAN, device=device),
            torch.as_tensor(IMAGENET_STD, device=device))


def device_letterbox(image_u8: torch.Tensor, out_hw: tuple[int, int],
                     fill: float = 128.0) -> torch.Tensor:
    """Bicubic letterbox + /255 + ImageNet normalisation on the device:
    (B, H0, W0, 3) uint8 -> (B, h, w, 3) f32 (the JAX version takes one
    frame and is vmapped)."""
    b, h0, w0, _ = image_u8.shape
    h, w = out_hw
    scale = min(w / w0, h / h0)
    nw, nh = int(w0 * scale), int(h0 * scale)
    dx, dy = (w - nw) // 2, (h - nh) // 2
    resized = resize_bicubic_pil(image_u8.float().permute(0, 3, 1, 2), (nh, nw))
    canvas = torch.full((b, 3, h, w), fill, dtype=torch.float32, device=image_u8.device)
    canvas[:, :, dy:dy + nh, dx:dx + nw] = resized.clamp(0.0, 255.0)
    mean, std = _imagenet(image_u8.device)
    return (canvas.permute(0, 2, 3, 1) / 255.0 - mean) / std


def build_fused_pipeline(model, cfg: ModelConfig, source_hw: tuple[int, int],
                         conf_thres: float = 0.3, nms_thres: float = 0.5,
                         max_det: int = 100, radar_minmax: bool = True) -> Callable:
    """-> fn(image_u8 (B, H0, W0, 3), radar_points (B, N, 6), radar_valid
    (B, N)) -> (detections: dict of (B, max_det) tensors, seg probabilities
    (B, h, w, C)), all on the model's device.  `source_hw` is the frames'
    (H0, W0), which the letterbox's geometry follows.  Under a profiler a
    call is the span `serve`, tiled by `serve/preprocess` and the graph's
    `serve/forward` and `serve/postprocess`."""
    input_hw = cfg.input_size
    graph = ServingGraph(model, cfg, True, conf_thres, nms_thres, max_det)

    @torch.no_grad()
    def pipeline(image_u8, radar_points, radar_valid):
        with span("serve"):
            with span("serve/preprocess"):
                if tuple(image_u8.shape[1:3]) != tuple(source_hw):
                    raise ValueError(f"frames {tuple(image_u8.shape[1:3])}, expected {source_hw}")
                img = device_letterbox(image_u8, input_hw)
                radar = project_points_to_rvep(radar_points, radar_valid, input_hw)
                if radar_minmax:
                    lo = radar.amin(dim=(1, 2, 3), keepdim=True)
                    hi = radar.amax(dim=(1, 2, 3), keepdim=True)
                    radar = (radar - lo) / (hi - lo + 1e-12) + 1e-13
            return graph(img, radar)

    return pipeline
