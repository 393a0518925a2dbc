"""Model export for serving (counterpart of `asy_vrnet_tpu/infer/export.py`;
the capability the reference's broken convert_to_onnx covers, yolo.py:
353-389 / deeplab.py:279-315, which export an image-only dummy input and
fail on the dual-input model).

`torch.export` of the inference graph with BOTH inputs, f32 NHWC, saved as
a `.pt2` program: the forward, or the forward with decode, NMS (all
`max_det` rounds, no host read) and the seg softmax.  On the card the graph
holds the two serving kernels as the operators `asy_vrnet::mixer_block` and
`asy_vrnet::mlp_block` (`ops/custom_ops.py`), one each per ClusterBlock; on
the CPU it traces the plain PyTorch path.
"""
from __future__ import annotations

import os
from typing import Callable

import torch
import torch.nn as nn

import asy_vrnet_tpu_torch.ops.custom_ops  # noqa: F401  (registers asy_vrnet::*)
from asy_vrnet_tpu_torch.config import ModelConfig
from asy_vrnet_tpu_torch.ops.boxes import decode_predictions
from asy_vrnet_tpu_torch.ops.nms import non_max_suppression
from asy_vrnet_tpu_torch.utils.profiling import span


class ServingGraph(nn.Module):
    """model(image, radar) -> (det maps, seg) or, with `with_postprocess`,
    (NMS dict of (B, max_det) tensors, seg softmax over classes).  Under a
    profiler the two parts are the spans `serve/forward` and
    `serve/postprocess` (`utils/profiling.py::span`)."""

    def __init__(self, model: nn.Module, cfg: ModelConfig, with_postprocess: bool = True,
                 conf_thres: float = 0.3, nms_thres: float = 0.5, max_det: int = 100):
        super().__init__()
        self.model, self.cfg = model, cfg
        self.with_postprocess = with_postprocess
        self.conf_thres, self.nms_thres, self.max_det = conf_thres, nms_thres, max_det

    def forward(self, image: torch.Tensor, radar: torch.Tensor):
        with span("serve/forward"):
            det, seg = self.model(image, radar)
        if not self.with_postprocess:
            return det, seg
        with span("serve/postprocess"):
            out = decode_and_nms(det, self.cfg, self.conf_thres, self.nms_thres, self.max_det,
                                 fixed_rounds=True)
            return out, torch.softmax(seg, dim=-1)


def decode_and_nms(det, cfg: ModelConfig, conf_thres: float, nms_thres: float,
                   max_det: int, fixed_rounds: bool) -> dict:
    """The detection head's maps -> NMS dict of (B, max_det) tensors, on
    their device.  `fixed_rounds` runs all `max_det` rounds without reading
    a flag back to the host (a traced graph); the eager path stops early."""
    pred = decode_predictions(det, cfg.input_size, cfg.head_strides)
    return non_max_suppression(pred, cfg.num_classes, conf_thres=conf_thres,
                               nms_thres=nms_thres, max_out=max_det, fixed_rounds=fixed_rounds)


def export_program(model: nn.Module, cfg: ModelConfig, path: str, batch_size: int = 1,
                   with_postprocess: bool = True, conf_thres: float = 0.3,
                   nms_thres: float = 0.5, max_det: int = 100) -> str:
    """Trace the inference graph on the model's device with `torch.export`
    and save it to `path` (.pt2); returns the path."""
    dev = next(model.parameters()).device
    h, w = cfg.input_size
    image = torch.zeros((batch_size, h, w, cfg.image_channels), dtype=torch.float32, device=dev)
    radar = torch.zeros((batch_size, h, w, cfg.radar_channels), dtype=torch.float32, device=dev)
    graph = ServingGraph(model.eval(), cfg, with_postprocess, conf_thres, nms_thres, max_det)
    with torch.no_grad():
        program = torch.export.export(graph, (image, radar))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    return path


def load_exported(path: str) -> Callable:
    """Load a saved program; returns a callable(image, radar) that runs it
    without autograd.  Its `module` is the loaded graph module."""
    module = torch.export.load(path).module()

    def run(image, radar):
        with torch.no_grad():
            return module(image, radar)

    run.module = module
    return run
