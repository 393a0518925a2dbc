"""EfficientVRNet assembly (counterpart of
`asy_vrnet_tpu/models/efficient_vrnet.py`; reference nets/efficient_vrnet.py).

forward(image NHWC [B,H,W,3], radar NHWC [B,H,W,4]) ->
    (det: 3-tuple of NHWC f32 [B,H/s,W/s,5+C] for s in (8,16,32),
     seg: NHWC f32 [B,H,W,num_seg_classes])

Inside, tensors are NCHW in `torch.channels_last` memory, so the NHWC inputs
and outputs are views, and the ClusterBlock kernels read NHWC tokens without
copies.  Parameters are f32; `ModelConfig.compute_dtype` sets the activation
dtype.  Inference only.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from asy_vrnet_tpu_torch.config import ModelConfig
from asy_vrnet_tpu_torch.models.head import DecoupleHead
from asy_vrnet_tpu_torch.models.neck import CoCFpnDual
from asy_vrnet_tpu_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class EfficientVRNet(nn.Module):
    """The model, built on `device` (default: the card; raises without one)."""

    def __init__(self, config: ModelConfig, device: str | torch.device | None = None):
        super().__init__()
        self.config = cfg = config
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        c2, c3, c4, c5 = cfg.coc.scaled_dims(cfg.width)
        self.backbone = CoCFpnDual(
            cfg.coc, cfg.num_seg_classes, cfg.width, cfg.image_channels,
            cfg.radar_channels, fused=cfg.use_pallas_cluster,
            seg_signed_logits=cfg.seg_signed_logits,
        )
        self.head = DecoupleHead(cfg.num_classes, (c3, c4, c5), cfg.width,
                                 hidden=cfg.head_width)
        self.to(resolve_device(device))

    def forward(self, image: torch.Tensor, radar: torch.Tensor):
        if self.training:
            raise NotImplementedError("the port runs inference only; call .eval()")
        dt = self.compute_dtype
        # NHWC -> NCHW view with channels_last strides (no copy when contiguous)
        image = image.to(dt).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        radar = radar.to(dt).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        fpn_outs, seg = self.backbone(image, radar)
        det = self.head(fpn_outs)
        nhwc = lambda t: t.permute(0, 2, 3, 1).float()  # noqa: E731
        return tuple(nhwc(o) for o in det), nhwc(seg)


def create_model(cfg: ModelConfig, device: str | torch.device | None = None,
                 weights: str | None = None) -> EfficientVRNet:
    """Build the model on `device` (default: the card; raises without one)
    in eval mode, optionally loading a weights-only npz."""
    model = EfficientVRNet(cfg, device)
    if weights is not None:
        from asy_vrnet_tpu_torch.utils.weights import load_npz_into

        load_npz_into(model, weights)
    return model.eval()
