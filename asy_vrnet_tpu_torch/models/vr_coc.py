"""Dual-stream (vision + radar) Context-Cluster backbone (counterpart of
`asy_vrnet_tpu/models/vr_coc.py`; reference backbone/fusion/vr_coc.py:303-704).

Only the literal entry is ported (`vr_coc.py:523-555`): the space-to-depth
pre-stem and lane folding are exact TPU re-layouts.  `remat` is
`ModelConfig.train_remat`: in training with autograd on, "fusion"
rematerialises every ImageEnhanceByRadar / RadarEnhanceByImage (the initial
pair included), "blocks" also each backbone ClusterBlock, "stages" instead
each stage's ClusterBlock stack (`models/remat.py`).  Parity quirks kept:
  - the radar positional-embedding concat reuses the image grid (`fea_pos`);
  - the stage-3 tap is computed but discarded;
  - taps are [after stage-1 fusion, after reducer-1, after reducer-2, after
    stage-4 fusion] at strides 4/8/16/32.
Module names follow the reference's torch state_dict (`network.{3s}` stage,
`network.{3s+1}` fusion, `network.{3s+2}` reducer; `network_radar` alike).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.nn as nn

from asy_vrnet_tpu_torch.config import CoCVariant
from asy_vrnet_tpu_torch.models import remat as rm
from asy_vrnet_tpu_torch.models.cluster_block import ClusterBlock
from asy_vrnet_tpu_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    ConvBnAct,
    ECA,
    ShuffleAttention,
    channel_shuffle,
)
from asy_vrnet_tpu_torch.parallel import collectives


def data_normal(x: torch.Tensor) -> torch.Tensor:
    """Global (whole-tensor, whole-batch) min-max to [0,1] (vr_coc.py:59-67);
    in a parallel step over the global batch (`collectives.min_max`)."""
    d_min, d_max = collectives.min_max(x)
    return (x - d_min) / (d_max - d_min)


def positional_grid(h: int, w: int) -> np.ndarray:
    """(H,W,2) coordinate grid in [-0.5, 0.5]: ch0 = row, ch1 = col
    (the `fea_pos` buffer, vr_coc.py:401-406)."""
    rows = np.arange(h, dtype=np.float32) / max(h - 1.0, 1.0) - 0.5
    cols = np.arange(w, dtype=np.float32) / max(w - 1.0, 1.0) - 0.5
    return np.stack(np.meshgrid(rows, cols, indexing="ij"), axis=-1)


class PointReducer(nn.Module):
    """Patch-embed / downsample as a strided conv with bias (vr_coc.py:83-102)."""

    def __init__(self, cin: int, cout: int, patch_size: int = 16,
                 stride: int = 16, padding: int = 0):
        super().__init__()
        self.proj = Conv2d(cin, cout, patch_size, stride, padding)

    def forward(self, x):
        return self.proj(x)


class ImageEnhanceByRadar(nn.Module):
    """radar -> 3x3 ConvBnAct -> global min-max -> (1+norm)*image -> BN
    (vr_coc.py:303-316)."""

    def __init__(self, image_channels: int, radar_channels: int):
        super().__init__()
        self.radar_projection = ConvBnAct(radar_channels, image_channels, 3, act="relu")
        self.norm = BatchNorm2d(image_channels)

    def forward(self, image, radar):
        key = self.radar_projection(radar)
        return self.norm((1.0 + data_normal(key)) * image)


class RadarEnhanceByImage(nn.Module):
    """(ShuffleAttention on image) -> concat -> shuffle(2) -> ECA -> 1x1
    inverse projection -> +radar -> BN (vr_coc.py:319-359).  `initial` (the
    pre-stem instance) has no ShuffleAttention."""

    def __init__(self, image_channels: int, radar_channels: int,
                 initial: bool = False):
        super().__init__()
        self.initial = initial
        if not initial:
            self.image_attn = ShuffleAttention(image_channels, groups=4)
        c = image_channels + radar_channels
        self.channel_attn = ECA(c)
        self.inverse_projection = ConvBnAct(c, radar_channels, 1, act="relu")
        self.norm = BatchNorm2d(radar_channels)

    def forward(self, image, radar):
        if not self.initial:
            image = self.image_attn(image)
        fused = channel_shuffle(torch.cat([image, radar], dim=1), 2)
        fused = self.inverse_projection(self.channel_attn(fused))
        return self.norm(fused + radar)


def _stage(dim: int, i: int, v: CoCVariant, fused: bool) -> nn.Sequential:
    prior, total = sum(v.layers[:i]), sum(v.layers)
    return nn.Sequential(*[
        ClusterBlock(
            dim, mlp_ratio=v.mlp_ratios[i], drop=v.drop_rate,
            # stochastic depth grows linearly over the blocks (vr_coc.py:389)
            drop_path=v.drop_path_rate * (j + prior) / max(total - 1, 1),
            layer_scale_init_value=v.layer_scale_init_value,
            proposal_w=v.proposal_w[i], proposal_h=v.proposal_h[i],
            fold_w=v.fold_w[i], fold_h=v.fold_h[i],
            heads=v.heads[i], head_dim=v.head_dim[i], fused=fused,
        )
        for j in range(v.layers[i])
    ])


class VRCoC(nn.Module):
    """forward(image, radar) NCHW -> (outs, outs_radar), each a 4-tuple of
    maps at strides 4/8/16/32."""

    def __init__(self, variant: CoCVariant, width: float = 1.0,
                 image_channels: int = 3, radar_channels: int = 4,
                 fused: bool = True, remat: str = "none"):
        super().__init__()
        v = self.variant = variant
        self.remat = remat
        dims = v.scaled_dims(width)
        if not v.use_layer_scale:
            raise NotImplementedError("variants without LayerScale are not ported")
        self.image_initial = PointReducer(image_channels, image_channels, 1, 1)
        self.radar_initial = PointReducer(radar_channels, radar_channels, 1, 1)
        self.image_enhance_by_radar1 = ImageEnhanceByRadar(image_channels, radar_channels)
        self.radar_enhance_by_image1 = RadarEnhanceByImage(
            image_channels, radar_channels, initial=True)
        self.patch_embed = PointReducer(image_channels + 2, dims[0], v.in_patch_size,
                                        v.in_stride, v.in_pad)
        self.patch_embed_radar = PointReducer(radar_channels + 2, dims[0],
                                              v.in_patch_size, v.in_stride, v.in_pad)
        net, net_r = [], []
        n = len(v.layers)
        for i in range(n):
            net.append(_stage(dims[i], i, v, fused))
            net_r.append(_stage(dims[i], i, v, fused))
            net.append(ImageEnhanceByRadar(dims[i], dims[i]))
            net_r.append(RadarEnhanceByImage(dims[i], dims[i]))
            if i < n - 1 and (v.downsamples[i] or dims[i] != dims[i + 1]):
                for lst in (net, net_r):
                    lst.append(PointReducer(dims[i], dims[i + 1], v.down_patch_size,
                                            2, v.down_pad))
        self.network = nn.ModuleList(net)
        self.network_radar = nn.ModuleList(net_r)

    def forward(self, image: torch.Tensor, radar: torch.Tensor):
        spans = (rm.spans_of(self.remat) if self.training and torch.is_grad_enabled()
                 else ())

        def fusion(mod, image, radar):
            return (rm.span(mod, [mod], image, radar) if "fusion" in spans
                    else mod(image, radar))

        def stage(seq, x):
            if "stages" in spans:
                return rm.span(partial(rm.stack, list(seq)), [seq], x)
            if "blocks" in spans:
                for blk in seq:
                    x = rm.span(partial(rm.stack, [blk]), [blk], x)
                return x
            return seq(x)

        image = self.image_initial(image)
        radar = self.radar_initial(radar)
        image = fusion(self.image_enhance_by_radar1, image, radar)
        radar = fusion(self.radar_enhance_by_image1, image, radar)

        b, _, h, w = image.shape
        pos = torch.as_tensor(positional_grid(h, w), dtype=image.dtype,
                              device=image.device).permute(2, 0, 1)[None]
        pos = pos.expand(b, 2, h, w)
        cl = torch.channels_last
        image = self.patch_embed(torch.cat([image, pos], 1).contiguous(memory_format=cl))
        # parity: the reference concatenates `fea_pos` (the image grid) to the
        # radar stream as well (vr_coc.py:585); the grids are identical.
        radar = self.patch_embed_radar(
            torch.cat([radar, pos], 1).contiguous(memory_format=cl))

        outs, outs_radar = [], []
        net, net_r = self.network, self.network_radar
        n = len(self.variant.layers)
        k = 0
        for i in range(n):
            image = stage(net[k], image)
            radar = stage(net_r[k], radar)
            # fusion: image first, radar uses the already-enhanced image
            image = fusion(net[k + 1], image, radar)
            radar = fusion(net_r[k + 1], image, radar)
            k += 2
            if i == 0 or i == n - 1:
                outs.append(image)          # stride-4 / stride-32 taps
                outs_radar.append(radar)
            # parity: the stage-3 (i == 2) post-fusion tap is discarded
            # (vr_coc.py:655-656)
            if k < len(net) and isinstance(net[k], PointReducer):
                image = net[k](image)
                radar = net_r[k](radar)
                k += 1
                if i in (0, 1):
                    outs.append(image)      # stride-8/16 taps after reducers 1,2
                    outs_radar.append(radar)
        return tuple(outs), tuple(outs_radar)
