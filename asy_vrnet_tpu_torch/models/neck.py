"""Dual-branch neck: ASPP + segmentation decoder on the image stream, and a
radar-stream detection FPN (counterpart of `asy_vrnet_tpu/models/neck.py`;
reference neck/coc_fpn_dual.py:15-224).

Parity notes kept: the seg branch consumes the 4 image taps, the det FPN the
3 deepest radar taps; concat order is skip-first at seg4 and upsample-first
at seg3/seg2; the final seg projection is a ConvBnAct, so seg "logits" are
post-ReLU unless `seg_signed_logits`.  `SpatialPyramidPooling` is unused by
the live path, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from asy_vrnet_tpu_torch.config import CoCVariant
from asy_vrnet_tpu_torch.models.cluster_block import ClusterBlock
from asy_vrnet_tpu_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    ConvBnAct,
    ShuffleAttention,
    channel_shuffle,
)
from asy_vrnet_tpu_torch.models.vr_coc import VRCoC
from asy_vrnet_tpu_torch.ops.resize import global_avg_pool, resize_bilinear, upsample2x


class _Upsample(nn.Module):
    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return upsample2x(x, self.scale)


class CoCUpsample(nn.Module):
    """1x1 ConvBnAct then bilinear x-scale upsample (coc_fpn_dual.py:15-26)."""

    def __init__(self, cin: int, cout: int, scale: int = 2, act: str = "relu"):
        super().__init__()
        self.upsample = nn.Sequential(ConvBnAct(cin, cout, 1, act=act), _Upsample(scale))

    def forward(self, x):
        return self.upsample(x)


class CoCConv(nn.Module):
    """ClusterBlock (library defaults: fold 2x2, 4 heads x 24) + 1x1
    ConvBnAct (coc_fpn_dual.py:29-39)."""

    def __init__(self, cin: int, cout: int, fused: bool = True):
        super().__init__()
        self.coc = ClusterBlock(cin, mlp_ratio=4.0, proposal_w=2, proposal_h=2,
                                fold_w=2, fold_h=2, heads=4, head_dim=24, fused=fused)
        self.conv_att = ConvBnAct(cin, cout, 1, act="relu")

    def forward(self, x):
        return self.conv_att(self.coc(x))


class ASPP(nn.Module):
    """1x1, three dilated 3x3 (d6/d12/d18) and a global-pool branch; concat +
    1x1 (coc_fpn_dual.py:46-104)."""

    def __init__(self, cin: int, cout: int, rate: int = 1):
        super().__init__()

        def branch(k, d):
            return nn.Sequential(
                Conv2d(cin, cout, k, padding=0 if k == 1 else d, dilation=d),
                BatchNorm2d(cout),
            )

        self.branch1 = branch(1, rate)
        self.branch2 = branch(3, 6 * rate)
        self.branch3 = branch(3, 12 * rate)
        self.branch4 = branch(3, 18 * rate)
        self.branch5_conv = Conv2d(cin, cout, 1)
        self.branch5_bn = BatchNorm2d(cout)
        self.conv_cat = nn.Sequential(Conv2d(cout * 5, cout, 1), BatchNorm2d(cout))

    def forward(self, x):
        h, w = x.shape[-2:]
        bs = [F.relu(br(x)) for br in (self.branch1, self.branch2,
                                       self.branch3, self.branch4)]
        g = F.relu(self.branch5_bn(self.branch5_conv(global_avg_pool(x))))
        bs.append(resize_bilinear(g, (h, w), align_corners=True).expand(-1, -1, h, w))
        cat = torch.cat(bs, dim=1).contiguous(memory_format=torch.channels_last)
        return F.relu(self.conv_cat(cat))


class SpatialPyramidPooling(nn.Module):
    """SPP with stride-1 max pools (coc_fpn_dual.py:107-117; unused by the
    live path but part of the component inventory).  NCHW: the pools in
    reversed size order, then x, concatenated on channels.  `max_pool2d`
    pads with -inf, as flax's `max_pool` does."""

    def __init__(self, pool_sizes: tuple[int, ...] = (5, 9, 13)):
        super().__init__()
        self.pool_sizes = tuple(pool_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [F.max_pool2d(x, ps, stride=1, padding=ps // 2)
                 for ps in self.pool_sizes[::-1]]
        return torch.cat(feats + [x], dim=1)


def _cat(*xs):
    return torch.cat(xs, dim=1).contiguous(memory_format=torch.channels_last)


class CoCFpnDual(nn.Module):
    """Backbone + ASPP + seg decoder + radar det FPN (coc_fpn_dual.py:133-224).
    forward(image, radar) -> ((p3, p4, p5), seg_logits), NCHW."""

    def __init__(self, variant: CoCVariant, num_seg_classes: int = 9,
                 width: float = 1.0, image_channels: int = 3,
                 radar_channels: int = 4, fused: bool = True,
                 seg_signed_logits: bool = False, remat: str = "none"):
        super().__init__()
        c2, c3, c4, c5 = variant.scaled_dims(width)
        # remat reaches the backbone only, as in the JAX package (neck.py:160-166)
        self.backbone = VRCoC(variant, width, image_channels, radar_channels, fused, remat)
        self.aspp = ASPP(c5, c5)
        self.upsample5_4 = CoCUpsample(c5, c4)
        self.sc_attn_seg4 = ShuffleAttention(2 * c4, groups=8)
        self.upsample4_3 = CoCUpsample(2 * c4, c3)
        self.sc_attn_seg3 = ShuffleAttention(2 * c3, groups=8)
        self.upsample3_2 = CoCUpsample(2 * c3, c2)
        self.sc_attn_seg2 = ShuffleAttention(2 * c2, groups=8)
        # parity: post-ReLU seg "logits" unless seg_signed_logits
        self.upsample2_0 = CoCUpsample(2 * c2, num_seg_classes, scale=4,
                                       act="none" if seg_signed_logits else "relu")
        self.p5_out_det = CoCConv(c5, c5, fused)
        self.p5_4_det = CoCUpsample(c5, c4)
        self.p4_out_det = CoCConv(2 * c4, c4, fused)
        self.p4_3_det = CoCUpsample(c4, c3)
        self.p3_out_det = CoCConv(2 * c3, c3, fused)

    def forward(self, image, radar):
        outs, outs_radar = self.backbone(image, radar)
        x_s2, x_s3, x_s4, x_s5 = outs
        _, r_s3, r_s4, r_s5 = outs_radar

        x_s5 = self.aspp(x_s5)
        # segmentation branch (image taps)
        y = _cat(x_s4, self.upsample5_4(x_s5))                      # skip first
        y = self.sc_attn_seg4(channel_shuffle(y))
        y = _cat(self.upsample4_3(y), x_s3)                         # upsample first
        y = self.sc_attn_seg3(channel_shuffle(y))
        y = _cat(self.upsample3_2(y), x_s2)                         # upsample first
        y = self.sc_attn_seg2(channel_shuffle(y))
        seg = self.upsample2_0(y)

        # detection branch (radar taps)
        p5 = self.p5_out_det(r_s5)
        p4 = self.p4_out_det(_cat(r_s4, self.p5_4_det(p5)))
        p3 = self.p3_out_det(_cat(r_s3, self.p4_3_det(p4)))
        return (p3, p4, p5), seg
