"""YOLOX-style decoupled anchor-free detection head (counterpart of
`asy_vrnet_tpu/models/head.py`; reference head/decouplehead.py:7-88).

Per scale: 1x1 stem -> two towers of 2x depthwise-separable 3x3 ConvBnAct
-> 1x1 prediction convs; output is the channel concat [reg(4), obj(1),
cls(C)].  Parity: the towers are ds_conv whatever the reference's
`depthwise` flag says (decouplehead.py:24-33).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from asy_vrnet_tpu_torch.models.layers import Conv2d, ConvBnAct


class DecoupleHead(nn.Module):
    def __init__(self, num_classes: int, in_channels: Sequence[int],
                 width: float = 1.0, act: str = "relu", hidden: int = 256):
        super().__init__()
        mid = int(hidden * width)
        tower = lambda: nn.Sequential(  # noqa: E731
            ConvBnAct(mid, mid, 3, act=act, ds_conv=True),
            ConvBnAct(mid, mid, 3, act=act, ds_conv=True),
        )
        self.stems = nn.ModuleList(ConvBnAct(c, mid, 1, act=act) for c in in_channels)
        self.cls_convs = nn.ModuleList(tower() for _ in in_channels)
        self.reg_convs = nn.ModuleList(tower() for _ in in_channels)
        self.cls_preds = nn.ModuleList(Conv2d(mid, num_classes, 1) for _ in in_channels)
        self.reg_preds = nn.ModuleList(Conv2d(mid, 4, 1) for _ in in_channels)
        self.obj_preds = nn.ModuleList(Conv2d(mid, 1, 1) for _ in in_channels)

    def forward(self, inputs):
        outputs = []
        for k, x in enumerate(inputs):
            x = self.stems[k](x)
            cls_out = self.cls_preds[k](self.cls_convs[k](x))
            reg_feat = self.reg_convs[k](x)
            outputs.append(torch.cat(
                [self.reg_preds[k](reg_feat), self.obj_preds[k](reg_feat), cls_out],
                dim=1))
        return tuple(outputs)
