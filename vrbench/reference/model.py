"""EfficientVRNet in plain PyTorch: the benchmark's reference forward.

A frozen copy of the port's plain module path (ASY-VRNet's `nets/efficient_vrnet.py`
with the `coc_small` dual-stream Context-Cluster backbone, the ASPP + seg decoder
+ radar det FPN neck and the YOLOX decoupled head), written for f32 and one
process: no fused kernels, no dropout, no collectives.  Module and parameter
names are the upstream repo's (and the port's), so one state_dict loads into
both.  Tensors are NCHW.

`rounding` is applied to both operands of every convolution and matrix
product and to every module's output (`lowp.py`): the identity for the
reference itself, a lower precision for the control.
`remat` recomputes each ClusterBlock and each fusion module in the backward
(BatchNorm's running stats are not updated again), so that the f32 train
step fits at the benchmark's batch.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# phi -> width, nets/efficient_vrnet.py:16-17
WIDTHS = {"nano": 0.25, "tiny": 0.375, "s": 0.50, "m": 0.75, "l": 1.00}


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


@dataclass
class Env:
    """What every module of one model shares: the rounding of operands and
    activations, and the flag that holds BatchNorm's running stats during a
    recompute."""

    rounding: object = identity
    remat: bool = False
    recomputing: bool = False


@dataclass(frozen=True)
class Variant:
    layers: tuple
    embed_dims: tuple
    mlp_ratios: tuple
    proposal: tuple
    fold: tuple
    heads: tuple
    head_dim: tuple


def variant_of(cfg: dict) -> Variant:
    """The backbone variant of a config file's `model` group."""
    v = cfg["variant"]
    if v == "coc_small":
        layers = (2, 2, 6, 2)
    elif v == "coc_dryrun":
        layers = (1, 1, 1, 1)
    else:
        raise ValueError(f"reference has no backbone variant {v!r}")
    return Variant(layers, (64, 128, 320, 512), (8, 8, 4, 4), (2, 2, 2, 2),
                   (8, 4, 2, 1), (4, 4, 8, 8), (32, 32, 32, 32))


class Conv2d(nn.Conv2d):
    def __init__(self, env: Env, *args, **kw):
        super().__init__(*args, **kw)
        self.env = env

    def forward(self, x):
        q = self.env.rounding
        return self._conv_forward(q(x), q(self.weight), self.bias)


def _bn(env: Env, x, bn: nn.BatchNorm2d):
    """BatchNorm with the biased batch variance kept in the running stats
    (flax's), as E[x^2] - E[x]^2 clipped at 0; running stats in eval."""
    shape = (1, -1, 1, 1)
    if not bn.training:
        mul = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        return (x - bn.running_mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)
    mean = x.mean(dim=(0, 2, 3))
    var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
    if not env.recomputing:
        with torch.no_grad():
            bn.running_mean.mul_(1.0 - bn.momentum).add_(mean, alpha=bn.momentum)
            bn.running_var.mul_(1.0 - bn.momentum).add_(var, alpha=bn.momentum)
    mul = bn.weight * torch.rsqrt(var + bn.eps)
    return (x - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)


class BatchNorm2d(nn.BatchNorm2d):
    def __init__(self, env: Env, c: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(c, eps=eps, momentum=momentum)
        self.env = env

    def forward(self, x):
        return _bn(self.env, x, self)


def channel_shuffle(x, groups: int = 2):
    b, c, h, w = x.shape
    if c % groups:
        return x
    return x.reshape(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)


class _DWConv(nn.Module):
    def __init__(self, env, cin, cout, k, stride):
        super().__init__()
        self.dconv = Conv2d(env, cin, cin, k, stride, (k - 1) // 2, groups=cin, bias=False)
        self.pconv = Conv2d(env, cin, cout, 1, bias=False)

    def forward(self, x):
        return self.pconv(self.dconv(x))


class ConvBnAct(nn.Module):
    """conv (bias-free) -> BatchNorm(eps 1e-3, momentum 0.03) -> act."""

    def __init__(self, env, cin, cout, k, stride=1, act="relu", ds_conv=False):
        super().__init__()
        self.env = env
        self.conv = (_DWConv(env, cin, cout, k, stride) if ds_conv
                     else Conv2d(env, cin, cout, k, stride, (k - 1) // 2, bias=False))
        self.bn = nn.BatchNorm2d(cout, eps=1e-3, momentum=0.03)
        self.act = act

    def forward(self, x):
        y = _bn(self.env, self.conv(x), self.bn)
        return F.relu(y) if self.act == "relu" else y


class GroupNorm1(nn.GroupNorm):
    def __init__(self, c: int):
        super().__init__(1, c, eps=1e-5)

    def forward(self, x):
        xf = x.reshape(x.shape[0], -1)
        mu = xf.mean(dim=1).view(-1, 1, 1, 1)
        var = (xf * xf).mean(dim=1).view(-1, 1, 1, 1) - mu * mu
        y = (x - mu) * torch.rsqrt(var + self.eps)
        return y * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)


class Mlp(nn.Module):
    def __init__(self, env, cin, hidden, cout):
        super().__init__()
        self.fc1 = Conv2d(env, cin, hidden, 1)
        self.fc2 = Conv2d(env, hidden, cout, 1)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ECA(nn.Module):
    def __init__(self, env, c: int):
        super().__init__()
        k = int(abs((math.log2(c) + 1) / 2))
        k = k if k % 2 else k + 1
        self.env = env
        self.conv = nn.Conv1d(1, 1, k, padding=(k - 1) // 2, bias=False)

    def forward(self, x):
        q = self.env.rounding
        pooled = x.mean(dim=(2, 3))
        y = F.conv1d(q(pooled[:, None, :]), q(self.conv.weight), padding=self.conv.padding)[:, 0]
        return x * torch.sigmoid(y)[:, :, None, None]


class ShuffleAttention(nn.Module):
    """Per channel: a GroupNorm-affine ("spatial") or pooled ("channel")
    sigmoid gate, then channel_shuffle(2) (shuffle_attention.py:8-72)."""

    def __init__(self, c: int, groups: int = 8):
        super().__init__()
        c2g = c // (2 * groups)
        self.cweight = nn.Parameter(torch.zeros(1, c2g, 1, 1))
        self.cbias = nn.Parameter(torch.ones(1, c2g, 1, 1))
        self.sweight = nn.Parameter(torch.zeros(1, c2g, 1, 1))
        self.sbias = nn.Parameter(torch.ones(1, c2g, 1, 1))
        self.gn = nn.GroupNorm(c2g, c2g)
        within = torch.arange(c) % (2 * c2g)
        self.register_buffer("_ci", within % c2g, persistent=False)
        self.register_buffer("_spatial", (within // c2g).bool(), persistent=False)

    def forward(self, x):
        spread = lambda p: p.reshape(-1)[self._ci].view(1, -1, 1, 1)  # noqa: E731
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = (x * x).mean(dim=(2, 3), keepdim=True) - mean * mean
        xn = (x - mean) * torch.rsqrt(var + 1e-5)
        spatial = spread(self.sweight) * (xn * spread(self.gn.weight) + spread(self.gn.bias)) \
            + spread(self.sbias)
        channel = spread(self.cweight) * mean + spread(self.cbias)
        gate = torch.where(self._spatial.view(1, -1, 1, 1), spatial, channel)
        return channel_shuffle(x * torch.sigmoid(gate), 2)


def _adaptive_avg_matrix(n_in: int, n_out: int) -> np.ndarray:
    w = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        lo, hi = (i * n_in) // n_out, -((-(i + 1) * n_in) // n_out)
        w[i, lo:hi] = 1.0 / (hi - lo)
    return w


def cluster_mix(q, feat, value, alpha, beta, heads, fold, proposal):
    """Context-cluster mixing (vr_coc.py:114-192) of NHWC feat and value:
    per region, M pooled centers; each token's cosine to them, a sigmoid
    similarity, a hard assignment to the most similar; centers aggregate
    their tokens' values and are dispatched back.  Returns NHWC."""
    b, h, w, c = feat.shape
    d = c // heads
    rh, rw = h // fold, w // fold

    def regions(t):
        t = t.reshape(b, fold, rh, fold, rw, heads, d).permute(0, 5, 1, 3, 2, 4, 6)
        return t.reshape(b, heads, fold * fold, rh * rw, d)

    x, v = regions(feat), regions(value)
    mh, mw = _adaptive_avg_matrix(rh, proposal), _adaptive_avg_matrix(rw, proposal)
    pool = torch.as_tensor((mh[:, None, :, None] * mw[None, :, None, :])
                           .reshape(proposal * proposal, rh * rw), device=feat.device)
    centers = torch.einsum("mn,bhrnd->bhrmd", q(pool), q(x))
    v_centers = torch.einsum("mn,bhrnd->bhrmd", q(pool), q(v))
    unit = lambda t: t * torch.rsqrt((t * t).sum(-1, keepdim=True) + 1e-12)  # noqa: E731
    cos = torch.einsum("bhrmd,bhrnd->bhrmn", q(unit(centers)), q(unit(x)))
    sim = torch.sigmoid(beta + alpha * cos)
    assign = sim.argmax(dim=-2)
    mask = F.one_hot(assign, sim.shape[-2]).movedim(-1, -2).to(sim.dtype)
    sim = sim * mask
    agg = torch.einsum("bhrmn,bhrnd->bhrmd", q(sim), q(v))
    out_c = (agg + v_centers) / (mask.sum(-1, keepdim=True) + 1.0)
    out = torch.einsum("bhrmn,bhrmd->bhrnd", q(sim), q(out_c))
    out = out.reshape(b, heads, fold, fold, rh, rw, d).permute(0, 2, 4, 3, 5, 1, 6)
    return out.reshape(b, h, w, c)


class Cluster(nn.Module):
    def __init__(self, env, dim, proposal, fold, heads, head_dim):
        super().__init__()
        inner = heads * head_dim
        self.env, self.heads, self.fold, self.proposal = env, heads, fold, proposal
        self.fc1 = Conv2d(env, dim, inner, 1)
        self.fc2 = Conv2d(env, inner, dim, 1)
        self.fc_v = Conv2d(env, dim, inner, 1)
        self.sim_alpha = nn.Parameter(torch.ones(1))
        self.sim_beta = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        out = cluster_mix(self.env.rounding, nhwc(self.fc1(x)), nhwc(self.fc_v(x)),
                          self.sim_alpha, self.sim_beta, self.heads, self.fold, self.proposal)
        return self.fc2(out.permute(0, 3, 1, 2))


class ClusterBlock(nn.Module):
    """x + ls1 * Cluster(GN(x)); then + ls2 * Mlp(GN(.)) (vr_coc.py:226-275)."""

    def __init__(self, env, dim, mlp_ratio, proposal, fold, heads, head_dim):
        super().__init__()
        self.env = env
        self.norm1 = GroupNorm1(dim)
        self.token_mixer = Cluster(env, dim, proposal, fold, heads, head_dim)
        self.norm2 = GroupNorm1(dim)
        self.mlp = Mlp(env, dim, int(dim * mlp_ratio), dim)
        self.layer_scale_1 = nn.Parameter(1e-5 * torch.ones(dim))
        self.layer_scale_2 = nn.Parameter(1e-5 * torch.ones(dim))

    def _forward(self, x):
        x = x + self.token_mixer(self.norm1(x)) * self.layer_scale_1.view(1, -1, 1, 1)
        return x + self.mlp(self.norm2(x)) * self.layer_scale_2.view(1, -1, 1, 1)

    def forward(self, x):
        return _maybe_remat(self.env, self._forward, x)


@contextlib.contextmanager
def _recomputing(env: Env):
    env.recomputing = True
    try:
        yield
    finally:
        env.recomputing = False


def _maybe_remat(env: Env, fn, *args):
    if not (env.remat and torch.is_grad_enabled()):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), _recomputing(env)))


class PointReducer(nn.Module):
    def __init__(self, env, cin, cout, k, stride, pad):
        super().__init__()
        self.proj = Conv2d(env, cin, cout, k, stride, pad)

    def forward(self, x):
        return self.proj(x)


class ImageEnhanceByRadar(nn.Module):
    def __init__(self, env, ci, cr):
        super().__init__()
        self.env = env
        self.radar_projection = ConvBnAct(env, cr, ci, 3)
        self.norm = BatchNorm2d(env, ci)

    def _forward(self, image, radar):
        key = self.radar_projection(radar)
        lo, hi = key.min(), key.max()
        return self.norm((1.0 + (key - lo) / (hi - lo)) * image)

    def forward(self, image, radar):
        return _maybe_remat(self.env, self._forward, image, radar)


class RadarEnhanceByImage(nn.Module):
    def __init__(self, env, ci, cr, initial=False):
        super().__init__()
        self.env, self.initial = env, initial
        if not initial:
            self.image_attn = ShuffleAttention(ci, groups=4)
        self.channel_attn = ECA(env, ci + cr)
        self.inverse_projection = ConvBnAct(env, ci + cr, cr, 1)
        self.norm = BatchNorm2d(env, cr)

    def _forward(self, image, radar):
        if not self.initial:
            image = self.image_attn(image)
        fused = channel_shuffle(torch.cat([image, radar], 1), 2)
        return self.norm(self.inverse_projection(self.channel_attn(fused)) + radar)

    def forward(self, image, radar):
        return _maybe_remat(self.env, self._forward, image, radar)


class VRCoC(nn.Module):
    """The dual-stream backbone: taps at strides 4/8/16/32 of each stream."""

    def __init__(self, env, v: Variant, width: float):
        super().__init__()
        self.v = v
        dims = [int(d * width) for d in v.embed_dims]
        self.image_initial = PointReducer(env, 3, 3, 1, 1, 0)
        self.radar_initial = PointReducer(env, 4, 4, 1, 1, 0)
        self.image_enhance_by_radar1 = ImageEnhanceByRadar(env, 3, 4)
        self.radar_enhance_by_image1 = RadarEnhanceByImage(env, 3, 4, initial=True)
        self.patch_embed = PointReducer(env, 5, dims[0], 4, 4, 0)
        self.patch_embed_radar = PointReducer(env, 6, dims[0], 4, 4, 0)
        net, net_r = [], []
        for i in range(4):
            for lst in (net, net_r):
                lst.append(nn.Sequential(*[
                    ClusterBlock(env, dims[i], v.mlp_ratios[i], v.proposal[i], v.fold[i],
                                 v.heads[i], v.head_dim[i]) for _ in range(v.layers[i])]))
            net.append(ImageEnhanceByRadar(env, dims[i], dims[i]))
            net_r.append(RadarEnhanceByImage(env, dims[i], dims[i]))
            if i < 3:
                for lst in (net, net_r):
                    lst.append(PointReducer(env, dims[i], dims[i + 1], 3, 2, 1))
        self.network = nn.ModuleList(net)
        self.network_radar = nn.ModuleList(net_r)

    def forward(self, image, radar):
        image = self.image_initial(image)
        radar = self.radar_initial(radar)
        image = self.image_enhance_by_radar1(image, radar)
        radar = self.radar_enhance_by_image1(image, radar)
        b, _, h, w = image.shape
        rows = torch.arange(h, dtype=image.dtype, device=image.device) / max(h - 1.0, 1.0) - 0.5
        cols = torch.arange(w, dtype=image.dtype, device=image.device) / max(w - 1.0, 1.0) - 0.5
        pos = torch.stack(torch.meshgrid(rows, cols, indexing="ij"))[None].expand(b, 2, h, w)
        # the upstream concatenates the image grid to the radar stream too
        image = self.patch_embed(torch.cat([image, pos], 1))
        radar = self.patch_embed_radar(torch.cat([radar, pos], 1))
        outs, outs_r, k = [], [], 0
        for i in range(4):
            image = self.network[k](image)
            radar = self.network_radar[k](radar)
            image = self.network[k + 1](image, radar)
            radar = self.network_radar[k + 1](image, radar)
            k += 2
            if i in (0, 3):
                outs.append(image)
                outs_r.append(radar)
            if i < 3:
                image, radar = self.network[k](image), self.network_radar[k](radar)
                k += 1
                if i in (0, 1):
                    outs.append(image)
                    outs_r.append(radar)
        return outs, outs_r


def _up(x, scale):
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(h * scale, w * scale), mode="bilinear", align_corners=True)


class _Upsample(nn.Module):
    def __init__(self, scale):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return _up(x, self.scale)


class CoCUpsample(nn.Module):
    def __init__(self, env, cin, cout, scale=2, act="relu"):
        super().__init__()
        self.upsample = nn.Sequential(ConvBnAct(env, cin, cout, 1, act=act), _Upsample(scale))

    def forward(self, x):
        return self.upsample(x)


class CoCConv(nn.Module):
    def __init__(self, env, cin, cout):
        super().__init__()
        self.coc = ClusterBlock(env, cin, 4.0, 2, 2, 4, 24)
        self.conv_att = ConvBnAct(env, cin, cout, 1)

    def forward(self, x):
        return self.conv_att(self.coc(x))


class ASPP(nn.Module):
    def __init__(self, env, cin, cout):
        super().__init__()

        def branch(k, d):
            return nn.Sequential(Conv2d(env, cin, cout, k, padding=0 if k == 1 else d,
                                        dilation=d), BatchNorm2d(env, cout))

        self.branch1, self.branch2 = branch(1, 1), branch(3, 6)
        self.branch3, self.branch4 = branch(3, 12), branch(3, 18)
        self.branch5_conv = Conv2d(env, cin, cout, 1)
        self.branch5_bn = BatchNorm2d(env, cout)
        self.conv_cat = nn.Sequential(Conv2d(env, cout * 5, cout, 1), BatchNorm2d(env, cout))

    def forward(self, x):
        h, w = x.shape[-2:]
        bs = [F.relu(br(x)) for br in (self.branch1, self.branch2, self.branch3, self.branch4)]
        g = F.relu(self.branch5_bn(self.branch5_conv(x.mean(dim=(2, 3), keepdim=True))))
        bs.append(g.expand(-1, -1, h, w))
        return F.relu(self.conv_cat(torch.cat(bs, 1)))


class CoCFpnDual(nn.Module):
    def __init__(self, env, v: Variant, width: float, num_seg: int, signed_logits: bool):
        super().__init__()
        c2, c3, c4, c5 = (int(d * width) for d in v.embed_dims)
        self.backbone = VRCoC(env, v, width)
        self.aspp = ASPP(env, c5, c5)
        self.upsample5_4 = CoCUpsample(env, c5, c4)
        self.sc_attn_seg4 = ShuffleAttention(2 * c4)
        self.upsample4_3 = CoCUpsample(env, 2 * c4, c3)
        self.sc_attn_seg3 = ShuffleAttention(2 * c3)
        self.upsample3_2 = CoCUpsample(env, 2 * c3, c2)
        self.sc_attn_seg2 = ShuffleAttention(2 * c2)
        self.upsample2_0 = CoCUpsample(env, 2 * c2, num_seg, 4,
                                       act="none" if signed_logits else "relu")
        self.p5_out_det = CoCConv(env, c5, c5)
        self.p5_4_det = CoCUpsample(env, c5, c4)
        self.p4_out_det = CoCConv(env, 2 * c4, c4)
        self.p4_3_det = CoCUpsample(env, c4, c3)
        self.p3_out_det = CoCConv(env, 2 * c3, c3)

    def forward(self, image, radar):
        (x2, x3, x4, x5), (_, r3, r4, r5) = self.backbone(image, radar)
        x5 = self.aspp(x5)
        y = self.sc_attn_seg4(channel_shuffle(torch.cat([x4, self.upsample5_4(x5)], 1)))
        y = self.sc_attn_seg3(channel_shuffle(torch.cat([self.upsample4_3(y), x3], 1)))
        y = self.sc_attn_seg2(channel_shuffle(torch.cat([self.upsample3_2(y), x2], 1)))
        seg = self.upsample2_0(y)
        p5 = self.p5_out_det(r5)
        p4 = self.p4_out_det(torch.cat([r4, self.p5_4_det(p5)], 1))
        p3 = self.p3_out_det(torch.cat([r3, self.p4_3_det(p4)], 1))
        return (p3, p4, p5), seg


class DecoupleHead(nn.Module):
    def __init__(self, env, num_classes, in_channels, width, hidden=256):
        super().__init__()
        mid = int(hidden * width)
        tower = lambda: nn.Sequential(ConvBnAct(env, mid, mid, 3, ds_conv=True),  # noqa: E731
                                      ConvBnAct(env, mid, mid, 3, ds_conv=True))
        self.stems = nn.ModuleList(ConvBnAct(env, c, mid, 1) for c in in_channels)
        self.cls_convs = nn.ModuleList(tower() for _ in in_channels)
        self.reg_convs = nn.ModuleList(tower() for _ in in_channels)
        self.cls_preds = nn.ModuleList(Conv2d(env, mid, num_classes, 1) for _ in in_channels)
        self.reg_preds = nn.ModuleList(Conv2d(env, mid, 4, 1) for _ in in_channels)
        self.obj_preds = nn.ModuleList(Conv2d(env, mid, 1, 1) for _ in in_channels)

    def forward(self, inputs):
        outs = []
        for k, x in enumerate(inputs):
            x = self.stems[k](x)
            cls_out = self.cls_preds[k](self.cls_convs[k](x))
            reg = self.reg_convs[k](x)
            outs.append(torch.cat([self.reg_preds[k](reg), self.obj_preds[k](reg), cls_out], 1))
        return outs


def _round_out(q, out):
    if isinstance(out, torch.Tensor):
        return q(out)
    if isinstance(out, (list, tuple)):
        return type(out)(_round_out(q, o) for o in out)
    return out


class EfficientVRNet(nn.Module):
    """forward(image NHWC (B,H,W,3), radar NHWC (B,H,W,4)) -> (three NHWC
    det maps (B,H/s,W/s,5+C) for s = 8, 16, 32; NHWC seg logits (B,H,W,S))."""

    def __init__(self, model_cfg: dict, env: Env | None = None):
        super().__init__()
        self.env = env = env or Env()
        width = WIDTHS[model_cfg["phi"]]
        v = variant_of(model_cfg)
        c3, c4, c5 = (int(d * width) for d in v.embed_dims[1:])
        self.backbone = CoCFpnDual(env, v, width, model_cfg["num_seg_classes"],
                                   model_cfg["seg_signed_logits"])
        self.head = DecoupleHead(env, model_cfg["num_classes"], (c3, c4, c5), width,
                                 model_cfg["head_width"])
        if env.rounding is not identity:
            for m in self.modules():
                if m is not self:
                    m.register_forward_hook(lambda m, i, o: _round_out(env.rounding, o))

    def forward(self, image, radar):
        nchw = lambda t: t.float().permute(0, 3, 1, 2)  # noqa: E731
        det, seg = self.backbone(nchw(image), nchw(radar))
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        return [nhwc(o) for o in self.head(det)], nhwc(seg)
