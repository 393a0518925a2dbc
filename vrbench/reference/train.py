"""The reference train step in plain PyTorch: forward in train mode, the
YOLOX loss with SimOTA assignment (nets/yolo_training.py:60-427), the focal
+ dice seg loss (nets/deeplabv3_training.py:9-59), det + 5 * seg
(utils/utils_fit.py:106), the backward, SGD with Nesterov momentum and
weight decay on conv kernels only (train.py:448-478), and the ramped EMA of
parameters and BatchNorm stats (yolo_training.py:449-475).

Batch layout: image (B,H,W,3) uint8, radar (B,H,W,4) f32, gt_boxes (B,G,4)
cxcywh pixels, gt_classes (B,G) int, gt_valid (B,G) bool, seg_target
(B,H,W) int with ignore == num_seg_classes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_VECTOR_LEAVES = ("cweight", "cbias", "sweight", "sbias")


def normalize_image(image_u8: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, device=image_u8.device)
    std = torch.tensor(IMAGENET_STD, device=image_u8.device)
    return (image_u8.float() / 255.0 - mean) / std


# ---------------------------------------------------------------- detection

def _grids(level_hw, strides, device):
    gs, ss = [], []
    for (h, w), s in zip(level_hw, strides):
        ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                                indexing="ij")
        gs.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).float())
        ss.append(torch.full((h * w,), float(s), device=device))
    return torch.cat(gs), torch.cat(ss)


def flatten(det):
    return torch.cat([o.reshape(o.shape[0], -1, o.shape[-1]) for o in det], 1)


def simota_one(boxes, cls_logits, obj_logits, gt, gt_cls, gt_valid, grid, stride,
               radius=2.5, k=10):
    """SimOTA for one image over all anchors -> (fg (A,) bool, matched (A,)
    int64, pred_iou (A,)): candidates in the GT box or its centre radius;
    cost = cls BCE + 3 * -log IoU (+1e5 outside box and centre); dynamic k
    from the top-k IoUs; an anchor claimed twice keeps its cheapest GT."""
    a, g = boxes.shape[0], gt.shape[0]
    cx = ((grid[:, 0] + 0.5) * stride)[None]
    cy = ((grid[:, 1] + 0.5) * stride)[None]
    gcx, gcy, gw, gh = (gt[:, i:i + 1] for i in range(4))
    v = gt_valid[:, None]
    in_box = (cx > gcx - gw / 2) & (cx < gcx + gw / 2) & (cy > gcy - gh / 2) & (cy < gcy + gh / 2) & v
    r = radius * stride[None]
    in_ctr = (cx > gcx - r) & (cx < gcx + r) & (cy > gcy - r) & (cy < gcy + r) & v
    pre = (in_box | in_ctr).any(0)
    px, py, pw, ph = (boxes[None, :, i] for i in range(4))
    iw = (torch.minimum(gcx + gw / 2, px + pw / 2) - torch.maximum(gcx - gw / 2, px - pw / 2)).clamp_min(0)
    ih = (torch.minimum(gcy + gh / 2, py + ph / 2) - torch.maximum(gcy - gh / 2, py - ph / 2)).clamp_min(0)
    inter = iw * ih
    ious = torch.where(v, inter / (gw * gh + pw * ph - inter).clamp_min(1e-12), 0.0)
    p = torch.sqrt(torch.sigmoid(cls_logits) * torch.sigmoid(obj_logits)[:, None])  # (A, C)
    logp, log1mp = torch.log(p).clamp_min(-100), torch.log1p(-p).clamp_min(-100)
    onehot = F.one_hot(gt_cls.long().clamp_min(0), cls_logits.shape[1]).float()  # (G, C)
    cls_cost = -(onehot @ logp.T + (1 - onehot) @ log1mp.T)
    invalid = (~pre)[None] | (~gt_valid)[:, None]
    cost = cls_cost + 3.0 * -torch.log(ious + 1e-8) + 1e5 * (~(in_box & in_ctr)).float() \
        + 1e9 * invalid.float()
    kk = min(k, a)
    top = torch.topk(torch.where(pre[None], ious, 0.0), kk, dim=1).values
    dyn = top.sum(1).to(torch.int64).clamp(1, kk)
    order = torch.sort(cost, dim=1, stable=True)
    take = (torch.arange(kk, device=cost.device)[None] < dyn[:, None]) & (order.values[:, :kk] < 5e8)
    matching = torch.zeros_like(cost)
    matching.scatter_(1, order.indices[:, :kk], take.float())
    conflict = matching.sum(0) > 1
    best = torch.argmin(cost, 0)
    resolved = (torch.arange(g, device=cost.device)[:, None] == best[None]).float()
    matching = torch.where(conflict[None], resolved, matching)
    fg = matching.sum(0) > 0
    return fg, torch.argmax(matching, 0), (matching * ious).sum(0)


def _bce(x, t):
    return x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))


def yolox_loss(det, gt_boxes, gt_classes, gt_valid, strides=(8, 16, 32), num_classes=4):
    """(1 * IoU^2 loss + 2 * obj BCE + 2 * cls BCE) / num_fg."""
    level_hw = [(o.shape[1], o.shape[2]) for o in det]
    out = flatten(det)
    grid, stride = _grids(level_hw, strides, out.device)
    xy = (out[..., :2] + grid) * stride[None, :, None]
    wh = torch.exp(out[..., 2:4]) * stride[None, :, None]
    boxes, obj, cls = torch.cat([xy, wh], -1), out[..., 4], out[..., 5:]
    gtb = gt_boxes.float()
    with torch.no_grad():
        per = [simota_one(boxes[i], cls[i], obj[i], gtb[i], gt_classes[i], gt_valid[i].bool(),
                          grid, stride) for i in range(out.shape[0])]
    fg = torch.stack([p[0] for p in per]).float()
    matched = torch.stack([p[1] for p in per])
    piou = torch.stack([p[2] for p in per])
    num_fg = fg.sum().clamp_min(1.0)
    mb = gtb.gather(1, matched[..., None].expand(-1, -1, 4))
    tl = torch.maximum(boxes[..., :2] - boxes[..., 2:] / 2, mb[..., :2] - mb[..., 2:] / 2)
    br = torch.minimum(boxes[..., :2] + boxes[..., 2:] / 2, mb[..., :2] + mb[..., 2:] / 2)
    inter = (br - tl).prod(-1) * (tl < br).all(-1).float()
    iou = inter / (boxes[..., 2:].prod(-1) + mb[..., 2:].prod(-1) - inter + 1e-16)
    loss_iou = ((1 - iou ** 2) * fg).sum()
    loss_obj = _bce(obj, fg).sum()
    mcls = gt_classes.long().gather(1, matched)
    tgt = F.one_hot(mcls.clamp(0, num_classes - 1), num_classes).float() * piou[..., None]
    loss_cls = (_bce(cls, tgt).sum(-1) * fg).sum()
    return (loss_iou + 2 * loss_obj + 2 * loss_cls) / num_fg


# ------------------------------------------------------------- segmentation

def seg_loss(logits, target, num_seg, alpha=0.5, gamma=2.0, smooth=1e-5):
    """Focal loss (mean over all pixels, ignored ones count as 0) + soft
    dice over the classes (the ignore channel left out)."""
    c = logits.shape[-1]
    flat = logits.reshape(-1, c)
    t = target.reshape(-1).long()
    valid = t < num_seg
    logp = torch.log_softmax(flat, -1).gather(1, torch.where(valid, t, 0)[:, None])[:, 0]
    logpt = torch.where(valid, logp, 0.0)
    focal = (-((1 - torch.exp(logpt)) ** gamma) * (logpt * alpha)).mean()
    b = logits.shape[0]
    probs = torch.softmax(logits.reshape(b, -1, c), -1)
    onehot = F.one_hot(target.reshape(b, -1).long(), num_seg + 1)[..., :num_seg].float()
    tp = (onehot * probs).sum((0, 1))
    fp, fn = probs.sum((0, 1)) - tp, onehot.sum((0, 1)) - tp
    dice = 1 - ((2 * tp + smooth) / (2 * tp + fn + fp + smooth)).mean()
    return focal + dice


# --------------------------------------------------------------- optimiser

def adaptive_lr(optim: dict, batch: int) -> float:
    """The recipe's first learning rate: batch / nbs * init_lr clamped to
    [5e-4, 5e-2] for SGD (train.py:451-455)."""
    return min(max(batch / optim["nbs"] * optim["init_lr"], 5e-4), 5e-2)


def decays(name: str, p: torch.Tensor) -> bool:
    return p.ndim >= 2 and name.rsplit(".", 1)[-1] not in _VECTOR_LEAVES


class Step:
    """The reference's train step over one model; keeps the momentum
    buffers, the EMA and its update count."""

    def __init__(self, model, cfg: dict, lr: float):
        self.model, self.cfg, self.lr = model, cfg, lr
        self.mom = {}
        self.ema = {k: v.detach().clone() for k, v in model.state_dict().items()
                    if v.is_floating_point()}
        self.updates = 0

    def __call__(self, batch: dict) -> float:
        m, o = self.model, self.cfg["optim"]
        mc = self.cfg["model"]
        m.train()
        for p in m.parameters():
            p.grad = None
        det, seg = m(normalize_image(batch["image"]), batch["radar"])
        loss = yolox_loss(det, batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"],
                          tuple(mc["head_strides"]), mc["num_classes"]) \
            + self.cfg["loss"]["seg_weight"] * seg_loss(seg, batch["seg_target"],
                                                        mc["num_seg_classes"])
        loss.backward()
        with torch.no_grad():
            for name, p in m.named_parameters():
                d = p.grad + o["weight_decay"] * p if decays(name, p) else p.grad.clone()
                buf = self.mom.get(name)
                buf = d.clone() if buf is None else buf.mul_(o["momentum"]).add_(d)
                self.mom[name] = buf
                p.sub_(self.lr * (d + o["momentum"] * buf))
            self.updates += 1
            dec = o["ema_decay"] * (1 - math.exp(-self.updates / o["ema_tau"]))
            for k, v in m.state_dict().items():
                if k in self.ema:
                    self.ema[k].mul_(dec).add_(v, alpha=1 - dec)
        return float(loss.detach())
