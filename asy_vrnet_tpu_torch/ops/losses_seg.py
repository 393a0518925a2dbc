"""Segmentation losses with reference semantics (counterpart of
`asy_vrnet_tpu/ops/losses_seg.py`; reference nets/deeplabv3_training.py:9-59).

All functions take NHWC logits (B,H,W,C).  `target` is an int map (B,H,W)
with the ignore class encoded as `num_classes`; `target_onehot` is
(B,H,W,C+1) with the trailing ignore channel.  These are the unfused
compositions; the train step on the card goes through
`ops/losses_seg_fused.py` instead.

Parity notes:
  - CE uses torch's weighted-mean normalisation (sum w[t]*nll / sum w[t] over
    non-ignored pixels);
  - focal keeps the reference's quirks: the final mean is over *all* pixels
    (ignored pixels add 0 to the numerator but count in the denominator), and
    class weights enter inside the exp() via the weighted CE;
  - dice excludes the trailing ignore channel of the one-hot target;
  - logits are bilinearly resized (align_corners=True) to the target size
    when they differ.
In a parallel step every sum and count is the global batch's
(`parallel/collectives.py`), and every rank computes the same loss.
"""
from __future__ import annotations

from typing import Optional

import torch

from asy_vrnet_tpu_torch.ops.resize import resize_bilinear
from asy_vrnet_tpu_torch.parallel import collectives


def _maybe_resize(logits: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """NHWC logits -> (B, th, tw, C), align-corners bilinear when they differ."""
    if logits.shape[1] != th or logits.shape[2] != tw:
        logits = resize_bilinear(logits.permute(0, 3, 1, 2), (th, tw),
                                 align_corners=True).permute(0, 2, 3, 1)
    return logits


def _weighted_ce_elementwise(logits: torch.Tensor, target: torch.Tensor,
                             cls_weights: Optional[torch.Tensor],
                             num_classes: int):
    """(N,C) logits, (N,) int target (== C: ignore) -> per-element weighted
    NLL (0 where ignored) and per-element weights."""
    valid = target < num_classes
    t = torch.where(valid, target, torch.zeros_like(target)).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, t[:, None])[:, 0]
    if cls_weights is None:
        w = torch.ones_like(nll)
    else:
        w = cls_weights.to(logp.dtype)[t]
    zero = torch.zeros_like(nll)
    return torch.where(valid, w * nll, zero), torch.where(valid, w, zero)


def ce_loss(logits, target, cls_weights=None, num_classes: int = 21):
    """Weighted cross-entropy with ignore_index=num_classes (CE_Loss, :9-19)."""
    _, th, tw = target.shape
    logits = _maybe_resize(logits, th, tw)
    c = logits.shape[-1]
    nll, w = _weighted_ce_elementwise(
        logits.reshape(-1, c), target.reshape(-1), cls_weights, num_classes)
    num, den = collectives.global_sums(nll.sum(), w.sum())
    return num / den.clamp_min(1e-12)


def focal_loss(logits, target, cls_weights=None, num_classes: int = 21,
               alpha: float = 0.5, gamma: float = 2.0):
    """Focal loss on top of weighted CE (Focal_Loss, :22-38)."""
    _, th, tw = target.shape
    logits = _maybe_resize(logits, th, tw)
    c = logits.shape[-1]
    nll, _ = _weighted_ce_elementwise(
        logits.reshape(-1, c), target.reshape(-1), cls_weights, num_classes)
    logpt = -nll                      # 0 at ignored pixels, matching torch
    pt = torch.exp(logpt)
    loss = -((1.0 - pt) ** gamma) * (logpt * alpha)
    # parity: mean over all pixels (ignored pixels are zeros in the numerator);
    # in a parallel step over the global batch's (the ranks' shards are of
    # one size)
    group = collectives.active()
    if group is None:
        return loss.mean()
    (total,) = collectives.global_sums(loss.sum())
    return total / (loss.numel() * group.size)


def _soft_scores(logits, target_onehot, beta, smooth, threshold=None):
    b, th, tw, ct = target_onehot.shape
    logits = _maybe_resize(logits, th, tw)
    c = logits.shape[-1]
    probs = torch.softmax(logits.reshape(b, -1, c), dim=-1)
    if threshold is not None:
        probs = (probs > threshold).to(probs.dtype)
    tgt = target_onehot.reshape(b, -1, ct)[..., :-1].to(probs.dtype)
    tp, sum_p, sum_t = collectives.global_sums(
        (tgt * probs).sum(dim=(0, 1)), probs.sum(dim=(0, 1)), tgt.sum(dim=(0, 1)))
    fp = sum_p - tp
    fn = sum_t - tp
    b2 = beta ** 2
    return ((1 + b2) * tp + smooth) / ((1 + b2) * tp + b2 * fn + fp + smooth)


def dice_loss(logits, target_onehot, beta: float = 1.0, smooth: float = 1e-5):
    """Soft-dice over classes, excluding the ignore channel (Dice_loss, :41-59)."""
    return 1.0 - _soft_scores(logits, target_onehot, beta, smooth).mean()


def f_score(logits, target_onehot, beta: float = 1.0, smooth: float = 1e-5,
            threshold: float = 0.5):
    """Thresholded dice metric (utils_seg/utils_metrics.py:12-31)."""
    return _soft_scores(logits, target_onehot, beta, smooth, threshold).mean()
