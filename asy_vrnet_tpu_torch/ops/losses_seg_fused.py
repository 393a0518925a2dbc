"""Fused segmentation loss + f_score (counterpart of
`asy_vrnet_tpu/ops/losses_seg_pallas.py`).

One pass over the logits computes every sum the losses need (kernel
`seg_loss_sums`): log-softmax, class-weighted NLL sum and weight sum, the
focal sum, the pixel count and, per class, tp, sum p, sum t, thresholded tp
and sum pred; its last CTA also turns the sums into the loss and f_score
(`_losses_from_acc`'s math).  The backward (kernel `seg_loss_dlogits`)
computes 2*C dice coefficients and one pixel scale from the saved sums and
the loss cotangent (`_backward_coef`'s math), recomputes the softmax and
writes dlogits, so no (B,H,W,C)-sized intermediate other than dlogits
reaches device memory.  Each direction is one launch and no other device
operation: the forward's rows, sums and scalars share one buffer, of which
the wrapper returns views, and class weights left as None read as 1.

Layout: NHWC (B,H,W,C) contiguous, as the model emits it; the kernels read a
pixel's C logits as one contiguous run (the TPU kernel's channel-major
transpose answers a TPU tiling constraint and is not carried over).  I/O
follows the logits' dtype (bf16 in the train step, f32 for the tight check);
all arithmetic is f32.

`seg_loss_sums` and `seg_loss_dlogits` take CPU tensors through their plain
twins and CUDA tensors through the kernels (or raise); each counts its kernel
launches in LAUNCHES.  f_score is a metric: its gradient is zero almost
everywhere and the backward ignores its cotangent; class weights get no
gradient.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from asy_vrnet_tpu_torch.ops import losses_seg as oracle
from asy_vrnet_tpu_torch.parallel import collectives

# kernel launches per wrapper; plain-version calls are not counted
LAUNCHES = {"seg_loss_sums": 0, "seg_loss_dlogits": 0}

# layout of the sums vector: 4 scalars, then 5 per-class vectors of length C
_CE_NUM, _CE_DEN, _FOCAL, _NPIX, _NSCAL = 0, 1, 2, 3, 4
_MAX_CLASSES = 32


class SegHyper(NamedTuple):
    """The loss's and f_score's hyper-parameters, as both kernels take them."""

    use_focal: bool = True
    alpha: float = 0.5
    gamma: float = 2.0
    use_dice: bool = True
    dice_beta: float = 1.0
    dice_smooth: float = 1e-5
    fs_beta: float = 1.0
    fs_smooth: float = 1e-5
    threshold: float = 0.5


def _split_acc(acc: torch.Tensor, c: int):
    """sums vector -> (tp, sum_p, sum_t, tp_f, sum_pred), each (C,)."""
    return acc[_NSCAL:].reshape(5, c).unbind(0)


def _softmax_parts(logits: torch.Tensor, target: torch.Tensor, cls_weights):
    """Shared by both plain twins: f32 probs (N,C), one-hot (N,C) (ignored
    pixels match no class), the weighted NLL and the per-pixel weight."""
    c = logits.shape[-1]
    lt = logits.reshape(-1, c).float()
    tgt = target.reshape(-1)
    mx = lt.max(dim=-1, keepdim=True).values
    ex = torch.exp(lt - mx)
    ssum = ex.sum(dim=-1, keepdim=True)
    lse = (mx + torch.log(ssum))[:, 0]
    probs = ex / ssum
    onehot = (tgt[:, None] == torch.arange(c, device=lt.device)[None]).float()
    l_t = (onehot * lt).sum(-1)
    w_t = onehot.sum(-1) if cls_weights is None else \
        (onehot * cls_weights.float()[None]).sum(-1)
    return probs, onehot, w_t * (lse - l_t), w_t


def seg_sums_plain(logits, target, cls_weights, hp: SegHyper, round_bf16: bool = False):
    """Plain twin of the `seg_loss_sums` kernel -> ((4 + 5*C,) f32 sums, loss,
    f_score); cls_weights may be None (every class 1); `round_bf16` reads
    the logits rounded to bf16."""
    c = logits.shape[-1]
    if round_bf16:
        logits = logits.to(torch.bfloat16)
    probs, onehot, nll, w_t = _softmax_parts(logits, target, cls_weights)
    # parity: class weights sit inside the focal exponent (logpt = -w*nll),
    # and the focal sum is later divided by ALL pixels, ignored ones included
    logpt = -nll
    om = 1.0 - torch.exp(logpt)
    focal = -(om ** hp.gamma) * (hp.alpha * logpt)
    # parity: ignored pixels (target == C) match no class but still add to
    # sum_p and sum_pred; the threshold compare is strict
    preds = (probs > hp.threshold).float()
    npix = torch.tensor(float(nll.numel()), device=nll.device)
    acc = torch.cat([
        torch.stack([nll.sum(), w_t.sum(), focal.sum(), npix]),
        (onehot * probs).sum(0), probs.sum(0), onehot.sum(0),
        (onehot * preds).sum(0), preds.sum(0)])
    return (acc, *_losses_from_acc(acc, c, hp))


def seg_dlogits_plain(logits, target, cls_weights, sums, gloss, hp: SegHyper,
                      round_bf16: bool = False) -> torch.Tensor:
    """Plain twin of the `seg_loss_dlogits` kernel: dlogits from the forward's
    (4 + 5*C,) sums and the loss cotangent `gloss`, through the (2*C + 1,)
    coefficients of `_backward_coef`: [0:C] the one-hot term A_c of dL/dp_c
    from dice, [C:2C] the every-pixel term B_c, [2C] the pixel scale of the
    focal/CE chain.  `round_bf16` reads the logits rounded to bf16 and
    rounds the result to bf16 (returned in the logits' dtype)."""
    c = logits.shape[-1]
    coef = _backward_coef(sums, gloss, c, hp)
    src = logits.to(torch.bfloat16) if round_bf16 else logits
    probs, onehot, nll, w_t = _softmax_parts(src, target, cls_weights)
    if hp.use_focal:
        logpt = -nll
        pt = torch.exp(logpt)
        # parity: om = max(1 - pt, 0); the second term is gamma*pt*logpt*
        # om^(gamma-1), taken as 0 where logpt == 0 (ignored pixels: pt = 1)
        om = (1.0 - pt).clamp_min(0.0)
        tail = torch.where(logpt == 0.0, torch.zeros_like(om),
                           hp.gamma * pt * logpt * om ** (hp.gamma - 1.0))
        dfdlogpt = -hp.alpha * (om ** hp.gamma - tail)
    else:
        dfdlogpt = -torch.ones_like(nll)
    pixc = coef[2 * c] * dfdlogpt * w_t
    dl = pixc[:, None] * (onehot - probs)
    gp = coef[:c][None] * onehot + coef[c:2 * c][None]
    dot = (probs * gp).sum(-1, keepdim=True)
    dl = dl + probs * (gp - dot)
    return dl.to(src.dtype).to(logits.dtype).reshape(logits.shape)


def _check_inputs(name, logits, target, cls_weights):
    b, h, w, c = logits.shape
    if logits.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: dtype {logits.dtype} not supported")
    if not 1 <= c <= _MAX_CLASSES:
        raise ValueError(f"{name}: {c} classes, the kernel takes 1..{_MAX_CLASSES}")
    for what, t, shape, dtype in (("logits", logits, (b, h, w, c), logits.dtype),
                                  ("target", target, (b, h, w), torch.int32),
                                  ("cls_weights", cls_weights, (c,), torch.float32)):
        if t is None and what == "cls_weights":
            continue
        if t.device != logits.device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: {what} must be a contiguous {dtype} tensor of shape "
                f"{shape} on {logits.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def seg_loss_sums(logits, target, cls_weights, hp: SegHyper, round_bf16: bool = False):
    """logits (B,H,W,C) bf16|f32, target (B,H,W) int32 (ignore == C), weights
    (C,) f32 or None -> ((4 + 5*C,) f32 sums, loss, f_score), one launch:
    the three are views of the buffer that also holds the CTAs' partial
    rows, which the kernel's last CTA sums in a fixed order (no float
    atomics: two runs on the same input give the same bits).
    `round_bf16` reads f32 logits rounded to bf16: the bf16 path's bits."""
    if logits.device.type == "cpu":
        return seg_sums_plain(logits, target, cls_weights, hp, round_bf16)
    if logits.device.type != "cuda":
        raise ValueError(f"seg_loss_sums: unsupported device {logits.device}")
    from asy_vrnet_tpu_torch.ops import kernels

    _check_inputs("seg_loss_sums", logits, target, cls_weights)
    c = logits.shape[-1]
    w = _NSCAL + 5 * c
    blocks = kernels.seg_loss_blocks(False, target.numel(), c, logits.element_size(),
                                     logits.device)
    buf = torch.empty(blocks * w + w + 2, dtype=torch.float32, device=logits.device)
    kernels.seg_loss_sums(logits, target, cls_weights, buf, hp, blocks,
                          round_bf16 and logits.dtype == torch.float32)
    LAUNCHES["seg_loss_sums"] += 1
    return buf[blocks * w:blocks * w + w], buf[-2], buf[-1]


def seg_loss_dlogits(logits, target, cls_weights, sums, gloss, hp: SegHyper,
                     round_bf16: bool = False) -> torch.Tensor:
    """dlogits in the logits' dtype and shape from the forward's (4 + 5*C,)
    f32 sums and the loss cotangent `gloss` (one f32 on the device, never
    read on the host), one launch (see `seg_dlogits_plain`).  `round_bf16`
    reads f32 logits rounded to bf16 and writes f32 results that hold bf16
    values: the bf16 path's bits, upcast."""
    if logits.device.type == "cpu":
        return seg_dlogits_plain(logits, target, cls_weights, sums, gloss, hp, round_bf16)
    if logits.device.type != "cuda":
        raise ValueError(f"seg_loss_dlogits: unsupported device {logits.device}")
    from asy_vrnet_tpu_torch.ops import kernels

    _check_inputs("seg_loss_dlogits", logits, target, cls_weights)
    c = logits.shape[-1]
    for what, t, n in (("sums", sums, _NSCAL + 5 * c), ("gloss", gloss, 1)):
        if t.device != logits.device or t.dtype != torch.float32 or t.numel() != n \
                or not t.is_contiguous():
            raise ValueError(f"seg_loss_dlogits: {what} must be {n} contiguous f32 "
                             f"value(s) on {logits.device}")
    out = torch.empty_like(logits)
    kernels.seg_loss_dlogits(logits, target, cls_weights, sums, gloss, out, hp,
                             kernels.seg_loss_blocks(True, target.numel(), c,
                                                     logits.element_size(), logits.device),
                             round_bf16 and logits.dtype == torch.float32)
    LAUNCHES["seg_loss_dlogits"] += 1
    return out


def _losses_from_acc(acc, c: int, hp: SegHyper):
    """Scalar (loss, f_score) from the sums vector (f32)."""
    tp, sp, st, tpf, spr = _split_acc(acc, c)
    if hp.use_focal:
        loss = acc[_FOCAL] / acc[_NPIX]
    else:
        loss = acc[_CE_NUM] / acc[_CE_DEN].clamp_min(1e-12)
    if hp.use_dice:
        b2 = hp.dice_beta ** 2
        u = (1.0 + b2) * tp + hp.dice_smooth
        v = b2 * st + sp + hp.dice_smooth          # the denominator is tp-free
        loss = loss + 1.0 - (u / v).mean()
    b2f = hp.fs_beta ** 2
    uf = (1.0 + b2f) * tpf + hp.fs_smooth
    vf = b2f * (st - tpf) + (spr - tpf) + uf      # (1+b2)tp + b2 fn + fp + smooth
    return loss, (uf / vf).mean()


def _backward_coef(acc, gloss, c: int, hp: SegHyper) -> torch.Tensor:
    """(2*C + 1,) coefficients of dL/dlogits from the saved sums and the
    loss cotangent: dL_dice/dp_c = A_c * onehot_c + B_c, and the pixel scale
    g / npix (focal) or g / ce_den (CE)."""
    gloss = gloss.float()
    if hp.use_dice:
        b2 = hp.dice_beta ** 2
        tp, sp, st, _, _ = _split_acc(acc, c)
        u = (1.0 + b2) * tp + hp.dice_smooth
        v = b2 * st + sp + hp.dice_smooth
        # L_dice = 1 - mean_c u/v; d/dtp = -(1+b2)/(c v); d/dsum_p = u/(c v^2)
        a_c = gloss * (-(1.0 + b2) / (c * v))
        b_c = gloss * (u / (c * v * v))
    else:
        a_c = b_c = torch.zeros(c, dtype=torch.float32, device=acc.device)
    scale = gloss / (acc[_NPIX] if hp.use_focal else acc[_CE_DEN].clamp_min(1e-12))
    return torch.cat([a_c, b_c, scale.reshape(1)]).contiguous()


class _FusedSegLoss(torch.autograd.Function):
    """(loss, f_score) = f(logits); backward through `seg_loss_dlogits`."""

    @staticmethod
    def forward(ctx, logits, target, cls_weights, hp, round_bf16):
        acc, loss, fscore = seg_loss_sums(logits, target, cls_weights, hp, round_bf16)
        group = collectives.active()
        if group is not None:
            # the global batch's sums; K4b reads them, so each rank's dlogits
            # are its rows of the global loss's.  The kernel turned this
            # rank's sums alone into its loss and f_score: over more than
            # one rank they come from the reduced sums
            collectives.all_reduce_(acc)
            if group.size > 1:
                loss, fscore = _losses_from_acc(acc, logits.shape[-1], hp)
        ctx.save_for_backward(logits, target, cls_weights, acc)
        ctx.hp, ctx.round_bf16 = hp, round_bf16
        ctx.mark_non_differentiable(fscore)
        ctx.set_materialize_grads(False)     # no zeros kernel for f_score's cotangent
        return loss, fscore

    @staticmethod
    def backward(ctx, gloss, _gfscore):
        if gloss is None:
            return (None,) * 5
        logits, target, cls_weights, acc = ctx.saved_tensors
        return (seg_loss_dlogits(logits, target, cls_weights, acc, gloss, ctx.hp,
                                 ctx.round_bf16), None, None, None, None)


def fused_seg_loss_and_fscore(
    seg_logits: torch.Tensor,            # (B, H, W, C) NHWC, bf16 or f32
    seg_target: torch.Tensor,            # (B, H, W) int, ignore == num_classes
    cls_weights: torch.Tensor | None = None,
    num_classes: int = 21,
    *,
    use_focal: bool = True,
    focal_alpha: float = 0.5,
    focal_gamma: float = 2.0,
    use_dice: bool = True,
    dice_beta: float = 1.0,
    dice_smooth: float = 1e-5,
    fscore_beta: float = 1.0,
    fscore_smooth: float = 1e-5,
    fscore_threshold: float = 0.5,
    use_kernel: bool | None = None,
    round_bf16: bool = False,
):
    """(loss_seg, f_score), equal to the oracle's focal|CE (+ dice) and
    f_score (`ops/losses_seg.py`).

    `round_bf16` (fused path): f32 logits are read as bf16, the gradient
    holds bf16 values in f32.  The results are those of the same call on
    `seg_logits.to(torch.bfloat16)` without that cast and autograd's cast
    back: the train step passes the model's f32 output, an exact upcast of
    its bf16 seg map, so under a bf16 compute dtype.

    `use_kernel=None` takes the fused path iff the logits lie on a CUDA
    device; True forces it (on the CPU it then runs through the kernels'
    plain twins, which the parity tests use); False is the oracle
    composition."""
    if use_kernel is None:
        use_kernel = seg_logits.device.type == "cuda"
    if not use_kernel:
        onehot = torch.nn.functional.one_hot(seg_target.long(), num_classes + 1).float()
        if use_focal:
            loss = oracle.focal_loss(seg_logits, seg_target, cls_weights, num_classes,
                                     focal_alpha, focal_gamma)
        else:
            loss = oracle.ce_loss(seg_logits, seg_target, cls_weights, num_classes)
        if use_dice:
            loss = loss + oracle.dice_loss(seg_logits, onehot, dice_beta, dice_smooth)
        return loss, oracle.f_score(seg_logits, onehot, fscore_beta, fscore_smooth,
                                    fscore_threshold)

    if round_bf16 and seg_logits.shape[1:3] != seg_target.shape[1:3]:
        seg_logits = seg_logits.to(torch.bfloat16)     # resized in bf16, as by that call
    seg_logits = oracle._maybe_resize(seg_logits, seg_target.shape[1],
                                      seg_target.shape[2])
    w = (None if cls_weights is None else
         torch.as_tensor(cls_weights, dtype=torch.float32, device=seg_logits.device).contiguous())
    hp = SegHyper(use_focal, float(focal_alpha), float(focal_gamma), use_dice,
                  float(dice_beta), float(dice_smooth), float(fscore_beta),
                  float(fscore_smooth), float(fscore_threshold))
    return _FusedSegLoss.apply(seg_logits.contiguous(),
                               seg_target.to(torch.int32).contiguous(), w, hp, round_bf16)
