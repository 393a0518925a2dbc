"""Fused segmentation loss + f_score (counterpart of
`asy_vrnet_tpu/ops/losses_seg_pallas.py`).

One pass over the logits computes every sum the losses need (kernel
`seg_loss_sums`): log-softmax, class-weighted NLL sum and weight sum, the
focal sum, the pixel count and, per class, tp, sum p, sum t, thresholded tp
and sum pred.  The backward (kernel `seg_loss_dlogits`) recomputes the
softmax and writes dlogits from 2*C dice coefficients and one pixel scale, so
no (B,H,W,C)-sized intermediate other than dlogits reaches device memory.
The scalar losses (`_losses_from_acc`) and the coefficient maths of the
backward are plain tensor code on the (4 + 5*C,) sums vector.

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

import torch

from asy_vrnet_tpu_torch.ops import losses_seg as oracle

# kernel launches per wrapper; plain-version calls are not counted
LAUNCHES = {"seg_loss_sums": 0, "seg_loss_dlogits": 0}

# layout of the sums vector: 4 scalars, then 5 per-class vectors of length C
_CE_NUM, _CE_DEN, _FOCAL, _NPIX, _NSCAL = 0, 1, 2, 3, 4
_MAX_CLASSES = 32
_TILE = 256                      # pixels per block pass (csrc/seg_loss.cu)


def _split_acc(acc: torch.Tensor, c: int):
    """sums vector -> (tp, sum_p, sum_t, tp_f, sum_pred), each (C,)."""
    return acc[_NSCAL:].reshape(5, c).unbind(0)


def _softmax_parts(logits: torch.Tensor, target: torch.Tensor,
                   cls_weights: torch.Tensor):
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
    w_t = (onehot * cls_weights.float()[None]).sum(-1)
    return probs, onehot, w_t * (lse - l_t), w_t


def seg_sums_plain(logits, target, cls_weights, alpha: float, gamma: float,
                   threshold: float) -> torch.Tensor:
    """Plain twin of the `seg_loss_sums` kernel -> (4 + 5*C,) f32 sums."""
    probs, onehot, nll, w_t = _softmax_parts(logits, target, cls_weights)
    # parity: class weights sit inside the focal exponent (logpt = -w*nll),
    # and the focal sum is later divided by ALL pixels, ignored ones included
    logpt = -nll
    om = 1.0 - torch.exp(logpt)
    focal = -(om ** gamma) * (alpha * logpt)
    # parity: ignored pixels (target == C) match no class but still add to
    # sum_p and sum_pred; the threshold compare is strict
    preds = (probs > threshold).float()
    npix = torch.tensor(float(nll.numel()), device=nll.device)
    return torch.cat([
        torch.stack([nll.sum(), w_t.sum(), focal.sum(), npix]),
        (onehot * probs).sum(0), probs.sum(0), onehot.sum(0),
        (onehot * preds).sum(0), preds.sum(0)])


def seg_dlogits_plain(logits, target, cls_weights, coef, alpha: float,
                      gamma: float, use_focal: bool) -> torch.Tensor:
    """Plain twin of the `seg_loss_dlogits` kernel.  coef (2*C + 1,) f32:
    [0:C] the one-hot term A_c of dL/dp_c from dice, [C:2C] the every-pixel
    term B_c, [2C] the pixel scale of the focal/CE chain."""
    c = logits.shape[-1]
    probs, onehot, nll, w_t = _softmax_parts(logits, target, cls_weights)
    if use_focal:
        logpt = -nll
        pt = torch.exp(logpt)
        # parity: om = max(1 - pt, 0); the second term is gamma*pt*logpt*
        # om^(gamma-1), taken as 0 where logpt == 0 (ignored pixels: pt = 1)
        om = (1.0 - pt).clamp_min(0.0)
        tail = torch.where(logpt == 0.0, torch.zeros_like(om),
                           gamma * pt * logpt * om ** (gamma - 1.0))
        dfdlogpt = -alpha * (om ** gamma - tail)
    else:
        dfdlogpt = -torch.ones_like(nll)
    pixc = coef[2 * c] * dfdlogpt * w_t
    dl = pixc[:, None] * (onehot - probs)
    gp = coef[:c][None] * onehot + coef[c:2 * c][None]
    dot = (probs * gp).sum(-1, keepdim=True)
    dl = dl + probs * (gp - dot)
    return dl.to(logits.dtype).reshape(logits.shape)


def _check_inputs(name, logits, target, cls_weights):
    b, h, w, c = logits.shape
    if logits.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: dtype {logits.dtype} not supported")
    if not 1 <= c <= _MAX_CLASSES:
        raise ValueError(f"{name}: {c} classes, the kernel takes 1..{_MAX_CLASSES}")
    for what, t, shape, dtype in (("logits", logits, (b, h, w, c), logits.dtype),
                                  ("target", target, (b, h, w), torch.int32),
                                  ("cls_weights", cls_weights, (c,), torch.float32)):
        if t.device != logits.device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: {what} must be a contiguous {dtype} tensor of shape "
                f"{shape} on {logits.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def seg_loss_sums(logits, target, cls_weights, alpha: float, gamma: float,
                  threshold: float) -> torch.Tensor:
    """logits (B,H,W,C) bf16|f32, target (B,H,W) int32 (ignore == C), weights
    (C,) f32 -> (4 + 5*C,) f32 sums.  Each block writes its partial sums and
    one float64 torch sum reduces them: no float atomics, so two runs on the
    same input give the same bits."""
    if logits.device.type == "cpu":
        return seg_sums_plain(logits, target, cls_weights, alpha, gamma, threshold)
    if logits.device.type != "cuda":
        raise ValueError(f"seg_loss_sums: unsupported device {logits.device}")
    from asy_vrnet_tpu_torch.ops import kernels

    _check_inputs("seg_loss_sums", logits, target, cls_weights)
    c = logits.shape[-1]
    tiles = -(-target.numel() // _TILE)
    sms = torch.cuda.get_device_properties(logits.device).multi_processor_count
    blocks = max(1, min(tiles, 8 * sms))
    part = torch.empty((blocks, _NSCAL + 5 * c), dtype=torch.float32,
                       device=logits.device)
    kernels.seg_loss_sums(logits, target, cls_weights, part, alpha, gamma, threshold)
    LAUNCHES["seg_loss_sums"] += 1
    return part.double().sum(dim=0).float()


def seg_loss_dlogits(logits, target, cls_weights, coef, alpha: float,
                     gamma: float, use_focal: bool) -> torch.Tensor:
    """dlogits in the logits' dtype and shape from the (2*C + 1,) f32
    coefficients (see `seg_dlogits_plain`)."""
    if logits.device.type == "cpu":
        return seg_dlogits_plain(logits, target, cls_weights, coef, alpha, gamma,
                                 use_focal)
    if logits.device.type != "cuda":
        raise ValueError(f"seg_loss_dlogits: unsupported device {logits.device}")
    from asy_vrnet_tpu_torch.ops import kernels

    _check_inputs("seg_loss_dlogits", logits, target, cls_weights)
    c = logits.shape[-1]
    if coef.device != logits.device or coef.dtype != torch.float32 \
            or tuple(coef.shape) != (2 * c + 1,) or not coef.is_contiguous():
        raise ValueError(f"seg_loss_dlogits: coef must be ({2 * c + 1},) f32 "
                         f"on {logits.device}")
    out = torch.empty_like(logits)
    kernels.seg_loss_dlogits(logits, target, cls_weights, coef, out, alpha, gamma,
                             use_focal)
    LAUNCHES["seg_loss_dlogits"] += 1
    return out


def _losses_from_acc(acc, c: int, use_focal: bool, use_dice: bool,
                     dice_beta: float, dice_smooth: float, fs_beta: float,
                     fs_smooth: float):
    """Scalar (loss, f_score) from the sums vector (f32)."""
    tp, sp, st, tpf, spr = _split_acc(acc, c)
    if use_focal:
        loss = acc[_FOCAL] / acc[_NPIX]
    else:
        loss = acc[_CE_NUM] / acc[_CE_DEN].clamp_min(1e-12)
    if use_dice:
        b2 = dice_beta ** 2
        u = (1.0 + b2) * tp + dice_smooth
        v = b2 * st + sp + dice_smooth            # the denominator is tp-free
        loss = loss + 1.0 - (u / v).mean()
    b2f = fs_beta ** 2
    uf = (1.0 + b2f) * tpf + fs_smooth
    vf = b2f * (st - tpf) + (spr - tpf) + uf      # (1+b2)tp + b2 fn + fp + smooth
    return loss, (uf / vf).mean()


def _backward_coef(acc, gloss, c: int, use_focal: bool, use_dice: bool,
                   dice_beta: float, dice_smooth: float) -> torch.Tensor:
    """(2*C + 1,) coefficients of dL/dlogits from the saved sums and the
    loss cotangent: dL_dice/dp_c = A_c * onehot_c + B_c, and the pixel scale
    g / npix (focal) or g / ce_den (CE)."""
    gloss = gloss.float()
    if use_dice:
        b2 = dice_beta ** 2
        tp, sp, st, _, _ = _split_acc(acc, c)
        u = (1.0 + b2) * tp + dice_smooth
        v = b2 * st + sp + dice_smooth
        # L_dice = 1 - mean_c u/v; d/dtp = -(1+b2)/(c v); d/dsum_p = u/(c v^2)
        a_c = gloss * (-(1.0 + b2) / (c * v))
        b_c = gloss * (u / (c * v * v))
    else:
        a_c = b_c = torch.zeros(c, dtype=torch.float32, device=acc.device)
    scale = gloss / (acc[_NPIX] if use_focal else acc[_CE_DEN].clamp_min(1e-12))
    return torch.cat([a_c, b_c, scale.reshape(1)]).contiguous()


class _FusedSegLoss(torch.autograd.Function):
    """(loss, f_score) = f(logits); backward through `seg_loss_dlogits`."""

    @staticmethod
    def forward(ctx, logits, target, cls_weights, use_focal, alpha, gamma,
                use_dice, dice_beta, dice_smooth, fs_beta, fs_smooth, threshold):
        c = logits.shape[-1]
        acc = seg_loss_sums(logits, target, cls_weights, alpha, gamma, threshold)
        loss, fscore = _losses_from_acc(acc, c, use_focal, use_dice, dice_beta,
                                        dice_smooth, fs_beta, fs_smooth)
        ctx.save_for_backward(logits, target, cls_weights, acc)
        ctx.hyper = (use_focal, alpha, gamma, use_dice, dice_beta, dice_smooth)
        ctx.mark_non_differentiable(fscore)
        return loss, fscore

    @staticmethod
    def backward(ctx, gloss, _gfscore):
        logits, target, cls_weights, acc = ctx.saved_tensors
        use_focal, alpha, gamma, use_dice, dice_beta, dice_smooth = ctx.hyper
        coef = _backward_coef(acc, gloss, logits.shape[-1], use_focal, use_dice,
                              dice_beta, dice_smooth)
        dlog = seg_loss_dlogits(logits, target, cls_weights, coef, alpha, gamma,
                                use_focal)
        return (dlog,) + (None,) * 11


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
):
    """(loss_seg, f_score), equal to the oracle's focal|CE (+ dice) and
    f_score (`ops/losses_seg.py`).

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

    seg_logits = oracle._maybe_resize(seg_logits, seg_target.shape[1],
                                      seg_target.shape[2])
    c = seg_logits.shape[-1]
    dev = seg_logits.device
    w = (torch.ones(c, dtype=torch.float32, device=dev) if cls_weights is None
         else torch.as_tensor(cls_weights, dtype=torch.float32, device=dev))
    return _FusedSegLoss.apply(
        seg_logits.contiguous(), seg_target.to(torch.int32).contiguous(),
        w.contiguous(), use_focal, float(focal_alpha), float(focal_gamma), use_dice,
        float(dice_beta), float(dice_smooth), float(fscore_beta),
        float(fscore_smooth), float(fscore_threshold))
