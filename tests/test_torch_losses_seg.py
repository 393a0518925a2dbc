"""The port's segmentation losses against the JAX package, on the CPU.

The same numpy inputs (seeded) go through `asy_vrnet_tpu/ops/losses_seg.py`
and `asy_vrnet_tpu_torch/ops/losses_seg.py`, and through the fused Pallas
kernel (interpret mode) and the port's fused path, whose kernels run through
their plain twins on CPU tensors.

Tolerances:
  oracle losses, f32: atol 1e-6 (the same formula, sums in another order).
  fused value vs Pallas, f32: atol 1e-5; gradient atol 1e-6.
  bf16 I/O: value atol 1e-2 against the Pallas kernel on the same bf16 logits
    (both compute in f32; the sums differ by order only), gradient within one
    bf16 ulp of its largest entry (both round an f32 gradient once).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asy_vrnet_tpu.ops import losses_seg as jl
from asy_vrnet_tpu.ops.losses_seg_pallas import fused_seg_loss_and_fscore as j_fused

from asy_vrnet_tpu_torch.ops import losses_seg as tl
from asy_vrnet_tpu_torch.ops import losses_seg_fused as tf

C = 9


def _data(shape=(2, 32, 64), c=C, seed=0, scale=2.0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((*shape, c)) * scale).astype(np.float32)
    target = rng.integers(0, c + 1, size=shape).astype(np.int32)     # c = ignore
    onehot = np.eye(c + 1, dtype=np.float32)[target]
    weights = np.linspace(0.5, 2.0, c).astype(np.float32)
    return logits, target, onehot, weights


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("name", ["ce_loss", "focal_loss"])
def test_pixel_losses_match_jax(name, weighted):
    logits, target, _, weights = _data(seed=1)
    w = weights if weighted else None
    want = jax.jit(lambda l, t: getattr(jl, name)(
        l, t, None if w is None else jnp.asarray(w), C))(logits, target)
    got = getattr(tl, name)(torch.from_numpy(logits), torch.from_numpy(target),
                            None if w is None else torch.from_numpy(w), C)
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6)


@pytest.mark.parametrize("name", ["dice_loss", "f_score"])
def test_region_scores_match_jax(name):
    logits, _, onehot, _ = _data(seed=2)
    want = jax.jit(getattr(jl, name))(logits, onehot)
    got = getattr(tl, name)(torch.from_numpy(logits), torch.from_numpy(onehot))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6)


def test_losses_resize_logits_to_the_target():
    """Half-size logits are resized (bilinear, align_corners) like in JAX."""
    logits, _, _, weights = _data(shape=(2, 16, 32), seed=3)
    _, target, onehot, _ = _data(shape=(2, 32, 64), seed=4)
    for name, args in (("focal_loss", (target, weights, C)), ("dice_loss", (onehot,))):
        want = jax.jit(lambda l, *a, n=name: getattr(jl, n)(l, *a))(
            logits, *[a if isinstance(a, int) else jnp.asarray(a) for a in args])
        got = getattr(tl, name)(torch.from_numpy(logits), *[
            a if isinstance(a, int) else torch.from_numpy(a) for a in args])
        np.testing.assert_allclose(got.item(), float(want), atol=1e-6)
    fused, _ = tf.fused_seg_loss_and_fscore(
        torch.from_numpy(logits), torch.from_numpy(target), None, C, use_kernel=True)
    want, _ = j_fused(jnp.asarray(logits), jnp.asarray(target), None, C, use_pallas=True)
    np.testing.assert_allclose(fused.item(), float(want), atol=1e-5)


def _both_fused(logits, target, weights, use_focal, use_dice, dtype="float32"):
    """-> ((loss, fscore, grad) of the Pallas kernel, the same of the port)."""
    jw = None if weights is None else jnp.asarray(weights)
    jlogits = jnp.asarray(logits).astype(dtype)

    def jf(lg):
        loss, fs = j_fused(lg, jnp.asarray(target), jw, C, use_focal=use_focal,
                           use_dice=use_dice, use_pallas=True)
        return loss, fs

    (jloss, jfs), jgrad = jax.jit(jax.value_and_grad(jf, has_aux=True))(jlogits)
    tlogits = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_(True)
    tloss, tfs = tf.fused_seg_loss_and_fscore(
        tlogits, torch.from_numpy(target), None if weights is None else
        torch.from_numpy(weights), C, use_focal=use_focal, use_dice=use_dice,
        use_kernel=True)
    tloss.backward()
    assert not tfs.requires_grad
    return ((float(jloss), float(jfs), np.asarray(jgrad.astype(jnp.float32))),
            (tloss.item(), tfs.item(), tlogits.grad))


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("use_dice", [False, True], ids=["nodice", "dice"])
@pytest.mark.parametrize("use_focal", [False, True], ids=["ce", "focal"])
def test_fused_matches_pallas(use_focal, use_dice, weighted):
    """seg_sums_plain + _losses_from_acc, and the autograd.Function's gradient
    through seg_dlogits_plain, against the Pallas kernels in interpret mode."""
    logits, target, _, weights = _data(seed=5)
    (jloss, jfs, jgrad), (tloss, tfs, tgrad) = _both_fused(
        logits, target, weights if weighted else None, use_focal, use_dice)
    np.testing.assert_allclose(tloss, jloss, atol=1e-5)
    np.testing.assert_allclose(tfs, jfs, atol=1e-5)
    assert tgrad.dtype == torch.float32
    np.testing.assert_allclose(tgrad.numpy(), jgrad, atol=1e-6)
    assert np.abs(jgrad).max() > 1e-6


def test_fused_bf16_io_matches_pallas():
    logits, target, _, weights = _data(seed=6)
    (jloss, jfs, jgrad), (tloss, tfs, tgrad) = _both_fused(
        logits, target, weights, True, True, dtype="bfloat16")
    np.testing.assert_allclose(tloss, jloss, atol=1e-2)
    np.testing.assert_allclose(tfs, jfs, atol=1e-2)
    assert tgrad.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(jgrad).max())) - 7)
    np.testing.assert_allclose(tgrad.float().numpy(), jgrad, atol=ulp)


@pytest.mark.parametrize("use_focal", [False, True], ids=["ce", "focal"])
def test_fused_equals_oracle_composition_and_autograd(use_focal):
    """Inside the port: the fused path (use_kernel=True) and the oracle
    composition (use_kernel=False) give the same value, and the hand-written
    backward equals autograd through the oracle (atol 1e-6)."""
    logits, target, _, weights = _data(seed=7)
    out = []
    for fused in (True, False):
        lg = torch.from_numpy(logits).requires_grad_(True)
        loss, fs = tf.fused_seg_loss_and_fscore(
            lg, torch.from_numpy(target), torch.from_numpy(weights), C,
            use_focal=use_focal, use_kernel=fused)
        loss.backward()
        out.append((loss.item(), fs.item(), lg.grad.numpy()))
    np.testing.assert_allclose(out[0][0], out[1][0], atol=1e-6)
    np.testing.assert_allclose(out[0][1], out[1][1], atol=1e-6)
    np.testing.assert_allclose(out[0][2], out[1][2], atol=1e-6)


def test_ignored_pixels_give_zero_focal_gradient_not_nan():
    """pt = 1 at ignored pixels: (1 - pt)^gamma must contribute 0, never NaN,
    also for gamma < 1 where om^(gamma-1) is infinite."""
    logits, target, _, _ = _data(shape=(1, 8, 8), seed=8)
    target[:] = C
    for gamma in (2.0, 0.5):
        lg = torch.from_numpy(logits).requires_grad_(True)
        loss, _ = tf.fused_seg_loss_and_fscore(
            lg, torch.from_numpy(target), None, C, use_dice=False,
            focal_gamma=gamma, use_kernel=True)
        loss.backward()
        assert loss.item() == 0.0
        assert torch.equal(lg.grad, torch.zeros_like(lg.grad))


def test_sums_vector_layout_and_quirks():
    """The (4 + 5*C,) sums: npix counts every pixel, ignored pixels add to
    sum_p and sum_pred but to no per-class target sum."""
    logits, target, onehot, weights = _data(shape=(1, 4, 8), seed=9)
    acc, _, _ = tf.seg_sums_plain(torch.from_numpy(logits), torch.from_numpy(target),
                                  torch.from_numpy(weights),
                                  tf.SegHyper(alpha=0.5, gamma=2.0, threshold=0.5))
    assert acc.shape == (4 + 5 * C,)
    tp, sp, st, tpf, spr = tf._split_acc(acc, C)
    assert acc[3].item() == 32
    np.testing.assert_allclose(sp.sum().item(), 32.0, rtol=1e-5)   # all pixels
    np.testing.assert_array_equal(st.numpy(), onehot[..., :C].sum((0, 1, 2)))
    assert (target == C).sum() > 0 and st.sum().item() == (target < C).sum()


def test_wrappers_refuse_what_the_kernel_does_not_take():
    logits, target, _, weights = _data(shape=(1, 4, 8), seed=10)
    with pytest.raises(ValueError, match="dtype"):
        tf._check_inputs("seg_loss_sums", torch.from_numpy(logits).double(),
                         torch.from_numpy(target), torch.from_numpy(weights))
    with pytest.raises(ValueError, match="target"):
        tf._check_inputs("seg_loss_sums", torch.from_numpy(logits),
                         torch.from_numpy(target).long(), torch.from_numpy(weights))
    assert tf.LAUNCHES == {"seg_loss_sums": 0, "seg_loss_dlogits": 0}


HYPERS = [tf.SegHyper(), tf.SegHyper(use_focal=False, use_dice=False),
          tf.SegHyper(use_dice=False, gamma=0.5, alpha=0.25),
          tf.SegHyper(use_focal=False, dice_beta=2.0, fs_beta=0.5, threshold=0.3)]


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("hp", HYPERS, ids=["focal+dice", "ce", "focal", "ce+dice"])
def test_twins_give_the_kernels_contract(hp, weighted):
    """What each kernel computes inside (so one launch a direction): the sums
    twin returns the loss and f_score of `_losses_from_acc`, which equal
    their formulas in f64; the dlogits twin takes the sums and the loss
    cotangent and applies `_backward_coef`, whose coefficients equal theirs
    in f64, linearly in the cotangent."""
    logits, target, _, weights = _data(shape=(2, 8, 16), seed=11)
    lg, tg = torch.from_numpy(logits), torch.from_numpy(target)
    w = torch.from_numpy(weights) if weighted else None
    acc, loss, fs = tf.seg_sums_plain(lg, tg, w, hp)
    assert (loss, fs) == tuple(tf._losses_from_acc(acc, C, hp))
    if not weighted:       # None reads as every class 1
        ones, _, _ = tf.seg_sums_plain(lg, tg, torch.ones(C), hp)
        assert torch.equal(acc, ones)
    a = acc.double().numpy()
    tp, sp, st, tpf, spr = a[4:].reshape(5, C)
    want = a[2] / a[3] if hp.use_focal else a[0] / max(a[1], 1e-12)
    b2 = hp.dice_beta ** 2
    u, v = (1 + b2) * tp + hp.dice_smooth, b2 * st + sp + hp.dice_smooth
    if hp.use_dice:
        want += 1 - (u / v).mean()
    f2 = hp.fs_beta ** 2
    uf = (1 + f2) * tpf + hp.fs_smooth
    np.testing.assert_allclose([loss.item(), fs.item()],
                               [want, (uf / (f2 * (st - tpf) + spr - tpf + uf)).mean()],
                               rtol=1e-6)
    g = 2.5
    coef = tf._backward_coef(acc, torch.tensor(g), C, hp).double().numpy()
    scale = g / (a[3] if hp.use_focal else max(a[1], 1e-12))
    ab = ([-g * (1 + b2) / (C * v), g * u / (C * v * v)] if hp.use_dice
          else [np.zeros(C)] * 2)
    np.testing.assert_allclose(coef, np.concatenate([*ab, [scale]]), rtol=1e-6)
    dl = tf.seg_dlogits_plain(lg, tg, w, acc, torch.tensor(g), hp)
    dl1 = tf.seg_dlogits_plain(lg, tg, w, acc, torch.tensor(1.0), hp)
    np.testing.assert_allclose(dl.numpy(), g * dl1.numpy(), rtol=1e-5, atol=1e-7)
    assert tf.LAUNCHES == {"seg_loss_sums": 0, "seg_loss_dlogits": 0}


@pytest.mark.parametrize("exact", [True, False], ids=["bf16-values", "f32-values"])
def test_round_bf16_gives_the_bf16_path(exact):
    """f32 logits read with round_bf16 give the bits of the same call on
    their bf16 cast, and a gradient that holds those bf16 values in f32 (the
    train step passes the model's f32 output, an exact upcast: `exact`)."""
    logits, target, _, weights = _data(seed=12)
    lg32 = torch.from_numpy(logits)
    if exact:
        lg32 = lg32.to(torch.bfloat16).float()
    out = []
    for x, rnd in ((lg32.to(torch.bfloat16), False), (lg32, True)):
        x = x.clone().requires_grad_(True)
        loss, fs = tf.fused_seg_loss_and_fscore(
            x, torch.from_numpy(target), torch.from_numpy(weights), C, use_kernel=True,
            round_bf16=rnd)
        loss.backward()
        out.append((loss, fs, x.grad))
    (l16, f16, g16), (l32, f32, g32) = out
    assert torch.equal(l16, l32) and torch.equal(f16, f32)
    assert g32.dtype == torch.float32 and torch.equal(g32, g16.float())
