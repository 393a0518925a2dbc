"""The port's YOLOX loss against the JAX package, on the CPU.

The same seeded numpy head maps and padded GT go through
`asy_vrnet_tpu/ops/losses_det.py::yolox_loss` (whose SimOTA runs the jnp path
on the CPU) and the port's (whose SimOTA runs the kernel's plain twin).
Tolerance: value and the gradients w.r.t. the three head maps rtol 1e-4
(atol 1e-6 for gradients near zero): f32 on both sides, the matched-GT lookup
is a gather here and a one-hot product there, sums in another order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asy_vrnet_tpu.ops import boxes as jboxes
from asy_vrnet_tpu.ops import losses_det as jdet

from asy_vrnet_tpu_torch.ops import boxes as tboxes
from asy_vrnet_tpu_torch.ops import losses_det as tdet

C = 4


def _case(seed, boxes_list, b=2, scale=0.5):
    rng = np.random.default_rng(seed)
    det = [(rng.standard_normal((b, n, n, 5 + C)) * scale).astype(np.float32)
           for n in (8, 4, 2)]
    return det, boxes_list


CASES = {
    "two_and_none": _case(5, [np.array([[20.0, 20.0, 12.0, 10.0, 1], [40.0, 44.0, 8.0, 8.0, 2]]),
                              np.zeros((0, 5))]),
    "crowded": _case(6, [np.array([[16.0, 18.0, 20.0, 14.0, 0], [22.0, 20.0, 18.0, 16.0, 3],
                                   [44.0, 40.0, 24.0, 22.0, 2]]),
                         np.array([[32.0, 32.0, 30.0, 28.0, 1]])]),
    "no_gt_at_all": _case(7, [np.zeros((0, 5)), np.zeros((0, 5))]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_yolox_loss_value_and_grads_match_jax(case):
    det, boxes_list = CASES[case]
    jgt = jdet.pad_gt_boxes(boxes_list, 16)
    tgt = tdet.pad_gt_boxes(boxes_list, 16)
    for a, b in zip(jgt, tgt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    def jloss(dets):
        total, aux = jdet.yolox_loss(dets, *jgt)
        return total, aux

    (jtotal, jaux), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        [jnp.asarray(d) for d in det])
    tdets = [torch.from_numpy(d).requires_grad_(True) for d in det]
    total, aux = tdet.yolox_loss(tdets, *tgt)
    total.backward()
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-4)
    for got, want in zip(aux, jaux):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-4, atol=1e-7)
    assert aux.num_fg.item() == float(jaux.num_fg)
    for t, g in zip(tdets, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-6)
        assert np.abs(np.asarray(g)).max() > 0


def test_loss_weights_and_options_reach_the_terms():
    det, boxes_list = CASES["crowded"]
    tgt = tdet.pad_gt_boxes(boxes_list, 16)
    tdets = [torch.from_numpy(d) for d in det]
    _, aux = tdet.yolox_loss(tdets, *tgt)
    total, _ = tdet.yolox_loss(tdets, *tgt, iou_weight=3.0, obj_weight=0.5, cls_weight=0.0)
    want = 3.0 * aux.loss_iou + 0.5 * aux.loss_obj
    np.testing.assert_allclose(total.item(), want.item(), rtol=1e-6)


def test_decode_for_loss_and_iou_loss_match_jax():
    det, _ = CASES["crowded"]
    jout, jgrid, jsv = jax.jit(lambda d: jboxes.decode_for_loss(d, (8, 16, 32)))(
        [jnp.asarray(d) for d in det])
    tout, tgrid, tsv = tboxes.decode_for_loss([torch.from_numpy(d) for d in det], (8, 16, 32))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tgrid.numpy(), np.asarray(jgrid))
    np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv))
    rng = np.random.default_rng(8)
    a = np.concatenate([rng.uniform(10, 50, (40, 2)), rng.uniform(4, 30, (40, 2))], -1)
    b = a + rng.uniform(-6, 6, a.shape)
    a, b = a.astype(np.float32), np.abs(b).astype(np.float32)
    want = np.asarray(jax.jit(jboxes.iou_loss_squared)(a, b))
    got = tboxes.iou_loss_squared(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_bce_with_logits_matches_jax():
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(200) * 6).astype(np.float32)
    t = rng.random(200).astype(np.float32)
    want = np.asarray(jax.jit(jdet._bce_with_logits)(x, t))
    got = tdet._bce_with_logits(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
