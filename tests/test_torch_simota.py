"""The port's SimOTA (the plain twin of its CUDA kernel) against the JAX
package, on the CPU: against the fused Pallas kernel in interpret mode
(`simota_assign_batched(use_pallas=True)`) and against the jnp path.

Inputs are the ragged cases of tests/test_simota.py (anchors of a 64^2 input,
G = 8 padded GT rows), made with numpy from a seed.  Tolerances: the fg mask,
the matched GT and num_fg are equal; the matched IoU agrees to atol 1e-6
(f32 on both sides, the same formula).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asy_vrnet_tpu.ops import boxes as jboxes
from asy_vrnet_tpu.ops.simota_pallas import simota_assign_batched as j_assign

from asy_vrnet_tpu_torch.ops import boxes as tboxes
from asy_vrnet_tpu_torch.ops import simota_fused
from asy_vrnet_tpu_torch.ops.simota import simota_assign
from asy_vrnet_tpu_torch.ops.simota_fused import simota_assign_batched

G, C, SIZE = 8, 4, 64


def _anchors():
    level_hw = tuple((SIZE // s, SIZE // s) for s in (8, 16, 32))
    grids, strides = tboxes.make_grids_and_strides(level_hw, (8, 16, 32))
    return grids.numpy(), strides.numpy()


def _image(seed, num_gt):
    """One image's predictions and padded GT rows, as tests/test_simota.py
    draws them."""
    rng = np.random.default_rng(seed)
    grids, strides = _anchors()
    a = grids.shape[0]
    pred_xy = (grids + rng.uniform(-1, 1, grids.shape)) * strides[:, None]
    pred_wh = np.exp(rng.uniform(-1, 1, grids.shape)) * strides[:, None]
    pred = np.concatenate([pred_xy, pred_wh], -1).astype(np.float32)
    cls = rng.standard_normal((a, C)).astype(np.float32)
    obj = rng.standard_normal(a).astype(np.float32)
    gb = np.zeros((G, 4), np.float32)
    gc = np.zeros(G, np.int32)
    gv = np.zeros(G, bool)
    for i in range(num_gt):
        gb[i] = np.concatenate([rng.uniform(8, SIZE - 8, 2), rng.uniform(6, 24, 2)])
    gc[:num_gt] = rng.integers(0, C, num_gt)
    gv[:num_gt] = True
    return pred, cls, obj, gb, gc, gv


def _tie_image():
    """Constructed ties: GT rows 1 and 2 are the same box and class, and every
    anchor of the 8x8 level carries one and the same prediction (the GT's
    box), so equal costs and equal IoUs abound.  Only first-index argmax and
    argmin reproduce the reference."""
    pred, cls, obj, gb, gc, gv = _image(11, 3)
    gb[2], gc[2] = gb[1], gc[1]
    pred[:64] = gb[1]
    cls[:64] = cls[0]
    obj[:64] = obj[0]
    return pred, cls, obj, gb, gc, gv


def _stack(images):
    return [np.stack([im[i] for im in images]) for i in range(6)]


CASES = {
    "3_and_1": lambda: _stack([_image(0, 3), _image(1, 1)]),
    "7_and_none": lambda: _stack([_image(2, 7), _image(3, 0)]),
    "full_rows": lambda: _stack([_image(4, 8), _image(5, 5)]),
    "ties": lambda: _stack([_tie_image(), _tie_image()]),
}


def _port(batch):
    grids, strides = _anchors()
    args = [torch.from_numpy(x) for x in (*batch, grids, strides)]
    return simota_assign_batched(*args)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "jnp"])
@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_jax(case, use_pallas):
    batch = CASES[case]()
    grids, strides = _anchors()
    ref = jax.jit(lambda *a: j_assign(*a, use_pallas=use_pallas))(
        *[jnp.asarray(x) for x in (*batch, grids, strides)])
    got = _port(batch)
    fg = np.asarray(ref.fg_mask)
    np.testing.assert_array_equal(got.fg_mask.numpy(), fg)
    np.testing.assert_array_equal(got.num_fg.numpy(), np.asarray(ref.num_fg))
    np.testing.assert_array_equal(got.matched_gt.numpy()[fg], np.asarray(ref.matched_gt)[fg])
    np.testing.assert_allclose(got.pred_iou.numpy(), np.asarray(ref.pred_iou), atol=1e-6)
    if case != "7_and_none":
        assert fg.any(axis=1).all()


def test_no_gt_image_assigns_nothing():
    pred, cls, obj, gb, gc, gv = _image(6, 0)
    grids, strides = _anchors()
    res, dyn = simota_assign(*[torch.from_numpy(x) for x in
                               (pred, cls, obj, gb, gc, gv, grids, strides)],
                             return_dynamic_ks=True)
    assert res.num_fg.item() == 0 and not res.fg_mask.any()
    assert torch.equal(res.matched_gt, torch.zeros_like(res.matched_gt))
    assert torch.equal(res.pred_iou, torch.zeros_like(res.pred_iou))
    assert torch.equal(dyn, torch.zeros(G, dtype=torch.int32))


def test_ties_take_the_first_index():
    """In the constructed case the duplicated GT (row 2) has the same cost
    row as its first copy (row 1) and picks the same anchors, so every one of
    its picks is a conflict between equal costs: the first index, row 1, must
    win them all, and the anchors inside the box and centre window (the only
    ones without the 1e5 penalty) must be among the picks."""
    from asy_vrnet_tpu_torch.ops.simota import in_boxes_info

    pred, cls, obj, gb, gc, gv = _tie_image()
    grids, strides = _anchors()
    targs = [torch.from_numpy(x) for x in (pred, cls, obj, gb, gc, gv, grids, strides)]
    res = simota_assign(*targs)
    m = res.matched_gt[res.fg_mask]
    assert (m == 1).any() and not (m == 2).any()
    _, in_box, in_center = in_boxes_info(targs[3], targs[5], targs[6], targs[7])
    inside = (in_box & in_center)[1, :64]
    assert inside.any()
    assert (res.fg_mask[:64][inside] & (res.matched_gt[:64][inside] == 1)).all()


def test_dynamic_k_truncates_and_clips():
    pred, cls, obj, gb, gc, gv = _image(7, 4)
    grids, strides = _anchors()
    args = [torch.from_numpy(x) for x in (pred, cls, obj, gb, gc, gv, grids, strides)]
    _, dyn = simota_assign(*args, return_dynamic_ks=True)
    assert dyn.dtype == torch.int32
    assert ((dyn[:4] >= 1) & (dyn[:4] <= 10)).all() and (dyn[4:] == 0).all()
    _, dyn3 = simota_assign(*args, candidate_k=3, return_dynamic_ks=True)
    assert (dyn3[:4] <= 3).all()


def test_pairwise_iou_forms_agree():
    """`boxes.pairwise_iou_cxcywh` equals JAX's, and the twin's clamped form
    (the kernel's) equals both on boxes with area."""
    from asy_vrnet_tpu_torch.ops.simota import _pairwise_iou

    pred, _, _, gb, _, _ = _image(8, 8)
    want = np.asarray(jax.jit(jboxes.pairwise_iou_cxcywh)(gb, pred))
    got = tboxes.pairwise_iou_cxcywh(torch.from_numpy(gb), torch.from_numpy(pred))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(
        _pairwise_iou(torch.from_numpy(gb), torch.from_numpy(pred)).numpy(), want, atol=1e-6)


def test_kernel_is_never_taken_on_the_cpu():
    batch = CASES["3_and_1"]()
    grids, strides = _anchors()
    args = [torch.from_numpy(x) for x in (*batch, grids, strides)]
    with pytest.raises(ValueError, match="CUDA"):
        simota_assign_batched(*args, use_kernel=True)
    res, dyn = simota_assign_batched(*args, return_dynamic_ks=True)
    assert dyn.shape == (2, G) and res.fg_mask.shape == (2, grids.shape[0])
    assert simota_fused.LAUNCHES == {"simota_assign": 0}
