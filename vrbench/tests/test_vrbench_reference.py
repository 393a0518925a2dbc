"""The frozen reference against the port's plain path on the CPU, at a tiny
size (`coc_dryrun`, 64x64, f32), on the same seeded weights and inputs: the
forward in both modes, the losses, one train step's update and EMA, and the
serving pipeline's outputs."""
from __future__ import annotations

import dataclasses
import json
import os

import pytest
import torch

from vrbench import run
from vrbench.common import program_config
from vrbench.reference import serve as ref_serve
from vrbench.reference import train as ref_train
from vrbench.reference.model import EfficientVRNet
from vrbench.traffic import serve as serve_traffic
from vrbench.traffic import train as train_traffic
from vrbench.weights import make_weights

CPU = torch.device("cpu")
TINY = {"variant": "coc_dryrun", "input_size": [64, 64], "compute_dtype": "float32"}


def _cfg(config="vrnet-nano"):
    with open(os.path.join(run.HERE, "configs", f"{config}.json")) as fh:
        cfg = json.load(fh)
    return {**cfg, "model": {**cfg["model"], **TINY}}


def _port_model(cfg, sd):
    from asy_vrnet_tpu_torch.models.efficient_vrnet import create_model

    mc = program_config(cfg).model
    model = create_model(dataclasses.replace(mc, use_pallas_cluster=False), CPU)
    model.load_state_dict(sd)
    return model


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    mix = {**run.cell_spec("nano-train-b256")[2], "batch": 3, "pool": 3}
    pool = train_traffic.make_pool(cfg, mix, 11, CPU)
    sd = make_weights(cfg["model"], 11, CPU)
    return cfg, mix, pool, sd


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_forward(setup, mode):
    cfg, _, pool, sd = setup
    port, ref = _port_model(cfg, sd), EfficientVRNet(cfg["model"])
    ref.load_state_dict(sd)
    image = ref_train.normalize_image(pool[0]["image"])
    getattr(port, mode)()
    getattr(ref, mode)()
    with torch.no_grad():
        (pd, ps), (rd, rs) = port(image, pool[0]["radar"]), ref(image, pool[0]["radar"])
    for a, b in zip(pd, rd):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))
    torch.testing.assert_close(ps, rs, rtol=1e-4, atol=1e-4)


def test_losses(setup):
    from asy_vrnet_tpu_torch.train.train_step import detection_loss, seg_loss_and_fscore

    cfg, _, pool, sd = setup
    ref = EfficientVRNet(cfg["model"])
    ref.load_state_dict(sd)
    batch = pool[1]
    with torch.no_grad():
        det, seg = ref.train()(ref_train.normalize_image(batch["image"]), batch["radar"])
    pcfg = program_config(cfg)
    want_det, _ = detection_loss(pcfg, det, batch)
    want_seg, _ = seg_loss_and_fscore(pcfg, seg, batch)
    m = cfg["model"]
    got_det = ref_train.yolox_loss(det, batch["gt_boxes"], batch["gt_classes"],
                                   batch["gt_valid"], tuple(m["head_strides"]), m["num_classes"])
    got_seg = ref_train.seg_loss(seg, batch["seg_target"], m["num_seg_classes"])
    torch.testing.assert_close(got_det, want_det, rtol=1e-5, atol=0)
    torch.testing.assert_close(got_seg, want_seg, rtol=1e-5, atol=0)


def test_step_update_and_ema(setup):
    """Three steps of the port's train step (plain path) against the
    reference's: losses, the first gradient, each leaf's change, the EMA."""
    cfg, mix, pool, sd = setup
    mix = {**mix, "checked_steps": 3}
    driver = train_traffic.Driver(cfg, mix, 11, CPU)
    ref = driver.reference()
    prog = driver.summary
    for p, r in zip(prog["losses"], ref["losses"]):
        assert abs(p - r) <= 1e-5 * abs(r)
    nums = train_traffic.numbers(prog, ref)
    assert nums["grad_gap"] < 1e-3 and nums["change_gap"] < 1e-3 and nums["ema_gap"] < 1e-3


def test_pipeline_outputs():
    """The port's fused pipeline (plain path) against the reference's
    letterbox, projection, forward, decode and NMS."""
    cfg = _cfg()
    mix = {**run.cell_spec("s-serve-b256")[2], "batch": 2, "pool": 1,
           "frame_hw": [96, 128], "radar_points": 64, "valid_points": [8, 64],
           "early_requests": 1, "sampled_requests": 1, "warmup_requests": 1}
    driver = serve_traffic.Driver(cfg, mix, 5, CPU)
    driver.iterate()
    _, det, seg = driver.outputs()[-1]
    pred, probs = driver.reference(0)
    nums = serve_traffic.det_numbers(det, seg, pred, probs, mix, driver.input_hw,
                                     cfg["model"]["num_classes"])
    assert nums["det_unmatched"] == 0 and nums["nms_overlap"] == 0
    assert int(det["valid"].sum()) > 0
    assert nums["det_worst"] < 1e-4 and nums["seg_prob_max_gap"] < 1e-4
    frames, pts, valid = driver.pool[0]
    from asy_vrnet_tpu_torch.infer.pipeline import device_letterbox
    from asy_vrnet_tpu_torch.ops.radar import project_points_to_rvep

    torch.testing.assert_close(ref_serve.letterbox(frames, (64, 64)),
                               device_letterbox(frames, (64, 64)), rtol=1e-5, atol=1e-5)
    want = project_points_to_rvep(pts, valid, (64, 64))
    lo, hi = want.amin(dim=(1, 2, 3), keepdim=True), want.amax(dim=(1, 2, 3), keepdim=True)
    torch.testing.assert_close(ref_serve.rvep(pts, valid, (64, 64)),
                               (want - lo) / (hi - lo + 1e-12) + 1e-13)
