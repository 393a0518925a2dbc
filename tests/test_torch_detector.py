"""Detector (letterbox -> forward -> decode -> NMS -> boxes) of the port
against the JAX package's Detector, on PIL requests at 64x64, f32 and the
same random weights: detect, draw, heatmap, write_map_txt, the get_map and
predict CLIs on a 4-image set, and the torch.export round trip.  Boxes are
in original-image pixels: atol 1e-3 px (the forwards agree to ~1e-5 in f32,
see test_torch_model.py).  One JAX model for the whole module."""
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from asy_vrnet_tpu.config import ModelConfig as JaxModelConfig
from asy_vrnet_tpu.infer.predictor import Detector as JaxDetector
from asy_vrnet_tpu.metrics.map import DetectionEvaluator as JaxEvaluator

from asy_vrnet_tpu_torch.config import ModelConfig
from asy_vrnet_tpu_torch.infer.predictor import Detector

from torch_parity import (  # noqa: F401
    cli_dryrun_widths,
    config_kwargs,
    noisy_model_pair,
    one_torch_thread,
)

SIZE = 64
CLASSES = ["pier", "buoy", "sailor", "ship"]


@pytest.fixture(scope="module")
def detectors():
    """The same noised weights in both packages (`noisy_model_pair`: no JAX
    initialisation is compiled; the JAX Detector compiles its forward)."""
    jcfg, tcfg = JaxModelConfig(**config_kwargs(SIZE)), ModelConfig(**config_kwargs(SIZE))
    _, params, bstats, port = noisy_model_pair(jcfg, tcfg, SIZE, seed=1)
    kw = dict(conf_thres=0.2, nms_thres=0.3, max_det=30)
    jd = JaxDetector(jcfg, {"params": params, "batch_stats": bstats}, CLASSES, **kw)
    td = Detector(tcfg, CLASSES, model=port.eval(), **kw)
    return jd, td


def _request(seed, wh):
    rng = np.random.default_rng(seed)
    image = Image.fromarray(rng.integers(0, 256, (wh[1], wh[0], 3), dtype=np.uint8))
    radar = (rng.random((4, SIZE, SIZE)) * 20.0 - 5.0).astype(np.float32)
    return image, radar


@pytest.mark.parametrize("seed,wh", [(0, (96, 72)), (1, (50, 80))])
def test_detector_matches_jax(detectors, seed, wh):
    jd, td = detectors
    image, radar = _request(seed, wh)
    ref = jd.detect(image, radar)
    out = td.detect(image, radar)
    assert len(ref["boxes"]) >= 1
    assert set(out) == set(ref)
    np.testing.assert_array_equal(out["classes"], ref["classes"])
    np.testing.assert_allclose(out["boxes"], ref["boxes"], atol=1e-3)
    for k in ("scores", "obj", "class_conf"):
        np.testing.assert_allclose(out[k], ref[k], atol=1e-5)


def test_draw_matches_jax(detectors):
    """Both packages' draw, fed the same JAX result: the same image.  The
    JAX package's draw raises on a box whose outline ring is empty (off the
    image, or thinner than the outline: PIL refuses an inverted rectangle),
    so the comparison takes the boxes it can draw; the port skips such a
    ring and draws the rest."""
    jd, td = detectors
    image, radar = _request(2, (96, 72))
    res = jd.detect(image, radar, conf_thres=0.05)
    thick = max(1, int(2 * max(image.size) / SIZE))
    t, l, b, r = res["boxes"].T
    ok = ((np.minimum(image.size[0], r.astype(int)) - 2 * (thick - 1) >= np.maximum(0, l.astype(int)))
          & (np.minimum(image.size[1], b.astype(int)) - 2 * (thick - 1)
             >= np.maximum(0, t.astype(int))))
    assert 1 <= ok.sum() < len(ok)
    drawable = {k: v[ok] for k, v in res.items()}
    np.testing.assert_array_equal(np.asarray(td.draw(image, drawable)),
                                  np.asarray(jd.draw(image, drawable)))
    with pytest.raises(ValueError):
        jd.draw(image, res)
    assert td.draw(image, res).size == image.size


def test_heatmap_matches_jax(detectors):
    jd, td = detectors
    image, radar = _request(3, (80, 50))
    ref = jd.heatmap(image, radar)
    out = td.heatmap(image, radar)
    assert out.shape == ref.shape == (SIZE, SIZE)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def _map_lines(path):
    with open(path) as f:
        return [line.split() for line in f.read().splitlines()]


def test_write_map_txt_matches_jax(detectors, tmp_path):
    """The same lines: class names equal, scores within 1e-5, the integer
    pixel coordinates within 1 px (a truncation can fall either way)."""
    jd, td = detectors
    image, radar = _request(4, (96, 72))
    jd.write_map_txt("x", image, radar, str(tmp_path / "jax"))
    td.write_map_txt("x", image, radar, str(tmp_path / "port"))
    ref, out = _map_lines(tmp_path / "jax" / "x.txt"), _map_lines(tmp_path / "port" / "x.txt")
    assert len(ref) >= 1 and len(out) == len(ref)
    for a, b in zip(out, ref):
        assert a[0] == b[0]
        np.testing.assert_allclose(float(a[1]), float(b[1]), atol=1e-5)
        np.testing.assert_allclose(np.array(a[2:], int), np.array(b[2:], int), atol=1)


@pytest.fixture(scope="module")
def val_set(detectors, tmp_path_factory):
    """A 4-image learnable set at 64x64 whose ground truth is, per image, the
    set's own box plus the JAX detector's three best boxes at conf 0.05
    (rounded), so that AP is neither 0 nor 1; and the pair's weights as a
    weights-only npz."""
    from asy_vrnet_tpu_torch.data.synthetic import write_learnable_voc_dataset
    from asy_vrnet_tpu_torch.train.checkpoint import save_weights

    jd, td = detectors
    root = tmp_path_factory.mktemp("val")
    meta = write_learnable_voc_dataset(str(root), num_images=4, hw=(SIZE, SIZE))
    lines = []
    with open(meta["annotation_path"]) as f:
        for line in f.read().splitlines():
            path = line.split()[0]
            image_id = os.path.splitext(os.path.basename(path))[0]
            radar = np.load(os.path.join(meta["radar_root"], image_id + ".npz"))["arr_0"]
            res = jd.detect(Image.open(path), radar, conf_thres=0.05)
            extra = [f"{int(l)},{int(t)},{int(r)},{int(b)},{int(c)}" for (t, l, b, r), c in
                     zip(res["boxes"][:3], res["classes"][:3])]
            lines.append(" ".join([line] + extra))
    with open(meta["annotation_path"], "w") as f:
        f.write("\n".join(lines) + "\n")
    weights = str(root / "weights.npz")
    save_weights(weights, td.model.state_dict())
    return meta, weights


def _cli_model_flags(weights):
    return ["--weights", weights, "--device", "cpu", "--compute-dtype", "float32",
            "--input-size", str(SIZE)]


def test_get_map_cli_matches_jax_evaluator(detectors, val_set, cli_dryrun_widths):
    """The port's get_map CLI (its own model from the npz, one Detector.detect
    an image at conf 0.05) against JAX's DetectionEvaluator on the JAX
    Detector's outputs for the same images: AP per class and mean, COCO and
    VOC, to 1e-6."""
    from asy_vrnet_tpu.data.dataset import parse_annotation_line, read_annotation_file

    from asy_vrnet_tpu_torch.cli import get_map

    from asy_vrnet_tpu.data.preprocess import get_classes

    jd, _ = detectors
    meta, weights = val_set
    names, _ = get_classes(meta["classes_path"])
    out = get_map.main(["--val-annotation", meta["annotation_path"], "--classes",
                        meta["classes_path"], "--radar-root", meta["radar_root"],
                        "--nms-iou", "0.3", "--max-det", "30"] + _cli_model_flags(weights))
    ev = JaxEvaluator(names, iou_threshold=0.5, max_dets=30)
    for line in read_annotation_file(meta["annotation_path"]):
        path, gt, image_id = parse_annotation_line(line)
        radar = np.load(os.path.join(meta["radar_root"], image_id + ".npz"))["arr_0"]
        res = jd.detect(Image.open(path), radar, conf_thres=0.05)
        ev.add_image(res["boxes"][:, [1, 0, 3, 2]], res["scores"], res["classes"],
                     gt[:, :4], gt[:, 4].astype(int))
    for method in ("coco", "voc"):
        ref = ev.evaluate(method)
        assert 0.0 < ref["map"] < 1.0
        np.testing.assert_allclose(out[method]["map"], ref["map"], atol=1e-6)
        for name in names:
            np.testing.assert_allclose(out[method]["ap_per_class"][name],
                                       ref["ap_per_class"][name], atol=1e-6, equal_nan=True)


def test_predict_cli_writes_its_files(val_set, tmp_path, cli_dryrun_widths):
    from asy_vrnet_tpu_torch.cli import predict

    meta, weights = val_set
    images = os.path.join(os.path.dirname(meta["annotation_path"]), "JPEGImages")
    names = sorted(os.listdir(images))
    first = os.path.join(images, names[0])
    radar = os.path.join(meta["radar_root"], os.path.splitext(names[0])[0] + ".npz")
    common = ["--classes", meta["classes_path"], "--conf", "0.05"] + _cli_model_flags(weights)
    for mode, image, rad, want in (("predict", first, radar, [names[0]]),
                                   ("heatmap", first, radar, ["heatmap.png"]),
                                   ("dir_predict", images, meta["radar_root"], names),
                                   ("map_txt", images, meta["radar_root"],
                                    [os.path.splitext(n)[0] + ".txt" for n in names])):
        out = str(tmp_path / mode)
        predict.main(["--mode", mode, "--image", image, "--radar", rad, "--out", out] + common)
        assert sorted(os.listdir(out)) == sorted(want), mode
    with open(os.path.join(str(tmp_path / "map_txt"), os.path.splitext(names[0])[0] + ".txt")) as f:
        assert len(f.read().splitlines()) >= 1


def test_video_mode_without_cv2_names_it(val_set, tmp_path, monkeypatch, cli_dryrun_widths):
    """The video modes need OpenCV, which the card machine lacks: without
    it they stop with a SystemExit that names the module, as the JAX CLIs
    fail (nothing skips the mode silently)."""
    import sys

    from asy_vrnet_tpu_torch.cli import predict, predict_seg

    meta, weights = val_set
    monkeypatch.setitem(sys.modules, "cv2", None)
    common = ["--mode", "video", "--video", str(tmp_path / "in.mp4"), "--radar",
              meta["radar_root"], "--out", str(tmp_path / "out")] + _cli_model_flags(weights)
    for cli, extra in ((predict, ["--classes", meta["classes_path"]]), (predict_seg, [])):
        with pytest.raises(SystemExit, match="cv2"):
            cli.main(common + extra)


def test_export_round_trip(detectors, tmp_path):
    """export_program with max_det 8 on the CPU (the plain path), saved and
    loaded: its detections and seg softmax equal the eager graph's bits;
    against JAX's forward (batch 1, the jitted forward the heatmap test
    compiled), its seg softmax agrees to 1e-5 and its kept boxes, scores and
    classes equal JAX's NMS of JAX's raw outputs to 1e-5."""
    from asy_vrnet_tpu.ops.boxes import decode_predictions as j_decode
    from asy_vrnet_tpu.ops.nms import non_max_suppression as j_nms

    from asy_vrnet_tpu_torch.infer.export import ServingGraph, export_program, load_exported

    jd, td = detectors
    cfg = td.cfg
    rng = np.random.default_rng(5)
    img = rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
    rad = rng.random((1, SIZE, SIZE, 4)).astype(np.float32)
    kw = dict(conf_thres=0.05, nms_thres=0.5, max_det=8)
    path = export_program(td.model, cfg, str(tmp_path / "p.pt2"), **kw)
    dets, seg = load_exported(path)(torch.from_numpy(img), torch.from_numpy(rad))
    with torch.no_grad():
        ref_dets, ref_seg = ServingGraph(td.model, cfg, **kw)(
            torch.from_numpy(img), torch.from_numpy(rad))
    assert int(ref_dets["valid"].sum()) >= 1 and tuple(ref_dets["valid"].shape) == (1, 8)
    for k in ref_dets:
        torch.testing.assert_close(dets[k], ref_dets[k], rtol=0, atol=0)
    torch.testing.assert_close(seg, ref_seg, rtol=0, atol=0)

    jdet, jseg = jd._forward(jd.variables, jnp.asarray(img), jnp.asarray(rad))
    np.testing.assert_allclose(seg.numpy(), np.asarray(jnp.exp(jseg) / jnp.exp(jseg).sum(
        -1, keepdims=True)), atol=1e-5)
    jout = j_nms(j_decode(jdet, (SIZE, SIZE)), 4, conf_thres=0.05, nms_thres=0.5, max_out=8)
    valid = np.asarray(jout["valid"])
    np.testing.assert_array_equal(dets["valid"].numpy(), valid)
    np.testing.assert_array_equal(dets["classes"].numpy()[valid], np.asarray(jout["classes"])[valid])
    for k in ("boxes_xyxy", "scores"):
        np.testing.assert_allclose(dets[k].numpy()[valid], np.asarray(jout[k])[valid], atol=1e-5)
