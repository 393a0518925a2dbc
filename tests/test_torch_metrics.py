"""The port's metrics (`asy_vrnet_tpu_torch/metrics/`) against the JAX
package's, on the CPU: the same seeded detections, ground truths and label
maps give exactly equal results (pure numpy on both sides, the same
arithmetic in the same order)."""
import os
import sys

import numpy as np
import pytest

from tests.torch_parity import one_torch_thread  # noqa: F401

from asy_vrnet_tpu.metrics import map as jmap
from asy_vrnet_tpu.metrics import miou as jmiou
from asy_vrnet_tpu.metrics import plots as jplots

from asy_vrnet_tpu_torch.metrics import map as tmap
from asy_vrnet_tpu_torch.metrics import miou as tmiou
from asy_vrnet_tpu_torch.metrics import plots as tplots

CLASSES = ["pier", "vessel", "ship", "boat", "buoy"]


def _images(seed: int, n: int = 6):
    """Seeded per-image (det boxes, scores, classes, gt boxes, gt classes,
    difficult): class 3 has detections and no GT, class 4 GT and no
    detections; some detections are duplicates of GTs or of each other, and
    some scores tie."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        g = int(rng.integers(1, 5))
        xy = rng.uniform(0, 80, (g, 2))
        gt = np.concatenate([xy, xy + rng.uniform(8, 40, (g, 2))], -1)
        gcls = rng.choice([0, 1, 2, 4], g)
        diff = rng.random(g) < 0.15
        dets = [gt + rng.normal(0, 3, gt.shape)]
        dets.append(gt[: max(1, g // 2)] + rng.normal(0, 1, (max(1, g // 2), 4)))  # duplicates
        xy = rng.uniform(0, 80, (3, 2))
        dets.append(np.concatenate([xy, xy + rng.uniform(5, 30, (3, 2))], -1))    # strays
        det = np.concatenate(dets)
        dcls = np.concatenate([gcls, gcls[: max(1, g // 2)], rng.choice([0, 1, 2, 3], 3)])
        dcls = np.where(dcls == 4, 3, dcls)
        scores = np.round(rng.uniform(0.05, 1.0, len(det)), 1)                   # ties
        out.append((det, scores, dcls, gt, gcls, diff))
    return out


def _evaluators(images, max_dets=100):
    evs = [jmap.DetectionEvaluator(CLASSES, 0.5, max_dets),
           tmap.DetectionEvaluator(CLASSES, 0.5, max_dets)]
    for ev in evs:
        for img in images:
            ev.add_image(*img)
    return evs


def _assert_results_equal(a: dict, b: dict):
    assert a["num_images"] == b["num_images"]
    assert a["map"] == b["map"]
    assert list(a["ap_per_class"]) == list(b["ap_per_class"])
    for name, v in a["ap_per_class"].items():
        w = b["ap_per_class"][name]
        assert (np.isnan(v) and np.isnan(w)) or v == w, name
    for name, ca in a["curves"].items():
        cb = b["curves"][name]
        assert set(ca) == set(cb)
        for k, v in ca.items():
            np.testing.assert_array_equal(np.asarray(cb[k]), np.asarray(v), err_msg=f"{name} {k}")


@pytest.mark.parametrize("method", ["coco", "voc"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detection_evaluator_matches_jax(method, seed):
    ja, po = _evaluators(_images(seed))
    want, got = ja.evaluate(method), po.evaluate(method)
    _assert_results_equal(want, got)
    assert np.isnan(got["ap_per_class"]["boat"]) and got["curves"]["boat"]["num_det"] > 0
    assert got["ap_per_class"]["buoy"] == 0.0 and got["curves"]["buoy"]["num_gt"] > 0


def test_max_dets_cap_matches_jax():
    ja, po = _evaluators(_images(3), max_dets=4)
    _assert_results_equal(ja.evaluate("coco"), po.evaluate("coco"))


@pytest.mark.parametrize("seed", [0, 1])
def test_ap_and_lamr_functions_match_jax(seed):
    rng = np.random.default_rng(seed)
    tp = rng.random(40) < 0.6
    tp_cum, fp_cum = np.cumsum(tp), np.cumsum(~tp)
    rec, prec = tp_cum / 30.0, tp_cum / (tp_cum + fp_cum)
    assert tmap.voc_ap(rec, prec) == jmap.voc_ap(rec, prec)
    assert tmap.coco_ap_from_pr(rec, prec) == jmap.coco_ap_from_pr(rec, prec)
    assert tmap.coco_ap_from_pr(np.zeros(0), np.zeros(0)) == 0.0
    for args in ((prec, fp_cum.astype(np.float64), 7), (np.zeros(0), np.zeros(0), 1)):
        want, got = jmap.log_average_miss_rate(*args), tmap.log_average_miss_rate(*args)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)


def _write_txt_dirs(root, images):
    for sub in ("ground-truth", "detection-results"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i, (det, scores, dcls, gt, gcls, diff) in enumerate(images):
        with open(os.path.join(root, "ground-truth", f"img{i}.txt"), "w") as f:
            for b, c, d in zip(gt, gcls, diff):
                f.write(f"{CLASSES[c]} {b[0]:.1f} {b[1]:.1f} {b[2]:.1f} {b[3]:.1f}"
                        + (" difficult\n" if d else "\n"))
            f.write("unknown_class 1 2 3 4\n")
        if i == 1:
            continue                                   # an image without detections
        with open(os.path.join(root, "detection-results", f"img{i}.txt"), "w") as f:
            for b, s, c in zip(det, scores, dcls):
                f.write(f"{CLASSES[c]} {s} {b[0]:.1f} {b[1]:.1f} {b[2]:.1f} {b[3]:.1f}\n")


@pytest.mark.parametrize("method", ["coco", "voc"])
def test_evaluate_txt_dirs_matches_jax(tmp_path, method):
    _write_txt_dirs(str(tmp_path), _images(4))
    want = jmap.evaluate_txt_dirs(str(tmp_path), CLASSES, method=method)
    got = tmap.evaluate_txt_dirs(str(tmp_path), CLASSES, method=method)
    _assert_results_equal(want, got)
    assert got["num_images"] == 6


def _label_maps(seed, n=3, hw=(24, 20), classes=6):
    """Label maps with the ignore class (== classes) and 255, predictions."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes + 1, (n, *hw)).astype(np.uint8)
    labels[:, :2, :3] = 255
    preds = np.where(rng.random((n, *hw)) < 0.7, np.minimum(labels, classes - 1),
                     rng.integers(0, classes, (n, *hw))).astype(np.uint8)
    return labels, preds


def test_fast_hist_and_accumulator_match_jax():
    labels, preds = _label_maps(0)
    np.testing.assert_array_equal(
        tmiou.fast_hist(labels.flatten(), preds.flatten(), 6),
        jmiou.fast_hist(labels.flatten(), preds.flatten(), 6))
    ja, po = jmiou.MIoUAccumulator(6), tmiou.MIoUAccumulator(6)
    for lab, pred in zip(labels, preds):
        ja.update(lab, pred)
        po.update(lab, pred)
    np.testing.assert_array_equal(po.hist, ja.hist)
    want, got = ja.result(), po.result()
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    for f in ("per_class_iu", "per_class_pa_recall", "per_class_precision"):
        np.testing.assert_array_equal(getattr(tmiou, f)(po.hist), getattr(jmiou, f)(ja.hist))
    assert tmiou.per_accuracy(po.hist) == jmiou.per_accuracy(ja.hist)


def test_compute_miou_dirs_and_save_results_match_jax(tmp_path, capsys, monkeypatch):
    from PIL import Image

    # the CSVs only: the bar plots are test_plots_return_what_jax_returns's
    monkeypatch.setitem(sys.modules, "matplotlib", None)

    labels, preds = _label_maps(1, n=12)
    ids = [f"im{i:02d}" for i in range(len(labels))]
    for d in ("gt", "pred"):
        os.makedirs(tmp_path / d)
    for i, lab, pred in zip(ids, labels, preds):
        Image.fromarray(lab).save(tmp_path / "gt" / f"{i}.png")
        Image.fromarray(pred).save(tmp_path / "pred" / f"{i}.png")
    Image.fromarray(preds[0][:10]).save(tmp_path / "pred" / f"{ids[3]}.png")  # skipped
    names = [f"c{k}" for k in range(6)]
    want = jmiou.compute_miou_dirs(str(tmp_path / "gt"), str(tmp_path / "pred"), ids, 6, names)
    jout = capsys.readouterr().out
    got = tmiou.compute_miou_dirs(str(tmp_path / "gt"), str(tmp_path / "pred"), ids, 6, names)
    assert capsys.readouterr().out == jout and "Skipping" in jout
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    jmiou.save_results(str(tmp_path / "j"), *want, names)
    tmiou.save_results(str(tmp_path / "t"), *got, names)
    for f in ("confusion_matrix.csv", "metrics.csv"):
        assert (tmp_path / "t" / f).read_text() == (tmp_path / "j" / f).read_text()
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))


def test_plots_return_what_jax_returns(tmp_path):
    # two classes: each class draws four curves, and matplotlib is slow
    res_j = jmap.DetectionEvaluator(CLASSES[:2])
    res_t = tmap.DetectionEvaluator(CLASSES[:2])
    for img in _images(0):
        res_j.add_image(*img)
        res_t.add_image(*img)
    res_j, res_t = res_j.evaluate("coco"), res_t.evaluate("coco")
    ious = np.array([0.5, np.nan, 0.25])
    names = ["a", "b", "c"]
    calls = [
        ("plot_loss_curves", lambda d: (str(d / "l.png"), [3.0, 2.0, 1.5], [3.1, 2.2, 1.7])),
        ("plot_loss_curves", lambda d: (str(d / "e.png"), [], [])),
        ("plot_metric_curve", lambda d: (str(d / "m.png"), [0, 1], [0.1, 0.4], "mAP50", "t")),
        ("plot_metric_curve", lambda d: (str(d / "n.png"), [], [], "mAP50")),
        ("plot_horizontal_bars", lambda d: (str(d / "h.png"), {"a": 0.5, "b": np.nan}, "t", "x")),
        ("plot_horizontal_bars", lambda d: (str(d / "g.png"), {}, "t", "x")),
        ("plot_pr_curve", lambda d: (str(d / "p.png"), np.array([0.1, 0.5]),
                                     np.array([1.0, 0.6]), "a", 0.4)),
        ("plot_score_curve", lambda d: (str(d / "s.png"), np.array([0.9, 0.5]),
                                        np.array([0.2, 0.6]), "a", "F1")),
    ]
    for name, args in calls:
        outs = []
        for mod, sub in ((jplots, "j"), (tplots, "t")):
            d = tmp_path / sub
            d.mkdir(exist_ok=True)
            outs.append(getattr(mod, name)(*args(d)))
        assert outs[0] == outs[1], name
    rel = lambda files, sub: sorted(os.path.relpath(f, tmp_path / sub) for f in files)  # noqa: E731
    assert rel(tplots.plot_detection_report(str(tmp_path / "t" / "r"), res_t), "t") == rel(
        jplots.plot_detection_report(str(tmp_path / "j" / "r"), res_j), "j")
    assert rel(tplots.plot_miou_results(str(tmp_path / "t" / "m"), ious, ious, ious, names),
               "t") == rel(jplots.plot_miou_results(str(tmp_path / "j" / "m"), ious, ious,
                                                    ious, names), "j")
