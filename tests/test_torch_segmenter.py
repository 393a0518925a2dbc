"""Segmenter (letterbox -> forward -> softmax -> crop -> resize) of the port
against the JAX package's Segmenter at 64x64, f32, the same random weights
and raw radar (the seg path's parity default): probabilities, masks, the
three renders, the mIoU PNGs, the get_miou CLI against JAX's scoring of
JAX's PNGs, the predict_seg CLI, and get_fps on the CPU.  One JAX model for
the whole module."""
import os

import numpy as np
import pytest
from PIL import Image

from asy_vrnet_tpu.config import ModelConfig as JaxModelConfig
from asy_vrnet_tpu.infer.predictor import Segmenter as JaxSegmenter
from asy_vrnet_tpu.metrics.miou import compute_miou_dirs as j_compute_miou_dirs

from asy_vrnet_tpu_torch.config import ModelConfig
from asy_vrnet_tpu_torch.infer.predictor import Segmenter

from torch_parity import (  # noqa: F401
    cli_dryrun_widths,
    config_kwargs,
    noisy_model_pair,
    one_torch_thread,
)

SIZE = 64
REQUESTS = [(0, (96, 72)), (1, (50, 80)), (2, (64, 64))]


@pytest.fixture(scope="module")
def segmenters():
    """The same noised weights in both packages (`noisy_model_pair`: no JAX
    initialisation is compiled; the JAX Segmenter compiles its forward)."""
    jcfg, tcfg = JaxModelConfig(**config_kwargs(SIZE)), ModelConfig(**config_kwargs(SIZE))
    _, params, bstats, port = noisy_model_pair(jcfg, tcfg, SIZE, seed=2)
    js = JaxSegmenter(jcfg, {"params": params, "batch_stats": bstats})
    ts = Segmenter(tcfg, model=port.eval())
    return js, ts


def _request(seed, wh):
    rng = np.random.default_rng(seed)
    image = Image.fromarray(rng.integers(0, 256, (wh[1], wh[0], 3), dtype=np.uint8))
    radar = (rng.random((4, SIZE, SIZE)) * 20.0 - 5.0).astype(np.float32)
    return image, radar


@pytest.fixture(scope="module")
def probs(segmenters):
    """Both packages' predict_probs for each request, computed once."""
    js, ts = segmenters
    return [(js.predict_probs(*_request(s, wh)), ts.predict_probs(*_request(s, wh)))
            for s, wh in REQUESTS]


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_predict_probs_matches_jax(probs, i):
    ref, out = probs[i]
    wh = REQUESTS[i][1]
    assert out.shape == ref.shape == (wh[1], wh[0], 9)
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_predict_mask_matches_jax_except_near_ties(segmenters, probs, i):
    """Equal masks, except at pixels whose two largest JAX probabilities lie
    within 1e-5 (either class is then within the probabilities' tolerance)."""
    js, ts = segmenters
    ref_p, _ = probs[i]
    image, radar = _request(*REQUESTS[i])
    ref, out = js.predict_mask(image, radar), ts.predict_mask(image, radar)
    top2 = np.sort(ref_p, axis=-1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]) <= 1e-5
    assert not np.any((out != ref) & ~near)
    assert near.mean() < 0.01


@pytest.mark.parametrize("mix_type", [0, 1, 2])
def test_detect_image_matches_jax(segmenters, mix_type):
    js, ts = segmenters
    js.mix_type = ts.mix_type = mix_type
    image, radar = _request(*REQUESTS[0])
    ref, out = js.detect_image(image, radar), ts.detect_image(image, radar)
    assert out.size == image.size
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_get_miou_png_is_the_mask(segmenters):
    js, ts = segmenters
    image, radar = _request(*REQUESTS[1])
    png = ts.get_miou_png(image, radar)
    assert png.mode == "L" and png.size == image.size
    np.testing.assert_array_equal(np.asarray(png), ts.predict_mask(image, radar).astype(np.uint8))
    np.testing.assert_array_equal(np.asarray(png), np.asarray(js.get_miou_png(image, radar)))


@pytest.fixture(scope="module")
def seg_set(segmenters, tmp_path_factory):
    """A 4-image learnable set at 64x64, the pair's weights as an npz and
    JAX's prediction PNGs of it."""
    from asy_vrnet_tpu_torch.data.dataset import parse_annotation_line, read_annotation_file
    from asy_vrnet_tpu_torch.data.synthetic import write_learnable_voc_dataset
    from asy_vrnet_tpu_torch.train.checkpoint import save_weights

    js, ts = segmenters
    root = tmp_path_factory.mktemp("seg")
    meta = write_learnable_voc_dataset(str(root), num_images=4, hw=(SIZE, SIZE))
    weights = str(root / "weights.npz")
    save_weights(weights, ts.model.state_dict())
    jax_pngs = root / "jax_pngs"
    jax_pngs.mkdir()
    ids = []
    for line in read_annotation_file(meta["annotation_path"]):
        path, _, image_id = parse_annotation_line(line)
        radar = np.load(os.path.join(meta["radar_root"], image_id + ".npz"))["arr_0"]
        js.get_miou_png(Image.open(path), radar).save(str(jax_pngs / (image_id + ".png")))
        ids.append(image_id)
    return meta, weights, str(jax_pngs), ids


def _cli_model_flags(weights):
    return ["--weights", weights, "--device", "cpu", "--compute-dtype", "float32",
            "--input-size", str(SIZE)]


def test_get_miou_cli_matches_jax(seg_set, tmp_path, cli_dryrun_widths):
    """The port's get_miou CLI (its own model from the npz) gives the
    confusion matrix that JAX's compute_miou_dirs gives on JAX's PNGs."""
    from asy_vrnet_tpu_torch.cli import get_miou

    meta, weights, jax_pngs, ids = seg_set
    out = str(tmp_path / "miou")
    hist, ious, _, _ = get_miou.main(
        ["--val-annotation", meta["annotation_path"], "--seg-path", meta["seg_dataset_path"],
         "--radar-root", meta["radar_root"], "--out", out] + _cli_model_flags(weights))
    gt_dir = os.path.join(meta["seg_dataset_path"], "VOC2007", "SegmentationClass")
    ref_hist, ref_ious, _, _ = j_compute_miou_dirs(gt_dir, jax_pngs, ids, 9, verbose=False)
    assert hist.sum() == 4 * SIZE * SIZE
    np.testing.assert_array_equal(hist, ref_hist)
    np.testing.assert_array_equal(ious, ref_ious)
    assert sorted(os.listdir(os.path.join(out, "detection-results"))) == sorted(
        i + ".png" for i in ids)


def test_predict_seg_cli_writes_its_files(seg_set, tmp_path, cli_dryrun_widths):
    from asy_vrnet_tpu_torch.cli import predict_seg

    meta, weights, _, ids = seg_set
    images = os.path.join(meta["seg_dataset_path"], "JPEGImages")
    image = os.path.join(images, ids[0] + ".jpg")
    radar = os.path.join(meta["radar_root"], ids[0] + ".npz")
    out = str(tmp_path / "pred")
    predict_seg.main(["--mode", "predict", "--image", image, "--radar", radar, "--out", out,
                      "--mix-type", "1"] + _cli_model_flags(weights))
    assert os.listdir(out) == [ids[0] + ".jpg"]
    assert Image.open(os.path.join(out, ids[0] + ".jpg")).size == (SIZE, SIZE)


def test_get_fps_on_the_cpu(segmenters):
    """Both clocks give a positive time per call on the CPU (on CPU tensors
    the device-time protocol falls back to the host clock)."""
    _, ts = segmenters
    image, radar = _request(*REQUESTS[2])
    for device_time in (False, True):
        assert 0.0 < ts.get_fps(image, radar, test_interval=2, device_time=device_time) < 60.0
