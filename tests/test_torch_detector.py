"""Detector (letterbox -> forward -> decode -> NMS -> boxes) of the port
against the JAX package's Detector, on two PIL requests at 64x64, f32 and
the same random weights.  Boxes are in original-image pixels: atol 1e-3 px
(the forwards agree to ~1e-5 in f32, see test_torch_model.py)."""
import numpy as np
import pytest
from PIL import Image

from asy_vrnet_tpu.config import ModelConfig as JaxModelConfig
from asy_vrnet_tpu.infer.predictor import Detector as JaxDetector

from asy_vrnet_tpu_torch.infer.predictor import Detector

from torch_parity import config_kwargs, model_pair

SIZE = 64
CLASSES = ["pier", "buoy", "sailor", "ship"]


@pytest.fixture(scope="module")
def detectors():
    jm, variables, port = model_pair(SIZE)
    kw = dict(conf_thres=0.2, nms_thres=0.3, max_det=30)
    jd = JaxDetector(JaxModelConfig(**config_kwargs(SIZE)), variables, CLASSES, **kw)
    td = Detector(port.config, CLASSES, model=port, **kw)
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
