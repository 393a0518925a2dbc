"""The port's data layer (`asy_vrnet_tpu_torch/data/`) against the JAX
package's, on the CPU.  Both packages' writers, datasets and loaders run on
the same seeds and files, at 64^2 with 4 images; everything is compared
bit for bit (the same numpy, PIL and cv2 calls on both sides).  The radar in
bfloat16 is held as float32 values: JAX's `ml_dtypes` cast against
`torch.bfloat16`'s, both round to nearest even."""
import os
import sys
import threading

import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401

from asy_vrnet_tpu.data import augment as jaug
from asy_vrnet_tpu.data import dataset as jds
from asy_vrnet_tpu.data import preprocess as jpre
from asy_vrnet_tpu.data import synthetic as jsyn
from asy_vrnet_tpu.data.seg_dataset import SegOnlyDataset as JSegOnly

from asy_vrnet_tpu_torch.data import augment as taug
from asy_vrnet_tpu_torch.data import dataset as tds
from asy_vrnet_tpu_torch.data import native_io
from asy_vrnet_tpu_torch.data import preprocess as tpre
from asy_vrnet_tpu_torch.data import synthetic as tsyn
from asy_vrnet_tpu_torch.data.seg_dataset import SegOnlyDataset as TSegOnly

HW = (64, 64)
WRITERS = ["write_synthetic_voc_dataset", "write_learnable_voc_dataset"]


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """Both packages' writers, same seed: {writer: (jax meta, port meta)}."""
    out = {}
    for name in WRITERS:
        metas = []
        for pkg, tag in ((jsyn, "j"), (tsyn, "t")):
            root = tmp_path_factory.mktemp(f"{name}_{tag}")
            metas.append(getattr(pkg, name)(str(root), num_images=4, hw=HW, seed=3))
        out[name] = tuple(metas)
    return out


def _files(meta):
    root = meta["seg_dataset_path"]
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("name", WRITERS)
def test_writers_write_the_same_dataset(sets, name):
    from PIL import Image

    jm, tm = sets[name]
    jroot, troot = jm["seg_dataset_path"], tm["seg_dataset_path"]
    assert _files(jm) == _files(tm)
    jann = open(jm["annotation_path"]).read().replace(jroot, "<root>")
    tann = open(tm["annotation_path"]).read().replace(troot, "<root>")
    assert tann == jann and jann.count("\n") == 4
    assert open(tm["classes_path"]).read() == open(jm["classes_path"]).read()
    for rel in _files(jm):
        a, b = os.path.join(jroot, rel), os.path.join(troot, rel)
        if rel.endswith((".jpg", ".png")):
            np.testing.assert_array_equal(np.asarray(Image.open(b)), np.asarray(Image.open(a)))
        elif rel.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                assert x.files == y.files
                np.testing.assert_array_equal(y["arr_0"], x["arr_0"])


def _datasets(meta, **kw):
    lines = jds.read_annotation_file(meta["annotation_path"])
    assert tds.read_annotation_file(meta["annotation_path"]) == lines
    args = (lines, HW, 4, 9, meta["radar_root"], meta["seg_dataset_path"])
    return jds.WaterScenesDataset(*args, max_boxes=8, **kw), \
        tds.WaterScenesDataset(*args, max_boxes=8, **kw)


def _as_array(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
    if v.dtype.name == "bfloat16":          # ml_dtypes
        return v.astype(np.float32)
    return v


def _assert_samples_equal(want: dict, got: dict):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if k == "image_id":
            assert g == w
            continue
        wa, ga = _as_array(w), _as_array(g)
        assert ga.dtype == wa.dtype and ga.shape == wa.shape, k
        np.testing.assert_array_equal(ga, wa, err_msg=k)


@pytest.mark.parametrize("name", WRITERS)
@pytest.mark.parametrize("kw", [
    {}, {"augment": True}, {"augment": True, "weather": True},
    {"cache_bytes": 1 << 20, "augment": True}, {"radar_dtype": "bfloat16"},
    {"radar_dtype": "bfloat16", "augment": True, "cache_bytes": 1 << 20},
    {"host_normalize": True, "radar_norm": "minmax"},
], ids=["plain", "augment", "weather", "cache", "bf16", "bf16-cache-augment", "host-norm"])
def test_dataset_items_match_jax(sets, name, kw):
    """Two epochs (the second after the loader's epoch bump), every item."""
    jd, td = _datasets(sets[name][0], **kw)
    for epoch in (1, 2):
        jd.epoch = td.epoch = epoch
        for i in range(len(jd)):
            _assert_samples_equal(jd[i], td[i])
    if kw.get("radar_dtype") == "bfloat16":
        assert td[0]["radar"].dtype == torch.bfloat16
    if kw.get("cache_bytes"):
        assert td._cache_used == jd._cache_used > 0 and set(td._cache) == set(jd._cache)


@pytest.mark.parametrize("workers", [1, 2])
def test_shuffled_loader_matches_jax_over_two_epochs(sets, workers):
    jd, td = _datasets(sets[WRITERS[0]][0], augment=True)
    jl = jds.DataLoader(jd, 2, shuffle=True, seed=5, workers=workers)
    tl = tds.DataLoader(td, 2, shuffle=True, seed=5, workers=workers)
    assert len(tl) == len(jl) == 2
    for _ in range(2):
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == 2
        for a, b in zip(jb, tb):
            _assert_samples_equal(a, b)
    assert td.epoch == jd.epoch == 2


def test_loader_relays_a_worker_exception(sets):
    _, td = _datasets(sets[WRITERS[0]][0])

    class Broken:
        def __len__(self):
            return len(td)

        def __getitem__(self, i):
            if i == 2:
                raise FileNotFoundError("missing radar npz for sample 2")
            return td[i]

    for workers in (1, 2):
        loader = tds.DataLoader(Broken(), batch_size=1, shuffle=False, prefetch=2,
                                workers=workers)
        with pytest.raises(FileNotFoundError, match="sample 2"):
            list(loader)


def test_cache_budget_holds_under_concurrent_misses(sets):
    """Many threads miss the cache at once: the check-then-insert under the
    lock never overshoots the budget, and the count equals what is held."""
    _, td = _datasets(sets[WRITERS[1]][0])
    one = sum(a.nbytes for a in td._decoded(0)[:4])
    td._cache.clear()
    td._cache_used = 0
    td.cache_bytes = 2 * one + 1
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [td[i] for i in (0, 1, 2, 3) * 3])
                   for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    held = sum(sum(a.nbytes for a in b[:4]) for b in td._cache.values())
    assert td._cache_used == held <= td.cache_bytes and len(td._cache) == 2


def test_device_prefetch_on_the_cpu_hands_out_the_batch(sets):
    _, td = _datasets(sets[WRITERS[0]][0], radar_dtype="bfloat16")
    host = list(tds.DataLoader(td, 2, shuffle=False, workers=1))
    dev = list(tds.device_prefetch(iter(host), "cpu"))
    assert len(dev) == len(host) == 2
    for h, d in zip(host, dev):
        assert d["image_id"] == h["image_id"]
        for k, v in h.items():
            if k != "image_id":
                assert isinstance(d[k], torch.Tensor) and d[k].device.type == "cpu"
                assert torch.equal(d[k], torch.as_tensor(v)), k


def test_native_reader_is_reported_and_reads_what_numpy_reads(sets):
    meta = sets[WRITERS[1]][1]
    path = os.path.join(meta["radar_root"], sorted(os.listdir(meta["radar_root"]))[0])
    if native_io.native_available():
        assert native_io.build_error() is None
        np.testing.assert_array_equal(native_io.load_npz(path), np.load(path)["arr_0"])
        paths = [os.path.join(meta["radar_root"], f)
                 for f in sorted(os.listdir(meta["radar_root"]))]
        loader = native_io.NativeBatchLoader((4, *HW), threads=2)
        try:
            np.testing.assert_array_equal(loader.load(paths),
                                          np.stack([np.load(p)["arr_0"] for p in paths]))
        finally:
            loader.close()
        assert os.path.dirname(native_io._LIB).endswith(os.path.join("asy_vrnet_tpu_torch",
                                                                     "_build"))
    else:
        assert native_io.build_error()


def test_seg_only_dataset_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(5)
    (tmp_path / "VOC2007" / "JPEGImages").mkdir(parents=True)
    (tmp_path / "VOC2007" / "SegmentationClass").mkdir(parents=True)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (48, 72, 3), dtype=np.uint8)).save(
            tmp_path / "VOC2007" / "JPEGImages" / f"img{i}.jpg")
        Image.fromarray(rng.integers(0, 11, (48, 72)).astype(np.uint8)).save(
            tmp_path / "VOC2007" / "SegmentationClass" / f"img{i}.png")
    names = ["img0", "img1 extra", "img2"]
    for train in (False, True):
        for host_normalize in (False, True):
            kw = dict(seed=4, host_normalize=host_normalize)
            jd = JSegOnly(names, HW, 9, train, str(tmp_path), **kw)
            td = TSegOnly(names, HW, 9, train, str(tmp_path), **kw)
            for epoch in (0, 1, 2, 3):
                jd.epoch = td.epoch = epoch
                for i in range(3):
                    _assert_samples_equal(jd[i], td[i])


@pytest.mark.parametrize("seed", [0, 1])
def test_preprocess_helpers_match_jax(seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    label = Image.fromarray(rng.integers(0, 10, (37, 53)).astype(np.uint8))
    for size in ((64, 64), (32, 48), (80, 40)):
        np.testing.assert_array_equal(np.asarray(tpre.letterbox_label(label, size)),
                                      np.asarray(jpre.letterbox_label(label, size)))
        np.testing.assert_array_equal(np.asarray(tpre.letterbox_image(
            label.convert("RGB"), size)[0]), np.asarray(jpre.letterbox_image(
                label.convert("RGB"), size)[0]))
    xy = rng.uniform(0, 50, (6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.5, 30, (6, 2)), rng.integers(0, 4, (6, 1))],
                           -1).astype(np.float32)
    for args in ((boxes, (53, 37), (64, 64)), (boxes, (20, 90), (32, 48)),
                 (np.zeros((0, 5)), (53, 37), (64, 64))):
        want = jpre.letterbox_boxes(*args)
        got = tpre.letterbox_boxes(*args)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for b in (boxes, np.zeros((0, 5), np.float32)):
        np.testing.assert_array_equal(tpre.boxes_xyxy_to_cxcywh(b), jpre.boxes_xyxy_to_cxcywh(b))


def _pair(fn_name, *args, seed=0):
    """(JAX result, port result) of one augment function, each on a fresh
    generator of the same seed (where the function takes one)."""
    out = []
    for mod in (jaug, taug):
        call = [np.random.default_rng(seed) if isinstance(a, str) and a == "rng" else a
                for a in args]
        out.append(getattr(mod, fn_name)(*call))
    return out


def _assert_equal_nested(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal_nested(x, y)
    elif a is None:
        assert b is None
    elif hasattr(a, "size") and hasattr(a, "mode"):       # PIL image
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augmentations_match_jax(seed):
    from PIL import Image

    rng = np.random.default_rng(100 + seed)
    img = rng.integers(0, 255, (40, 60, 3), dtype=np.uint8)
    pil = Image.fromarray(img)
    boxes = np.array([[5, 5, 30, 30, 1], [20, 10, 55, 38, 2]], np.float32)
    seg = rng.integers(0, 9, (40, 60)).astype(np.uint8)
    radar = rng.standard_normal((40, 60, 4)).astype(np.float32)
    _assert_equal_nested(*_pair("hsv_jitter", img, "rng", seed=seed))
    _assert_equal_nested(*_pair("random_place", pil, boxes, (64, 64), "rng", seed=seed))
    _assert_equal_nested(*_pair("flip_horizontal", img, boxes, seg, radar))
    _assert_equal_nested(*_pair("flip_horizontal", img, boxes))
    cut = [boxes, boxes + 12, boxes[:1], np.zeros((0, 5), np.float32)]
    _assert_equal_nested(*_pair("merge_mosaic_boxes", cut, 30, 25))
    quads = [Image.fromarray(rng.integers(0, 255, (40 + 7 * i, 60, 3), dtype=np.uint8))
             for i in range(4)]
    _assert_equal_nested(*_pair("mosaic", quads, [boxes] * 4, (64, 64), "rng", seed=seed))
    _assert_equal_nested(*_pair("mixup", img, boxes, img[::-1].copy(), boxes[:1]))
    _assert_equal_nested(*_pair("mixup", img, np.zeros((0, 5)), img, boxes))
    for fn in ("rain", "fog", "sun_flare"):
        _assert_equal_nested(*_pair(fn, img, "rng", seed=seed))
    # apply_weather over enough seeds to take each of its four branches
    for s in range(12):
        _assert_equal_nested(*_pair("apply_weather", img, "rng", seed=10 * seed + s))
