"""The port's training entry point end to end on the CPU:
`asy_vrnet_tpu_torch.cli.train.main` in process, nano coc_dryrun at 64^2, f32,
on a 4-image synthetic set, two epochs (the first with the backbone frozen
at its own batch size), and what it leaves behind held against the JAX
package:

  - the LR set each epoch equals JAX's `make_lr_schedule` for both phases;
  - JAX's `load_weights` reads `last_epoch_weights.npz` with every leaf, and
    JAX's forward (jitted once, `use_pallas_cluster=False`, eval mode) on the
    val batches agrees with the port's on the same weights: det maps and seg
    logits within rtol 1e-4, atol 1e-5 (the same f32 arithmetic in another
    order through ~60 layers);
  - JAX's `DetectionEvaluator` and `MIoUAccumulator` fed the detections and
    argmax maps the port's callbacks computed in the last epoch give the
    `epoch_map.txt` and `epoch_miou.txt` values exactly;
  - one `--seg-only` epoch and a `--resume` run;
  - `--num-devices 2` on the CPU (two gloo ranks the CLI starts itself):
    rank 0 alone writes one loss history and one `last_epoch_weights.npz`,
    whose weights equal the one-device run's within atol 1e-5 (the step's
    bounds in `test_torch_parallel.py`); a batch the ranks cannot split is
    refused, and `--seg-only` trains on one device whatever N is."""
import contextlib
import io
import json
import os
import re
import sys
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import one_torch_thread  # noqa: F401

from asy_vrnet_tpu import config as jconfig
from asy_vrnet_tpu.metrics.map import DetectionEvaluator as JaxDetectionEvaluator
from asy_vrnet_tpu.metrics.miou import MIoUAccumulator as JaxMIoUAccumulator
from asy_vrnet_tpu.models.efficient_vrnet import create_model as jax_create_model
from asy_vrnet_tpu.train import checkpoint as jck
from asy_vrnet_tpu.train.optim import make_lr_schedule as jax_lr_schedule

from asy_vrnet_tpu_torch.cli import train as cli
from asy_vrnet_tpu_torch.data.dataset import DataLoader, WaterScenesDataset, read_annotation_file
from asy_vrnet_tpu_torch.data.preprocess import normalize_image
from asy_vrnet_tpu_torch.models.efficient_vrnet import create_model
from asy_vrnet_tpu_torch.train import callbacks, loop
from asy_vrnet_tpu_torch.train.checkpoint import load_weights

SIZE = 64
MODEL = {"phi": "nano", "variant": "coc_dryrun", "compute_dtype": "float32",
         "input_size": [SIZE, SIZE], "prestem_s2d": False}
FLAGS = ["--device", "cpu", "--input-size", str(SIZE), "--synthetic", "4", "--freeze-epoch",
         "1", "--batch-size", "2", "--eval-period", "1", "--save-period", "2",
         "--max-boxes", "8"]


def _main(argv, tmp) -> tuple[object, str]:
    """Run the CLI in process; its synthetic set goes under `tmp`.  Like the
    card machine, the run finds neither TensorBoard nor matplotlib (the
    optional paths: no event file, no PNGs), which also spares the test
    TensorFlow's import; the ranks the CLI spawns find the modules that say
    so first on their path."""
    out = io.StringIO()
    hidden = tmp / "hidden_modules"
    hidden.mkdir(exist_ok=True)
    for name in ("tensorboard", "matplotlib"):
        (hidden / f"{name}.py").write_text(f"raise ImportError('{name} is hidden here')\n")
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(tempfile, "tempdir", str(tmp))
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        mp.setitem(sys.modules, "matplotlib", None)
        mp.syspath_prepend(str(hidden))
        state = cli.main(argv)
    return state, out.getvalue()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One 2-epoch CLI run; the LRs it set, and the inputs of its last
    epoch's evaluators."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg_path = tmp / "config.json"
    # freeze_batch_size 4: the frozen epoch takes one batch of the 4 images
    cfg_path.write_text(json.dumps({"model": MODEL, "train": {"freeze_batch_size": 4,
                                                               "num_workers": 2},
                                    "data": {"input_shape": [SIZE, SIZE]}}))
    lrs, dets, segs = [], [], []

    class Det(callbacks.DetectionEvaluator):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            dets.append([])

        def add_image(self, *a):
            dets[-1].append(a)
            super().add_image(*a)

    class Seg(callbacks.MIoUAccumulator):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            segs.append([])

        def update(self, *a):
            segs[-1].append(a)
            super().update(*a)

    def record_lr(opt, lr):
        lrs.append(lr)
        set_lr(opt, lr)

    set_lr = loop.set_learning_rate
    save_dir = tmp / "logs"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(callbacks, "DetectionEvaluator", Det)
        mp.setattr(callbacks, "MIoUAccumulator", Seg)
        mp.setattr(loop, "set_learning_rate", record_lr)
        state, out = _main(["--config", str(cfg_path), *FLAGS, "--epochs", "2",
                            "--save-dir", str(save_dir)], tmp)
    root = re.search(r"synthetic dataset: (\S+)", out).group(1)
    return dict(tmp=tmp, cfg=cfg_path, save_dir=save_dir, out=out, state=state, lrs=lrs,
                dets=dets, segs=segs, root=root)


def test_the_run_prints_and_writes_what_jax_does(run):
    assert "epoch 1/2" in run["out"] and "epoch 2/2" in run["out"]
    assert "Configurations:" in run["out"] and "val AP50" in run["out"]
    d = run["save_dir"]
    for f in ("loss/epoch_det_seg.txt", "loss/epoch_val_det_seg.txt", "epoch_map.txt",
              "epoch_miou.txt", "last_epoch_weights.npz", "best_epoch_weights.npz",
              "ckpt/step_2.pt"):
        assert (d / f).exists(), f
    assert not list(d.rglob("*.png")) and not list(d.rglob("events.out.tfevents*"))
    losses = [float(v) for v in (d / "loss/epoch_det_seg.txt").read_text().split()]
    assert len(losses) == 2 and all(np.isfinite(losses))
    # epoch 1: one frozen step at batch 4; epoch 2: two steps at batch 2
    assert run["state"].step == 3 and run["state"].ema_updates == 3.0


def test_epoch_learning_rates_match_jax(run):
    jo = jconfig.OptimConfig()
    want = [jax_lr_schedule(jo, 4, 2)(0), jax_lr_schedule(jo, 2, 2)(1)]
    assert run["lrs"] == want and want[0] != want[1]


def test_the_weights_give_jax_forward(run):
    """The last epoch's npz through JAX's loader (every leaf) and forward
    against the port's forward on the same file, on both val batches."""
    path = str(run["save_dir"] / "last_epoch_weights.npz")
    jm = jax_create_model(jconfig.ModelConfig(**{**MODEL, "input_size": (SIZE, SIZE)},
                                              use_pallas_cluster=False))
    zeros = lambda c: np.zeros((1, SIZE, SIZE, c), np.float32)  # noqa: E731
    like = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), zeros(3), zeros(4),
                                          train=False))
    src = jck.load_weights(path)
    variables = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for col in ("params", "batch_stats"):
            variables[col], loaded, kept = jck.partial_load(like[col], src[col])
            assert not kept and len(loaded) == len(jax.tree.leaves(like[col])), col
    fwd = jax.jit(lambda v, i, r: jm.apply(v, i, r, train=False))

    cfg, _ = cli.resolve_config(cli.build_argparser().parse_args(
        ["--config", str(run["cfg"]), *FLAGS]))
    port = create_model(cfg.model, "cpu", weights=path)
    batches = _val_batches(run)
    assert len(batches) == 2
    for b in batches:
        image = normalize_image(b["image"]).astype(np.float32)
        jdet, jseg = fwd(variables, jnp.asarray(image), jnp.asarray(b["radar"]))
        with torch.no_grad():
            tdet, tseg = port(torch.from_numpy(image), torch.from_numpy(b["radar"]))
        for t, j in zip((*tdet, tseg), (*jdet, jseg)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-5)


def _val_batches(run):
    meta = os.path.join(run["root"], "train.txt")
    ds = WaterScenesDataset(read_annotation_file(meta), (SIZE, SIZE), 4, 9,
                            os.path.join(run["root"], "radar"), run["root"], max_boxes=8)
    return list(DataLoader(ds, 2, shuffle=False, workers=1))


def test_epoch_metrics_equal_jax_evaluators_on_the_port_outputs(run):
    assert len(run["dets"]) == len(run["segs"]) == 2          # one per epoch
    ev = JaxDetectionEvaluator(["pier", "vessel", "ship", "boat"], iou_threshold=0.5)
    for args in run["dets"][-1]:
        ev.add_image(*args)
    assert len(run["dets"][-1]) == 4
    logged = float((run["save_dir"] / "epoch_map.txt").read_text().split()[-1])
    assert ev.evaluate(method="coco")["map"] == logged
    acc = JaxMIoUAccumulator(9)
    for label, pred in run["segs"][-1]:
        acc.update(label, pred)
    logged = float((run["save_dir"] / "epoch_miou.txt").read_text().split()[-1])
    assert acc.result()["miou"] == logged


def test_seg_only_epoch_writes_weights(run):
    save_dir = run["tmp"] / "seg_only"
    state, out = _main(["--config", str(run["cfg"]), *FLAGS, "--epochs", "1",
                        "--seg-only", "--save-dir", str(save_dir)], run["tmp"])
    loss = float(re.search(r"\[seg-only\] epoch 1/1 loss=(\S+)", out).group(1))
    assert np.isfinite(loss) and state.step == 2
    src = load_weights(str(save_dir / "last_epoch_weights.npz"))
    assert set(src) == {"params", "batch_stats"}


def test_resume_continues_the_step_count(run):
    ckpt = str(run["save_dir"] / "ckpt" / "step_2.pt")
    state, out = _main(["--config", str(run["cfg"]), *FLAGS, "--epochs", "3", "--resume",
                        ckpt, "--save-dir", str(run["tmp"] / "resumed")], run["tmp"])
    assert f"resumed from {ckpt} at step 3 (epoch 2)" in out
    assert "epoch 3/3" in out and "epoch 1/3" not in out and "epoch 2/3" not in out
    assert state.step == 5
    assert (run["tmp"] / "resumed" / "ckpt" / "step_3.pt").exists()


def test_more_than_one_card_is_refused(monkeypatch):
    """More ranks than visible cards, or no rank at all, are refused before
    anything starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--num-devices 2: 1 card"):
        cli.main(["--num-devices", "2"])
    with pytest.raises(ValueError, match="--num-devices -1: no device to train on"):
        cli.main(["--num-devices", "-1"])


def test_the_backend_follows_the_ranks_devices():
    """NCCL only when every rank has a card of its own (it refuses two ranks
    on one card); gloo on the CPU and for ranks that share a card."""
    assert cli.rank_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert cli.rank_backend(["cuda:0", "cuda:0"]) == "gloo"
    assert cli.rank_backend(["cpu", "cpu"]) == "gloo"


RANK_FLAGS = ["--device", "cpu", "--input-size", str(SIZE), "--synthetic", "4", "--epochs",
              "1", "--batch-size", "2", "--max-boxes", "8"]


@pytest.fixture(scope="module")
def ranks_run(tmp_path_factory):
    """The same one-epoch run on one device and on two gloo CPU ranks."""
    tmp = tmp_path_factory.mktemp("cli_ranks")
    cfg_path = tmp / "config.json"
    cfg_path.write_text(json.dumps({"model": MODEL, "train": {"num_workers": 1},
                                    "data": {"input_shape": [SIZE, SIZE]}}))
    flags = ["--config", str(cfg_path), *RANK_FLAGS]
    out = {}
    for n in (1, 2):
        save_dir = tmp / f"n{n}"
        state, text = _main([*flags, "--num-devices", str(n), "--save-dir", str(save_dir)], tmp)
        out[n] = dict(state=state, out=text, save_dir=save_dir)
    return {"tmp": tmp, "flags": flags, **out}


def test_two_cpu_ranks_write_the_one_device_run_weights(ranks_run):
    one, two = ranks_run[1], ranks_run[2]
    assert one["state"].step == 2 and two["state"] is None
    assert "training on mesh {'data': 2, 'model': 1}: 2 ranks over gloo on cpu, cpu" \
        in two["out"]
    for run in (one, two):
        d = run["save_dir"]
        assert (d / "loss/epoch_det_seg.txt").read_text().count("\n") == 1
        assert sorted(p.name for p in d.glob("*.npz")) == ["best_epoch_weights.npz",
                                                          "last_epoch_weights.npz"]
        assert [p.name for p in (d / "ckpt").iterdir()] == ["step_1.pt"]
    with np.load(one["save_dir"] / "last_epoch_weights.npz") as a, \
            np.load(two["save_dir"] / "last_epoch_weights.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5, err_msg=k)
    ck = torch.load(two["save_dir"] / "ckpt" / "step_1.pt", weights_only=True)
    assert ck["step"] == 2


def test_ranks_that_cannot_split_the_batch_are_refused(ranks_run):
    with pytest.raises(ValueError, match="--batch-size 2 does not split over 3 ranks"):
        _main([*ranks_run["flags"], "--num-devices", "3", "--save-dir",
               str(ranks_run["tmp"] / "n3")], ranks_run["tmp"])
    assert not (ranks_run["tmp"] / "n3").exists()


def test_seg_only_trains_on_one_device_whatever_n(ranks_run):
    save_dir = ranks_run["tmp"] / "seg_only_n2"
    state, out = _main([*ranks_run["flags"], "--num-devices", "2", "--seg-only",
                        "--save-dir", str(save_dir)], ranks_run["tmp"])
    assert "[seg-only] trains on one device (cpu)" in out and "training on mesh" not in out
    assert state.step == 2 and (save_dir / "last_epoch_weights.npz").exists()
