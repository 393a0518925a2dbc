"""Training CLI (the port's counterpart of `asy_vrnet_tpu/cli/train.py`;
reference train.py): the same flags and JSON config.

Everything is a flag or a JSON config; `--synthetic N` trains end to end on
a generated dataset (a smoke test of the whole stack).  The port's
differences: `--device` (the card by default, 'cpu' to run the plain
PyTorch path; without a card it raises), and `--resume` takes the port's
own full-state checkpoint.

`--num-devices N` trains data-parallel over N ranks with the JAX package's
global-batch semantics (`parallel/mesh.py`): 0 means every visible card (1
with `--device cpu`); above 1 the CLI starts N processes itself, ranks on
cuda:0..N-1 over NCCL, or N CPU ranks over gloo with `--device cpu`.  The
global batch (and the frozen phase's) must split evenly over the ranks.
`--seg-only` trains on one device whatever N is, as the JAX CLI does.

  python -m asy_vrnet_tpu_torch.cli.train --synthetic 8 --epochs 2 --batch-size 2 \
      --input-size 64 --save-dir /tmp/run
  python -m asy_vrnet_tpu_torch.cli.train --train-annotation 2007_train.txt \
      --val-annotation 2007_val.txt --classes model_data/waterscenes.txt \
      --radar-root radar --seg-path . --phi nano --epochs 100 --num-devices 4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", help="JSON config file (overrides defaults)")
    p.add_argument("--phi", default="nano", choices=["nano", "tiny", "s", "m", "l"])
    p.add_argument("--input-size", type=int, default=512)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--init-epoch", type=int, default=0)
    p.add_argument("--freeze-epoch", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    p.add_argument("--init-lr", type=float, default=1e-2)
    p.add_argument("--save-dir", default="logs")
    p.add_argument("--save-period", type=int, default=10)
    p.add_argument("--eval-period", type=int, default=10)
    p.add_argument("--num-devices", type=int, default=0,
                   help="data-parallel ranks; 0 = every visible card (1 with "
                        "--device cpu), 1 = one device")
    p.add_argument("--device", default="cuda",
                   help="torch device: the card (default) or 'cpu'; no "
                        "fallback when the card is missing")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--multitask", default="fixed", choices=["fixed", "uncertainty"])
    p.add_argument("--no-focal-loss", action="store_true",
                   help="plain CE instead of focal for segmentation "
                        "(reference train.py focal_loss flag)")
    p.add_argument("--no-dice-loss", action="store_true",
                   help="disable the dice term (reference train.py dice_loss)")
    p.add_argument("--remat", default="none",
                   choices=["none", "fusion", "blocks", "stages"],
                   help="activation rematerialisation span (fit larger "
                        "batches in HBM at ~1 extra forward of the span); "
                        "'blocks' checkpoints each ClusterBlock — half the "
                        "activation count of 'none' at one extra mixer "
                        "kernel per block, no conv recompute")
    p.add_argument("--seg-signed-logits", action="store_true",
                   help="corrected variant: drop the final seg ReLU so "
                        "background logits can go negative (parity default "
                        "keeps the reference's post-ReLU quirk)")
    p.add_argument("--no-ema", action="store_true")
    p.add_argument("--resume", help="full-state checkpoint (<save-dir>/ckpt/step_<N>.pt) "
                                    "to resume from; training continues after its "
                                    "epoch unless --init-epoch is given")
    p.add_argument("--weights", help=".npz weights for partial (shape-matched) init")
    p.add_argument("--weights-init", default="none",
                   choices=["none", "normal", "xavier", "kaiming", "orthogonal"],
                   help="reference-style conv/BN re-init for from-scratch runs "
                        "(nets/yolo_training.py:482-501)")
    p.add_argument("--init-gain", type=float, default=0.02)
    p.add_argument("--train-annotation", default="2007_train.txt")
    p.add_argument("--val-annotation", default="2007_val.txt")
    p.add_argument("--classes", default="model_data/waterscenes.txt")
    p.add_argument("--num-seg-classes", type=int, default=9)
    p.add_argument("--radar-root", default="radar")
    p.add_argument("--seg-path", default=".")
    p.add_argument("--max-boxes", type=int, default=100)
    p.add_argument("--synthetic-learnable", action="store_true",
                   help="with --synthetic: generate the LEARNABLE overfit "
                        "set (coloured boxes + co-located radar) instead of "
                        "noise — for convergence validation")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="generate an N-image synthetic dataset and train on it")
    p.add_argument("--augment", action="store_true",
                   help="enable flip/HSV augmentation on the train split")
    p.add_argument("--weather", action="store_true",
                   help="enable rain/fog/flare weather augmentation")
    p.add_argument("--seg-only", action="store_true",
                   help="segmentation-only training (utils_seg fit variant)")
    p.add_argument("--cache-gb", type=float, default=0.0,
                   help="decoded-sample cache budget in GiB (0 = off); "
                        "epochs >= 2 skip decode+letterbox for cached samples")
    return p


def resolve_config(args):
    """argparse namespace -> (Config, class_names).

    With --config, the JSON file is the base and only flags the user
    explicitly passed (value != argparse default) override it; without,
    flags populate a default Config directly.
    """
    from asy_vrnet_tpu_torch.config import (
        Config, DataConfig, LossConfig, ModelConfig, OptimConfig, TrainConfig,
    )
    from asy_vrnet_tpu_torch.data.preprocess import get_classes

    hw = args.input_size
    if args.config:
        # JSON config is the base; flags the user explicitly passed (i.e.
        # whose value differs from the argparse default) override it.
        with open(args.config) as f:
            cfg = Config.from_dict(json.load(f))
        parser = build_argparser()
        explicit = {
            k for k, v in vars(args).items() if v != parser.get_default(k)
        }

        def over(section, **pairs):
            updates = {field: value for flag, (field, value) in pairs.items()
                       if flag in explicit}
            return dataclasses.replace(section, **updates) if updates else section

        class_names, num_classes = get_classes(
            args.classes if "classes" in explicit else cfg.data.classes_path
        )
        model_over = over(
            cfg.model,
            phi=("phi", args.phi),
            input_size=("input_size", (hw, hw)),
            compute_dtype=("compute_dtype", args.compute_dtype),
            num_seg_classes=("num_seg_classes", args.num_seg_classes),
            classes=("num_classes", num_classes),
            remat=("train_remat", args.remat),
            seg_signed_logits=("seg_signed_logits", args.seg_signed_logits),
        )
        cfg = Config(
            model=model_over,
            loss=over(cfg.loss, multitask=("multitask_mode", args.multitask),
                      max_boxes=("max_boxes", args.max_boxes),
                      no_focal_loss=("focal_loss", not args.no_focal_loss),
                      no_dice_loss=("dice_loss", not args.no_dice_loss)),
            optim=over(cfg.optim, optimizer=("optimizer", args.optimizer),
                       init_lr=("init_lr", args.init_lr),
                       no_ema=("ema", not args.no_ema)),
            train=over(cfg.train, epochs=("epochs", args.epochs),
                       init_epoch=("init_epoch", args.init_epoch),
                       freeze_epoch=("freeze_epoch", args.freeze_epoch),
                       batch_size=("batch_size", args.batch_size),
                       save_period=("save_period", args.save_period),
                       eval_period=("eval_period", args.eval_period),
                       save_dir=("save_dir", args.save_dir)),
            data=over(cfg.data,
                      train_annotation=("train_annotation_path", args.train_annotation),
                      val_annotation=("val_annotation_path", args.val_annotation),
                      classes=("classes_path", args.classes),
                      radar_root=("radar_root", args.radar_root),
                      seg_path=("seg_dataset_path", args.seg_path),
                      input_size=("input_shape", (hw, hw))),
        )
    else:
        class_names, num_classes = get_classes(args.classes)
        cfg = Config(
            model=ModelConfig(
                num_classes=num_classes, num_seg_classes=args.num_seg_classes,
                phi=args.phi, input_size=(hw, hw), compute_dtype=args.compute_dtype,
                train_remat=args.remat,
                seg_signed_logits=args.seg_signed_logits,
            ),
            loss=LossConfig(
                multitask_mode=args.multitask, max_boxes=args.max_boxes,
                focal_loss=not args.no_focal_loss,
                dice_loss=not args.no_dice_loss,
            ),
            optim=OptimConfig(
                optimizer=args.optimizer, init_lr=args.init_lr, ema=not args.no_ema
            ),
            train=TrainConfig(
                epochs=args.epochs, init_epoch=args.init_epoch,
                freeze_epoch=args.freeze_epoch, batch_size=args.batch_size,
                save_period=args.save_period, eval_period=args.eval_period,
                save_dir=args.save_dir,
            ),
            data=DataConfig(
                train_annotation_path=args.train_annotation,
                val_annotation_path=args.val_annotation,
                classes_path=args.classes, radar_root=args.radar_root,
                seg_dataset_path=args.seg_path, input_shape=(hw, hw),
            ),
        )
    return cfg, class_names


def rank_devices(args) -> list[str]:
    """Each rank's device from --num-devices and --device; raises where they
    cannot hold."""
    import torch

    from asy_vrnet_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    n = args.num_devices or (cards if dev.type == "cuda" else 1)
    if n < 1:
        raise ValueError(f"--num-devices {args.num_devices}: no device to train on")
    if dev.type == "cuda" and n > 1:
        if n > cards:
            raise ValueError(f"--num-devices {n}: {cards} card(s) visible")
        return [f"cuda:{i}" for i in range(n)]
    return [str(dev)] * n


def rank_backend(devices: list[str]) -> str:
    """The process group's backend for ranks on `devices`: NCCL when every
    rank has a card of its own, else gloo (ranks on the CPU, or ranks that
    share a card, which NCCL refuses)."""
    import torch

    ds = [torch.device(d) for d in devices]
    return "nccl" if all(d.type == "cuda" for d in ds) and len(set(ds)) == len(ds) else "gloo"


def main(argv=None):
    """Train as the flags say; returns the final train state, or None when
    it started several ranks (rank 0 wrote the outputs)."""
    parser = build_argparser()
    args = parser.parse_args(argv)
    devices = rank_devices(args)
    if args.seg_only and len(devices) > 1:
        print(f"[seg-only] trains on one device ({devices[0]}), as the JAX CLI's seg-only "
              f"step does: --num-devices {len(devices)} is not used")
        devices = devices[:1]

    if args.synthetic:
        from asy_vrnet_tpu_torch.data.synthetic import (
            write_learnable_voc_dataset,
            write_synthetic_voc_dataset,
        )

        hw = args.input_size
        root = tempfile.mkdtemp(prefix="asyvrnet_synth_")
        writer = (
            write_learnable_voc_dataset if args.synthetic_learnable
            else write_synthetic_voc_dataset
        )
        meta = writer(root, num_images=args.synthetic, hw=(hw, hw))
        print(f"synthetic dataset: {root}")
        args.train_annotation = meta["annotation_path"]
        args.val_annotation = meta["annotation_path"]
        args.classes = meta["classes_path"]
        args.radar_root = meta["radar_root"]
        args.seg_path = meta["seg_dataset_path"]

    if len(devices) == 1:
        return train(args, devices[0])
    import torch.multiprocessing

    from asy_vrnet_tpu_torch.parallel import mesh

    cfg, _ = resolve_config(args)
    world, backend = len(devices), rank_backend(devices)
    tcfg = cfg.train
    batches = [("--batch-size", tcfg.batch_size)]
    if tcfg.freeze_epoch > tcfg.init_epoch:
        batches.append(("freeze_batch_size", tcfg.freeze_batch_size))
    for what, b in batches:
        if b % world:
            raise ValueError(f"{what} {b} does not split over {world} ranks")
    if any(d.startswith("cuda") for d in devices):
        from asy_vrnet_tpu_torch.ops import kernels

        kernels.build()             # once, before the ranks load the libraries
    print(f"training on mesh {{'data': {world}, 'model': 1}}: {world} ranks over "
          f"{backend} on {', '.join(devices)}")
    torch.multiprocessing.spawn(_rank_main, nprocs=world, args=(
        args, devices, backend, f"tcp://127.0.0.1:{mesh.free_port()}"))
    return None


def _rank_main(rank: int, args, devices: list[str], backend: str, init_method: str):
    import torch

    from asy_vrnet_tpu_torch.parallel import mesh

    dev = mesh.init_rank(rank, len(devices), backend, devices[rank], init_method)
    try:
        if dev.type == "cpu":       # the ranks share the host's cores
            torch.set_num_threads(max(1, torch.get_num_threads() // len(devices)))
        train(args, dev, rank, len(devices))
    finally:
        mesh.shutdown()


def train(args, device, rank: int = 0, world: int = 1):
    """The training run on `device`, as rank `rank` of `world` (a process
    group of `world` ranks must be up when world > 1); -> the train state."""
    import torch

    from asy_vrnet_tpu_torch.config import show_config
    from asy_vrnet_tpu_torch.data.dataset import (
        DataLoader,
        WaterScenesDataset,
        device_prefetch,
        read_annotation_file,
    )
    from asy_vrnet_tpu_torch.models.efficient_vrnet import create_model
    from asy_vrnet_tpu_torch.models.layers import set_generator
    from asy_vrnet_tpu_torch.train import checkpoint
    from asy_vrnet_tpu_torch.train.loop import _mean_metrics, fit
    from asy_vrnet_tpu_torch.train.state import create_train_state
    from asy_vrnet_tpu_torch.utils.device import resolve_device
    from asy_vrnet_tpu_torch.utils.weights import flax_from_port, state_dict_from_flax

    parser = build_argparser()
    dev = resolve_device(device)
    say = print if rank == 0 else (lambda *a, **k: None)
    seg_subdir = os.path.join("VOC2007", "SegmentationClass")

    cfg, class_names = resolve_config(args)
    say(show_config(cfg))

    torch.manual_seed(cfg.train.seed)           # the port's own default init
    model = create_model(cfg.model, dev)
    # dropout and drop-path (where a variant has any) draw from one seeded
    # generator, whose state the full checkpoint keeps
    set_generator(model, torch.Generator(device=dev).manual_seed(cfg.train.seed))
    if args.weights_init != "none":
        from asy_vrnet_tpu_torch.utils.init import reinit_params

        say(f"initialize network with {args.weights_init} type")
        reinit_params(model, cfg.train.seed, args.weights_init, args.init_gain)
    if args.weights:
        src = checkpoint.load_weights(args.weights)
        have = flax_from_port(model.state_dict())
        params, _, _ = checkpoint.partial_load(have["params"], src.get("params"), rank == 0)
        bstats, _, _ = checkpoint.partial_load(have["batch_stats"], src.get("batch_stats"),
                                               rank == 0)
        model.load_state_dict(state_dict_from_flax(params, bstats), strict=True)
    state = create_train_state(cfg, model, dev)
    if args.resume:
        epoch = checkpoint.restore_checkpoint(args.resume, state)
        say(f"resumed from {args.resume} at step {state.step} (epoch {epoch})")
        if args.init_epoch == parser.get_default("init_epoch"):
            cfg = dataclasses.replace(
                cfg, train=dataclasses.replace(cfg.train, init_epoch=epoch))

    def mk_loader(path, shuffle, augment=False):
        ds = WaterScenesDataset(
            read_annotation_file(path), cfg.data.input_shape,
            cfg.model.num_classes, cfg.model.num_seg_classes,
            cfg.data.radar_root, cfg.data.seg_dataset_path,
            max_boxes=cfg.loss.max_boxes, seg_subdir=seg_subdir,
            augment=augment, weather=args.weather and augment,
            seed=cfg.train.seed,
            cache_bytes=int(args.cache_gb * (1 << 30)),
        )
        return DataLoader(
            ds, cfg.train.batch_size, shuffle=shuffle, seed=cfg.train.seed,
            workers=max(1, cfg.train.num_workers), rank=rank, world=world,
        )

    train_loader = mk_loader(cfg.data.train_annotation_path, True, args.augment)
    val_loader = mk_loader(cfg.data.val_annotation_path, False)

    if args.seg_only:
        from asy_vrnet_tpu_torch.train.optim import make_lr_schedule, set_learning_rate
        from asy_vrnet_tpu_torch.train.seg_only import build_seg_train_step
        from asy_vrnet_tpu_torch.train.state import eval_variables

        schedule = make_lr_schedule(cfg.optim, cfg.train.batch_size, cfg.train.epochs)
        step = build_seg_train_step(cfg, dev)
        for epoch in range(cfg.train.init_epoch, cfg.train.epochs):
            set_learning_rate(state.optimizer, schedule(epoch))
            metrics = []
            for db in device_prefetch(iter(train_loader), dev):
                db.pop("image_id", None)
                state, m = step(state, db)
                metrics.append(m)
            loss = _mean_metrics(metrics).get("loss", float("nan"))
            print(f"[seg-only] epoch {epoch + 1}/{cfg.train.epochs} loss={loss:.4f}")
        os.makedirs(cfg.train.save_dir, exist_ok=True)
        checkpoint.save_weights(
            os.path.join(cfg.train.save_dir, "last_epoch_weights.npz"),
            eval_variables(state, use_ema=cfg.optim.ema))
        return state

    mesh = None
    if world > 1:
        from asy_vrnet_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(world)
    return fit(cfg, state, train_loader, val_loader, class_names, mesh=mesh)


if __name__ == "__main__":
    main()
