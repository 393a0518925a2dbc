"""Closed-loop training: the port's fused train step dispatched back to back
on a pool of seeded batches, cycled.

Set-up builds one train state from the seed's weights and drives it through
the first `checked_steps` steps of the pool with the window's own call; the
same state then runs the window.  After the window the reference repeats
those steps in f32 from the same weights and batches, and the comparison
takes each step's loss, each leaf's first gradient (the optimiser's
momentum buffer after step 1: the gradient plus weight decay), each leaf's
change after the checked steps, the EMA's change and the change of each
BatchNorm's running statistics.
"""
from __future__ import annotations

import statistics
import time

import torch

from vrbench.common import (generator, leaf_gaps, no_tf32, norms, program_config,
                             seeded_weights)
from vrbench.reference import train as ref_train
from vrbench.reference.lowp import CONTROL
from vrbench.reference.model import EfficientVRNet, Env

def make_pool(cfg: dict, mix: dict, seed: int, device) -> list[dict]:
    """`pool` distinct batches of `batch` rows, made on the device: uint8
    noise images, N(0, 10) radar maps, 1-16 boxes an image (centres in the
    middle 70%, sides 8-30% of the input, the 4 classes), per-pixel seg
    targets over the 9 classes and ignore."""
    g = generator(seed, "train-pool", device)
    m = cfg["model"]
    h, w = m["input_size"]
    b, gmax = mix["batch"], cfg["loss"]["max_boxes"]
    lo, hi = mix["boxes_per_image"]
    pool = []
    for _ in range(mix["pool"]):
        u = lambda *s: torch.rand(s, generator=g, device=device)  # noqa: E731
        n = torch.randint(lo, hi + 1, (b, 1), generator=g, device=device)
        cxcy = 0.15 * w + 0.7 * w * u(b, gmax, 2)
        wh = 0.08 * w + 0.22 * w * u(b, gmax, 2)
        pool.append({
            "image": torch.randint(0, 256, (b, h, w, 3), generator=g, device=device,
                                   dtype=torch.uint8),
            "radar": torch.randn((b, h, w, 4), generator=g, device=device) * 10.0,
            "gt_boxes": torch.cat([cxcy, wh], -1),
            "gt_classes": torch.randint(0, m["num_classes"], (b, gmax), generator=g,
                                        device=device, dtype=torch.int32),
            "gt_valid": torch.arange(gmax, device=device)[None] < n,
            "seg_target": torch.randint(0, m["num_seg_classes"] + 1, (b, h, w), generator=g,
                                        device=device, dtype=torch.int32),
        })
    return pool


def _rows(batch: dict, n: int) -> dict:
    return {k: v[:n] for k, v in batch.items()}


BN_STATS = ("running_mean", "running_var")


def summarize(losses, grads1: dict, params0: dict, params: dict, ema: dict,
              buffers: dict) -> dict:
    bn = {k: v for k, v in buffers.items() if k.rsplit(".", 1)[-1] in BN_STATS}
    return {"losses": losses, "grad": norms(grads1),
            "change": norms({k: params[k] - params0[k] for k in params}),
            "ema": norms({k: ema[k] - params0[k] for k in ema}),
            "bn": norms({k: bn[k] - params0[k] for k in bn})}


def leaf_table(prog: dict, ref: dict) -> dict:
    """{kind: {leaf: gap}} for the first gradient, the change, the EMA's
    change and the BatchNorm statistics' change.  Each leaf's gap is
    |‖prog‖ - ‖ref‖| over the larger of the reference's norm of that leaf
    and of the median leaf of its kind.  Leaves whose reference gradient is
    under a thousandth of the median leaf's move by rounding alone and are
    left out of the change and the EMA."""
    g = ref["grad"]
    med = statistics.median(g.values())
    moved = {k for k, v in g.items() if v >= 1e-3 * med}
    keep = {"grad": None, "change": moved,
            "ema": {k for k in ref["ema"] if k in moved or k not in g}, "bn": None}
    return {kind: leaf_gaps(prog[kind], ref[kind], leaves) for kind, leaves in keep.items()}


def numbers(prog: dict, ref: dict) -> dict:
    """The numbers of the check: `*_gap` is the median leaf's gap of its
    kind (`leaf_table`), `*_worst` the worst leaf's; `loss_gap` the worst
    step's relative gap of the loss."""
    out = {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))}
    for kind, table in leaf_table(prog, ref).items():
        gaps = sorted(table.values())
        out[f"{kind}_gap"] = gaps[len(gaps) // 2]
        out[f"{kind}_worst"] = gaps[-1]
    return out


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> dict:
    """{kind: [[leaf, gap, prog norm, ref norm], ...]}: the `n` worst leaves
    of each kind."""
    out = {}
    for kind, table in leaf_table(prog, ref).items():
        top = sorted(table.items(), key=lambda kv: -kv[1])[:n]
        out[kind] = [[k, v, prog[kind][k], ref[kind][k]] for k, v in top]
    return out


class Driver:
    """One cell's training traffic on one device."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, fault: str | None = None):
        from asy_vrnet_tpu_torch.models.efficient_vrnet import create_model
        from asy_vrnet_tpu_torch.train.optim import set_learning_rate
        from asy_vrnet_tpu_torch.train.state import create_train_state
        from asy_vrnet_tpu_torch.train.train_step import build_train_step

        self.cfg, self.mix, self.device = cfg, mix, device
        self.batch = mix["batch"]
        self.pool = make_pool(cfg, mix, seed, device)
        first = self.pool[0]
        rows = mix["calibration_rows"]
        self.weights = seeded_weights(cfg["model"], seed, device,
                                      ref_train.normalize_image(first["image"][:rows]),
                                      first["radar"][:rows])
        self.lr = ref_train.adaptive_lr(cfg["optim"], self.batch)
        pcfg = program_config(cfg)
        model = create_model(pcfg.model, device)
        model.load_state_dict(self.weights)
        self.state = create_train_state(pcfg, model, device)
        set_learning_rate(self.state.optimizer, self.lr)
        step = build_train_step(pcfg, device=device)
        self.step = self._faulty(step, fault)
        self.issue_s, self.n = [], 0
        losses = []
        for i in range(mix["checked_steps"]):
            _, m = self.step(self.state, self.pool[i % len(self.pool)])
            losses.append(float(m["loss"]))
            if i == 0:
                opt = self.state.optimizer
                grads1 = {k: opt.state[p]["momentum_buffer"] if p in opt.state
                          else torch.zeros_like(p) for k, p in model.named_parameters()}
                grads1 = {k: v.clone() for k, v in grads1.items()}
        params = dict(model.named_parameters())
        self.summary = summarize(losses, grads1, self.weights,
                                 {k: p.detach() for k, p in params.items()},
                                 {k: v for k, v in self.state.ema.items()},
                                 dict(model.named_buffers()))
        self.worst = None
        self.n = mix["checked_steps"]

    def _faulty(self, step, fault):
        """The step with a planted fault, for the checks of the check."""
        if fault is None:
            return step
        if fault == "unchanged":
            return lambda state, batch: (state, {"loss": torch.zeros(())})
        if fault == "half_batch":
            return lambda state, batch: step(state, _rows(batch, self.batch // 2))
        raise ValueError(fault)

    def iterate(self) -> None:
        batch = self.pool[self.n % len(self.pool)]
        t = time.perf_counter()
        self.step(self.state, batch)
        self.issue_s.append(time.perf_counter() - t)
        self.n += 1

    def end_to_end(self, window_s: float, iters: int) -> dict:
        return {"train_images_per_s": (iters * self.batch / window_s, "images/s")}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.state = self.step = None

    def reference(self, control: bool = False) -> dict:
        """The reference's summary of the checked steps (with `control`,
        the control's: `lowp.CONTROL`)."""
        env = Env(remat=True, **(CONTROL if control else {}))
        model = EfficientVRNet(self.cfg["model"], env).to(self.device)
        model.load_state_dict(self.weights)
        step = ref_train.Step(model, self.cfg, self.lr)
        losses = []
        with no_tf32():
            for i in range(self.mix["checked_steps"]):
                losses.append(step(self.pool[i % len(self.pool)]))
                if i == 0:
                    grads1 = {k: v.clone() for k, v in step.mom.items()}
        return summarize(losses, grads1, self.weights,
                         {k: p.detach() for k, p in model.named_parameters()}, step.ema,
                         dict(model.named_buffers()))

    def check(self, control: bool = False) -> dict:
        """The numbers of the check; with `control`, the control in the
        program's place."""
        prog = self.reference(control=True) if control else self.summary
        ref = self.reference()
        self.worst = worst_leaves(prog, ref)
        return numbers(prog, ref)
