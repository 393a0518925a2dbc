"""Activation rematerialisation for training (`ModelConfig.train_remat`; the
JAX package's `nn.remat` spans in `models/vr_coc.py`).

A span keeps only its inputs for the backward and recomputes its interior
there, through `torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`.
flax's functional `nn.remat` recomputes exactly what the forward computed;
three things of the port's modules are made to do the same here:
  - the explicit generators (`layers.set_generator`) of the span's Dropout
    and DropPath modules replay the state they had when the span ran
    forward, and are left where the later forward and backward left them
    (checkpoint's `preserve_rng_state` covers only the default generators);
  - BatchNorm does not update its running stats again (flax discards the
    recompute's batch_stats);
  - the fused blocks take the residual switches the span's forward read
    (`ops/block.py::span_state`), and the MLP half that produces the span's
    output saves its inputs without launching K1, whose result checkpoint
    would drop (`stack`).
"""
from __future__ import annotations

import contextlib

from torch.utils.checkpoint import checkpoint

from asy_vrnet_tpu_torch.models import layers
from asy_vrnet_tpu_torch.ops import block

# the span kinds of each setting (JAX vr_coc.py:434-438, :578-584)
_SPANS = {"fusion": ("fusion",), "blocks": ("fusion", "blocks"),
          "stages": ("fusion", "stages")}


def spans_of(setting: str) -> tuple[str, ...]:
    """The span kinds `setting` rematerialises.  Any other value means none,
    as in the JAX package's model (its CLI restricts the choices)."""
    return _SPANS.get(setting, ())


def _generators(modules) -> list:
    gens = {}
    for mod in modules:
        for m in mod.modules():
            if isinstance(m, layers.Dropout) and m.generator is not None:
                gens[id(m.generator)] = m.generator
    return list(gens.values())


@contextlib.contextmanager
def _frozen_running_stats():
    old = layers.RUNNING_STATS.frozen
    layers.RUNNING_STATS.frozen = True
    try:
        yield
    finally:
        layers.RUNNING_STATS.frozen = old


def _contexts(modules):
    """checkpoint's context_fn: (forward context, recompute context) of one
    span, sharing what the forward recorded."""
    rec = {}

    @contextlib.contextmanager
    def forward():
        rec["gens"] = [(g, g.get_state()) for g in _generators(modules)]
        rec["switches"] = block.residual_switches()
        with block.span_state(switches=rec["switches"]):
            yield

    @contextlib.contextmanager
    def recompute():
        now = [(g, g.get_state()) for g, _ in rec["gens"]]
        for g, s in rec["gens"]:
            g.set_state(s)
        try:
            with _frozen_running_stats(), block.span_state(switches=rec["switches"],
                                                           recompute=True):
                yield
        finally:
            for g, s in now:
                g.set_state(s)

    return forward(), recompute()


def span(fn, modules, *args):
    """fn(*args) as one rematerialised span; `modules` are the modules fn
    runs (their dropout generators are replayed)."""
    return checkpoint(fn, *args, use_reentrant=False, context_fn=lambda: _contexts(modules))


def stack(blocks, x):
    """Run `blocks` (ClusterBlocks) in order; the last one produces the
    span's output."""
    for blk in blocks[:-1]:
        x = blk(x)
    with block.span_state(tail=True):
        return blocks[-1](x)
