"""The stochastic-depth path end to end at 128^2: a model's train-mode
forward and the gradient of every parameter, in each package, at
coc_dryrun, f32, batch 2, under a seeded cotangent on the outputs.

The variant is coc_dryrun with drop_path_rate 1e-9, registered in both
packages' variant tables for the test only.  Every backbone block past
stage 0's first then takes the stochastic-depth route: the module path,
whose cluster mix is the stand-alone kernel pair (K7/K7b in JAX, through
`cluster_mix_pallas` in interpret mode; their twins in the port).  In f32
1 - rate rounds to 1 for these rates, so every draw keeps every sample in
both frameworks and the two compute the same function.  At 128^2 the six
backbone blocks on that route take the kernels.

JAX runs `model.apply(..., train=True, rngs={"droppath": key},
mutable=["batch_stats"])` under `jax.vjp`: its train step passes no rngs,
so its drop-path cannot run there.  Tolerances:
tests/torch_parity.py::check_stochastic_depth_step.
"""
from tests import torch_parity as tp


def test_stochastic_depth_step_through_the_kernel_pair_matches_jax(monkeypatch):
    tp.check_stochastic_depth_step(monkeypatch, 128, mix_calls=6)
