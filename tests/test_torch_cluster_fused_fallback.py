"""The stochastic-depth path at 64^2, where the JAX predicate refuses every
backbone shape (4-token regions): both packages fall back to the plain
cluster mix inside the model.  The same check as
tests/test_torch_cluster_fused_model.py (forward and every parameter's
gradient against JAX, f32; tolerances in
tests/torch_parity.py::check_stochastic_depth_step), with no block on the
kernel pair."""
from tests import torch_parity as tp


def test_stochastic_depth_step_on_the_plain_fallback_matches_jax(monkeypatch):
    tp.check_stochastic_depth_step(monkeypatch, 64, mix_calls=0)
