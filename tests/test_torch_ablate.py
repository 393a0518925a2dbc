"""The mixer-forward ablation (K2's prefixes, `ops/mixer_ablate.py`), its
tool and the port's profiling module, on the CPU.

The prefixes' twins are held against sums built from the JAX package: the
unfolded K2 `_mixer_block_pallas(..., interpret=True, residuals=True)` gives
the raw centers (c_rep), the winning cosine and proposal per (token, head)
(cbest, argf), the mixed centers (oc) and the output; the terms the
residuals do not carry (the normalised input, the value centers, feat) are
rebuilt with numpy from the same inputs.  Per (sample, region, CTA) the
checksum must agree within 1e-5 of the sum of its terms' magnitudes (f32;
the sums run in another order).  The normalise-first `full` twin is held
against JAX's lane-folded K2f (`fused_mixer_block_stats(..., lane_fold=s)`),
whose similarity is normalise-first, with tests/test_torch_lane_fold.py's
forward tolerance: atol 1e-5 * max(1, max |ref|), rtol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asy_vrnet_tpu.ops import block_pallas as jb
from asy_vrnet_tpu.utils.profiling import param_count as jax_param_count

from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

from asy_vrnet_tpu_torch.ops import block
from asy_vrnet_tpu_torch.ops import mixer_ablate as ma
from asy_vrnet_tpu_torch.tools import ablate_mixer_fwd as tool
from asy_vrnet_tpu_torch.utils import profiling

# (B, H, W, C), fold, heads, head_dim, CTAs per region (G)
CASES = {"c16": ((2, 64, 64, 16), 4, 4, 32, 2), "c80": ((2, 32, 32, 80), 2, 8, 32, 4)}
PROP, M = 2, 4
ALPHA, BETA = 1.3, -0.2


def _inputs(case, seed=0):
    (b, h, w, c), _, heads, d, _ = CASES[case]
    inner = heads * d
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = n(b, h, w, c)
    ws = (n(c, inner) * 0.2, n(inner) * 0.1, n(c, inner) * 0.2, n(inner) * 0.1,
          n(inner, c) * 0.2, n(c) * 0.1)
    stats = block.gn1_stats(torch.from_numpy(x)).numpy()
    return x, stats, ws


def _geo(case):
    _, fold, heads, _, _ = CASES[case]
    return dict(heads=heads, fold_h=fold, fold_w=fold, proposal_h=PROP, proposal_w=PROP)


def _twin(case, stop, nf=False):
    x, stats, ws = _inputs(case)
    t = [torch.from_numpy(a) for a in (x, stats, *ws)]
    ab = torch.tensor([ALPHA, BETA])
    return ma.mixer_block_ablate_plain(*t, ab, stop=stop, nf=nf, groups=CASES[case][4],
                                       **_geo(case))


def _regions(t, fold):
    """(B, H, W, K) -> (B, R, N, K), regions and their tokens row-major."""
    b, h, w, k = t.shape
    rh, rw = h // fold, w // fold
    return (t.reshape(b, fold, rh, fold, rw, k).transpose(0, 1, 3, 2, 4, 5)
            .reshape(b, fold * fold, rh * rw, k))


@pytest.fixture(scope="module")
def jax_k2():
    """Per case: JAX's unfolded K2 in interpret mode, f32, with residuals."""
    out = {}
    for case in CASES:
        x, stats, ws = _inputs(case)
        (b, h, w, c), fold, heads, d, _ = CASES[case]
        o, osum, res = jb._mixer_block_pallas(
            jnp.asarray(x), jnp.asarray(stats), *[jnp.asarray(a) for a in ws],
            jnp.float32(ALPHA), jnp.float32(BETA), heads, fold, fold, PROP, PROP,
            interpret=True, residuals=True)
        out[case] = (np.asarray(o), np.asarray(osum), [np.asarray(r, np.float32) for r in res])
    return out


def _reference_terms(case, res):
    """Per-(sample, region, head) terms of every cut prefix from the JAX
    residuals and numpy: {stop: ([per-head arrays (B, R, heads, ...)],
    region-level array (B, R, ...) or None)}."""
    x, stats, (wf, bf, wv, bv, _, _) = _inputs(case)
    (b, h, w, c), fold, heads, d, _ = CASES[case]
    rh, rw = h // fold, w // fold
    gw = jb._group_w(fold, rh * rw)
    fwg = fold // gw
    cbest, argf, crep, oc = res
    # per-token residual planes: rows (region in group, head), tile tokens
    # (rh, gw * rw) -> (B, R, heads, N)
    tok = lambda t: np.stack([t.reshape(b, fold, fwg, gw, heads, rh, gw, rw)[  # noqa: E731
        :, :, :, g, :, :, g, :] for g in range(gw)], 3).reshape(b, fold * fold, heads, -1)
    # center rows (proposal, region in group, head), head-masked columns
    ctr = lambda t: t.reshape(b, fold, fwg, M, gw, heads, heads, d).transpose(  # noqa: E731
        0, 1, 2, 4, 5, 3, 6, 7).reshape(b, fold * fold, heads, M, heads, d)[
        :, :, np.arange(heads), :, np.arange(heads)].transpose(1, 2, 0, 3, 4)
    cn = ctr(crep) / np.sqrt((ctr(crep) ** 2).sum(-1, keepdims=True) + 1e-12)
    xn = _regions((x - stats[:, 0, None, None, None]) * stats[:, 1, None, None, None], fold)
    win = xn.reshape(b, fold * fold, PROP, rh // PROP, PROP, rw // PROP, c)
    cin = win.mean(axis=(3, 5)).reshape(b, fold * fold, M, c)
    vc = (cin @ wv + bv).reshape(b, fold * fold, M, heads, d).transpose(0, 1, 3, 2, 4)
    feat = (xn @ wf + bf).reshape(b, fold * fold, -1, heads, d).transpose(0, 1, 3, 2, 4)
    featn = feat / np.sqrt((feat ** 2).sum(-1, keepdims=True) + 1e-12)
    rs = 1.0 / (1.0 + np.exp(-(BETA + ALPHA * tok(cbest))))
    return {"gn": ([], xn), "centers": ([cn, vc], xn), "feat": ([cn, vc, feat], None),
            "featn": ([cn, vc, featn], None),
            "cosm": ([vc, np.einsum("brhmd,brhnd->brhnm", cn, featn)], None),
            "sim": ([vc, rs, tok(argf)], None), "agg": ([ctr(oc)], None)}


def _grouped(terms, groups):
    """(checksum, sum of magnitudes), each (B, R, groups)."""
    per_head, region = terms
    s = sum(t.reshape(*t.shape[:3], -1).sum(-1) for t in per_head)
    a = sum(np.abs(t).reshape(*t.shape[:3], -1).sum(-1) for t in per_head)
    b, r = (per_head or [region])[0].shape[:2]
    s, a = [np.zeros((b, r, groups)) if isinstance(v, int) else
            v.reshape(b, r, groups, -1).sum(-1) for v in (s, a)]
    if region is not None:
        s = s + region.reshape(b, r, -1).sum(-1)[..., None]
        a = a + np.abs(region).reshape(b, r, -1).sum(-1)[..., None]
    return s, a


@pytest.mark.parametrize("stop,nf", [("gn", False), ("centers", False), ("feat", False),
                                     ("sim", False), ("agg", False), ("featn", True),
                                     ("cosm", True)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_prefix_checksums_match_jax(jax_k2, case, stop, nf):
    """A cut prefix's per-CTA checksum and magnitude against the JAX
    residuals' sums (centers: c_rep; sim: cbest, argf; agg: oc; the rest
    from numpy), and its output is rnd(x + s) of its dispatching CTA."""
    want, mag = _grouped(_reference_terms(case, jax_k2[case][2])[stop], CASES[case][4])
    out, part = _twin(case, stop, nf)
    b = want.shape[0]
    got = part.numpy().reshape(b, -1, CASES[case][4], 2)
    np.testing.assert_array_less(np.abs(got[..., 0] - want), 1e-5 * mag + 1e-30)
    np.testing.assert_array_less(np.abs(got[..., 1] - mag), 1e-5 * mag + 1e-30)
    x = torch.from_numpy(_inputs(case)[0])
    fold = CASES[case][1]
    assert torch.equal(out, ma.write_through(x, part.view(b, -1, CASES[case][4], 2)[..., 0],
                                             fold_h=fold, fold_w=fold))


@pytest.mark.parametrize("case", sorted(CASES))
def test_full_prefix_matches_jax(jax_k2, case):
    """`full` is K2: its twin's output and moments against JAX's K2."""
    o, osum, _ = jax_k2[case]
    out, part = _twin(case, "full")
    np.testing.assert_allclose(out.numpy(), o, atol=1e-5 * max(1.0, np.abs(o).max()), rtol=1e-5)
    np.testing.assert_allclose(part.sum(1).numpy(), osum[:, 0, :2], rtol=1e-5)
    ref, mom = block.mixer_block_plain(
        *[torch.from_numpy(a) for a in (_inputs(case)[0], _inputs(case)[1], *_inputs(case)[2])],
        torch.tensor([ALPHA, BETA]), **_geo(case))
    assert torch.equal(out, ref)
    torch.testing.assert_close(part.sum(1), mom, rtol=1e-6, atol=1e-6 * mom.abs().max().item())


def test_nf_full_matches_jax_folded_k2f():
    """The normalise-first `full` twin against JAX's lane-folded K2f at c16
    (fold s = 8), which normalises feat before its cosines."""
    (b, h, w, c), fold, heads, d, _ = CASES["c16"]
    inner = heads * d
    s = jb.lane_fold_choice((b, h, w, c), fold_h=fold, fold_w=fold, inner=inner)
    assert s == 8
    rng = np.random.default_rng(3)
    n = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    args = (n(b, h, w, c) * 0.5, n(c) * 0.1 + 1.0, n(c) * 0.1, n(c, inner) * 0.2,
            n(inner) * 0.1, n(c, inner) * 0.2, n(inner) * 0.1, n(inner, c) * 0.2,
            n(c) * 0.1, n(c) * 0.1 + 0.5, np.float32(1.3), np.float32(-0.2))
    jout, jst = jb.fused_mixer_block_stats(
        jnp.asarray(args[0]).reshape(b, h, w // s, s * c), *[jnp.asarray(a) for a in args[1:]],
        heads, fold, fold, PROP, PROP, s)
    ts = [torch.from_numpy(np.array(a, np.float32)) for a in args]
    x = ts[0]
    out, part = ma.mixer_block_ablate_plain(x, block.gn1_stats(x), *block._mixer_operands(*ts),
                                            stop="full", nf=True, **_geo("c16"))
    want = np.asarray(jout).reshape(b, h, w, c)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5 * max(1.0, np.abs(want).max()),
                               rtol=1e-5)
    st = block._stats_from_moments(part.sum(1), h * w * c)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=1e-5, rtol=1e-5)


def test_wrapper_on_cpu_is_the_twin():
    """On a CPU tensor the wrapper runs the twin under its profiler label,
    launches nothing, and refuses a prefix its variant has not."""
    x, stats, ws = _inputs("c80")
    t = [torch.from_numpy(a) for a in (x, stats, *ws)]
    ab = torch.tensor([ALPHA, BETA])
    before = dict(ma.LAUNCHES)
    for stop, nf in tool.JOBS[:3]:
        got = ma.mixer_block_ablate(*t, ab, stop=stop, nf=nf, groups=4, **_geo("c80"))
        want = _twin("c80", stop, nf)
        assert all(torch.equal(a, r) for a, r in zip(got, want))
    assert ma.LAUNCHES == before
    with pytest.raises(ValueError):
        ma.mixer_block_ablate(*t, ab, stop="cosm", nf=False, **_geo("c80"))
    with pytest.raises(ValueError):
        ma.mixer_block_ablate(*t, ab, stop="gn", groups=3, **_geo("c80"))


def test_kernel_table_counts_labelled_ranges(tmp_path):
    a, b = torch.randn(16, 32), torch.randn(32, 8)
    iters = 3
    with profiling.trace(str(tmp_path)):
        for _ in range(iters):
            for _ in range(2):
                with torch.profiler.record_function("lab/a"):
                    a @ b
            with torch.profiler.record_function("lab/b"):
                a @ b
    table = profiling.kernel_table(str(tmp_path), iters)
    assert table[("lab/a", "?")][1] == 2 and table[("lab/b", "?")][1] == 1
    assert all(ms > 0 for ms, _ in table.values())
    assert (tmp_path / "trace.json").exists()


def test_traced_takes_one_trace_on_cpu(tmp_path):
    """On CPU arguments there is no device event to wait for: one trace,
    whose labelled ranges `kernel_table` counts."""
    a, b = torch.randn(16, 32), torch.randn(32, 8)
    calls = []

    def run():
        calls.append(1)
        with torch.profiler.record_function("lab/a"):
            a @ b

    assert profiling.traced(run, str(tmp_path), on_card=False) == 1 and calls == [1]
    assert profiling.kernel_table(str(tmp_path), 1)[("lab/a", "?")][1] == 1


def test_param_count_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"params": {"a": rng.standard_normal((3, 4)), "b": [rng.standard_normal(5),
                                                             {"c": np.zeros((2, 7))}]},
            "batch_stats": {"m": np.ones(6)}}
    assert profiling.param_count(tree) == jax_param_count(tree) == 12 + 5 + 14 + 6
    lin = torch.nn.Linear(3, 4)
    assert profiling.param_count(lin) == 16 == profiling.param_count(dict(lin.named_parameters()))


def test_flops_and_timers_on_cpu():
    a, b = torch.randn(16, 32), torch.randn(32, 8)
    assert profiling.flops_estimate(torch.matmul, a, b) == 2 * 16 * 32 * 8
    assert profiling.cost_analysis(torch.matmul, a, b)["by_op"] == {"aten.mm": 2 * 16 * 32 * 8}
    st = profiling.time_fn(torch.matmul, a, b, iters=4, warmup=1)
    assert st["iters"] == 4 and 0 < st["min"] <= st["median"] and st["mean"] > 0
    assert profiling.chained_device_time(torch.matmul, a, b, n=3, repeats=2) > 0


def test_tool_runs_the_twins_on_cpu(capsys, tmp_path):
    """The entry point with --device cpu: a row per prefix, the numerics."""
    res = tool.run(tool.parse_args(["--device", "cpu", "--batch", "1", "--hw", "64",
                                    "--iters", "1", "--out", str(tmp_path)]))
    lines = capsys.readouterr().out.splitlines()
    rows = [ln for ln in lines if ln.startswith(("base ", "nf "))]
    assert [ln.split()[:2] for ln in rows] == [["nf" if nf else "base", s] for s, nf in tool.JOBS]
    assert any(ln.startswith("nf-vs-base max|diff|") for ln in lines)
    assert res["device"] == "cpu" and len(res["rows"]) == len(tool.JOBS) == 11
    assert all(r["ms"] > 0 and r["ms_trace"] > 0 and r["trace_count"] == 1.0
               and r["ctas_per_sm"] is None for r in res["rows"])
    assert (tmp_path / "trace.json").exists()


def test_prefix_bounds_add_up_to_k2s():
    """The `full` bound is K2's (chip_smoke.py's mixer_bounds) in both
    variants, and the prefixes' operations never fall."""
    geo = tool.geometry(0, 512, 0.25, 8)
    b, h, w, c, heads, d, fold = (geo[k] for k in ("b", "h", "w", "c", "heads", "d", "fold"))
    t, inner = b * h * w, heads * d
    k2 = (t * (2 * c * inner + 2 * inner * (M + 1) + 4 * c * heads)
          + b * fold * fold * 8 * M * c * inner, 2 * t * c * 2 + 3 * c * inner * 2)
    for nf in (False, True):
        flops = [tool.prefix_bounds(s, nf, geo)[0] for s in ma.STOPS[nf]]
        assert flops == sorted(flops)
        assert tool.prefix_bounds("full", nf, geo) == k2
