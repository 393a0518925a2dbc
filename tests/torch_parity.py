"""Shared set-up for the whole-model parity tests of the PyTorch port: one
JAX EfficientVRNet (f32, fused Pallas block kernels in interpret mode,
literal pre-stem) and the port model carrying the same random weights
through the bridge."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from asy_vrnet_tpu.config import ModelConfig as JaxModelConfig
from asy_vrnet_tpu.models.efficient_vrnet import create_model as jax_create_model

from asy_vrnet_tpu_torch.config import ModelConfig
from asy_vrnet_tpu_torch.models.cluster_block import ClusterBlock
from asy_vrnet_tpu_torch.models.efficient_vrnet import create_model


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for the module's tests, restored after.
    The suite runs several workers on a few cores, and torch's default
    thread pool per worker then multiplies the CPU tests' wall time (the
    eager steps here gain nothing from more threads even alone).  Import it
    into a test module to apply it there."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cli_dryrun_widths(monkeypatch):
    """The inference CLIs build `coc_small`, as the JAX package's do.  While
    a test runs, that name takes `coc_dryrun`'s widths, so a CLI loads the
    weights of the small CPU test models."""
    from asy_vrnet_tpu_torch.config import COC_VARIANTS

    monkeypatch.setitem(COC_VARIANTS, "coc_small", COC_VARIANTS["coc_dryrun"])


def config_kwargs(size: int) -> dict:
    return dict(phi="nano", variant="coc_dryrun", compute_dtype="float32",
                use_pallas_cluster=True, prestem_s2d=False, input_size=(size, size))


def model_pair(size: int):
    """-> (jax_model, variables, port_model) with the same weights:
    `noisy_model_pair`'s (the port's initialisation plus N(0, 0.05) noise, so
    LayerScale, GN affine and alpha/beta are far from their identity-ish
    init values and every block contributes).  No JAX initialisation is
    compiled."""
    kw = config_kwargs(size)
    jm, params, bstats, port = noisy_model_pair(JaxModelConfig(**kw), ModelConfig(**kw), size,
                                                seed=1)
    return jm, {"params": params, "batch_stats": bstats}, port


def inputs(size: int, seed: int = 2, batch: int = 2):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    rad = rng.random((batch, size, size, 4)).astype(np.float32)
    return img, rad


def fused_blocks(port, img, rad) -> list[bool]:
    """Which ClusterBlocks take the fused path for these inputs, in call order."""
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(m.fused_ok(a[0])))
             for m in port.modules() if isinstance(m, ClusterBlock)]
    import torch

    with torch.no_grad():
        port(torch.from_numpy(img), torch.from_numpy(rad))
    for h in hooks:
        h.remove()
    return seen


def check_forward_and_boxes(jm, variables, port, size: int):
    """Port f32 forward == JAX f32 forward; decode + NMS keep the same boxes.

    Tolerance: atol 5e-5, rtol 1e-4 on det and seg.  Both sides run the same
    f32 arithmetic in another order through ~60 layers; measured differences
    are <= 6e-6 on values of magnitude <= 3."""
    import jax.numpy as jnp
    import torch

    from asy_vrnet_tpu.ops.boxes import decode_predictions as j_decode
    from asy_vrnet_tpu.ops.nms import non_max_suppression as j_nms

    from asy_vrnet_tpu_torch.ops.boxes import decode_predictions
    from asy_vrnet_tpu_torch.ops.nms import non_max_suppression

    img, rad = inputs(size)
    fwd = jax.jit(lambda v, i, r: jm.apply(v, i, r, train=False))
    jdet, jseg = fwd(variables, jnp.asarray(img), jnp.asarray(rad))
    jdet = [np.array(d) for d in jdet]
    with torch.no_grad():
        tdet, tseg = port(torch.from_numpy(img), torch.from_numpy(rad))
    for a, b in zip(jdet, tdet):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), a, atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(tseg.numpy(), np.asarray(jseg), atol=5e-5, rtol=1e-4)

    hw = (size, size)
    conf = float(np.quantile(np.asarray(j_decode([jnp.asarray(d) for d in jdet], hw))
                             [..., 4], 0.8)) * 0.5
    # identical raw outputs through both decode + NMS: identical kept boxes
    jout = j_nms(j_decode([jnp.asarray(d) for d in jdet], hw), 4,
                 conf_thres=conf, nms_thres=0.3, max_out=40)
    tout = non_max_suppression(decode_predictions([torch.from_numpy(d) for d in jdet], hw),
                               4, conf_thres=conf, nms_thres=0.3, max_out=40)
    valid = np.asarray(jout["valid"])
    assert valid.sum() >= 5
    np.testing.assert_array_equal(tout["valid"].numpy(), valid)
    np.testing.assert_array_equal(tout["classes"].numpy()[valid],
                                  np.asarray(jout["classes"])[valid])
    np.testing.assert_allclose(tout["boxes_xyxy"].numpy()[valid],
                               np.asarray(jout["boxes_xyxy"])[valid], atol=1e-6)
    # each package's own outputs: the same boxes within the forward tolerance
    own = non_max_suppression(decode_predictions(tdet, hw), 4, conf_thres=conf,
                              nms_thres=0.3, max_out=40)
    np.testing.assert_array_equal(own["valid"].numpy(), valid)
    np.testing.assert_array_equal(own["classes"].numpy()[valid],
                                  np.asarray(jout["classes"])[valid])
    np.testing.assert_allclose(own["boxes_xyxy"].numpy()[valid],
                               np.asarray(jout["boxes_xyxy"])[valid], atol=1e-4)


# ---------------------------------------------------------------------------
# train-step parity: one JAX train state and the port's, carried across by
# the bridge
# ---------------------------------------------------------------------------

def train_configs(multitask_mode: str = "fixed", size: int = 64,
                  use_pallas_cluster: bool = False, **optim):
    """-> (JAX Config, port Config): coc_dryrun, f32, module-path blocks
    unless `use_pallas_cluster` (then the fused ClusterBlocks: Pallas kernels
    in interpret mode in JAX, the kernels' plain twins in the port).  The JAX
    side takes its oracle seg loss (CPU default), the port its fused path
    (through the kernels' plain twins on the CPU)."""
    from asy_vrnet_tpu import config as jc
    from asy_vrnet_tpu_torch import config as tc

    def make(mod, use_pallas_seg):
        return mod.Config(
            model=mod.ModelConfig(phi="nano", variant="coc_dryrun", compute_dtype="float32",
                                  use_pallas_cluster=use_pallas_cluster, prestem_s2d=False,
                                  input_size=(size, size)),
            loss=mod.LossConfig(multitask_mode=multitask_mode, max_boxes=16,
                                use_pallas_seg=use_pallas_seg),
            optim=mod.OptimConfig(init_lr=1e-2, **optim),
            train=mod.TrainConfig(batch_size=2))

    return make(jc, None), make(tc, True)


def noisy_model_pair(jmodel_cfg, tmodel_cfg, size: int, seed: int):
    """-> (jax model, params, batch_stats, port model on the CPU) with the
    same weights: the port's own initialisation plus N(0, 0.05) noise (so
    LayerScale, the norms' affines and alpha/beta all matter), carried to
    flax through the bridge's inverse; the flax tree's structure comes from
    `jax.eval_shape`, which compiles nothing."""
    import torch

    from asy_vrnet_tpu_torch.utils.weights import flax_from_state_dict

    torch.manual_seed(seed)       # the port's init draws from the global generator
    jm = jax_create_model(jmodel_cfg)
    zeros = lambda c: np.zeros((1, size, size, c), np.float32)  # noqa: E731
    like = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), zeros(3), zeros(4),
                                          train=False))
    port = create_model(tmodel_cfg, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in port.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    sd = port.state_dict()
    params = jax.tree.map(jnp.asarray, flax_from_state_dict(sd, like["params"]))
    bstats = jax.tree.map(jnp.asarray, flax_from_state_dict(sd, like["batch_stats"]))
    return jm, params, bstats, port


def jax_train_setup(jcfg, tcfg, size: int = 64, lr: float = 1e-2, seed: int = 0):
    """-> (jax model, JAX TrainState, tx), weights from `noisy_model_pair`."""
    from asy_vrnet_tpu.train.optim import set_learning_rate
    from asy_vrnet_tpu.train.state import create_train_state

    jm, params, bstats, _ = noisy_model_pair(jcfg.model, tcfg.model, size, seed)
    state, tx = create_train_state(jcfg, params, bstats)
    return jm, state.replace(opt_state=set_learning_rate(state.opt_state, lr)), tx


def jax_state_to_numpy(state) -> dict:
    """The fields `train_state_from_flax` takes, as numpy."""
    tonp = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    n = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(state.params))
    flat = [np.asarray(v) for v in jax.tree.leaves(state.opt_state)
            if getattr(v, "ndim", 0) == 1 and v.shape[0] == n]
    counts = [np.asarray(v) for v in jax.tree.leaves(state.opt_state)
              if getattr(v, "ndim", 1) == 0 and np.issubdtype(np.asarray(v).dtype, np.integer)]
    opt = ({"trace": flat[0]} if len(flat) == 1 else
           {"mu": flat[0], "nu": flat[1], "count": int(counts[0])})
    return dict(params=tonp(state.params), batch_stats=tonp(state.batch_stats),
                opt_state_flat=opt, log_var=np.asarray(state.log_var),
                ema_params=tonp(state.ema_params),
                ema_batch_stats=tonp(state.ema_batch_stats),
                ema_updates=float(state.ema_updates), step=int(state.step))


def port_state_from_jax(tcfg, jstate, lr: float = 1e-2):
    """A port TrainState on the CPU carrying the JAX state."""
    from asy_vrnet_tpu_torch.train.optim import set_learning_rate
    from asy_vrnet_tpu_torch.train.state import create_train_state
    from asy_vrnet_tpu_torch.utils.weights import train_state_from_flax

    state = create_train_state(tcfg, device="cpu")
    train_state_from_flax(state, **jax_state_to_numpy(jstate))
    set_learning_rate(state.optimizer, lr)
    return state


def assert_trees_close(got: dict, want, atol: float, what: str):
    want_leaves = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, want))
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert len(want_leaves) == len(got_leaves)
    for (path, w), (_, g) in zip(want_leaves, got_leaves):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def run_one_step_each(mode: str, freeze_backbone: bool = False, seeds=(0, 1),
                      weight_seed: int = 1, size: int = 64,
                      use_pallas_cluster: bool = False):
    """One JAX train state stepped twice (batches from `seeds`) and the port's
    state carried over by the bridge and stepped once.  -> dict with the JAX
    states and metrics, the port state and metrics, what a second port step
    needs, and which ClusterBlocks took the fused path in the port's step
    (`fused`, in call order).

    weight_seed: both packages compute in f32 in another order, so a ReLU
    input within rounding of 0 can land on either side of the kink.  The
    forward value does not notice, but that element's gradient is passed on
    one side and dropped on the other, which moves a few parameters' updates
    by ~1e-3 (a central finite difference lands midway between the two).
    About one weight draw in three has such an element (seeds 0 and 3 do);
    the tests use draws that have none, so the tight tolerances hold."""
    from asy_vrnet_tpu.train.train_step import build_train_step as j_build

    from asy_vrnet_tpu_torch.data.synthetic import make_batch
    from asy_vrnet_tpu_torch.train.train_step import build_train_step

    jcfg, tcfg = train_configs(mode, size, use_pallas_cluster)
    jm, j0, tx = jax_train_setup(jcfg, tcfg, size=size, seed=weight_seed)
    jstep = jax.jit(j_build(jm, jcfg, tx, freeze_backbone=freeze_backbone))
    batches = [make_batch(np.random.default_rng(s), 2, (size, size)) for s in seeds]
    j1, jm1 = jstep(j0, jax.tree.map(jnp.asarray, batches[0]))
    j2, jm2 = jstep(j1, jax.tree.map(jnp.asarray, batches[1]))
    tstep = build_train_step(tcfg, freeze_backbone=freeze_backbone, device="cpu")
    t0 = port_state_from_jax(tcfg, j0)
    fused = []
    hooks = [m.register_forward_pre_hook(lambda m, a: fused.append(m.fused_ok(a[0])))
             for m in t0.model.modules() if isinstance(m, ClusterBlock)]
    t1, tm1 = tstep(t0, batches[0])
    for h in hooks:
        h.remove()
    return dict(tcfg=tcfg, j0=j0, j1=j1, j2=j2, jm1=jm1, jm2=jm2, t1=t1, tm1=tm1,
                tstep=tstep, batches=batches, fused=fused)


def check_first_step(r):
    """After one step: the five metrics rtol 1e-4; parameters and their EMA
    atol 1e-5; BN running stats and their EMA atol 1e-5 + rtol 1e-5 (running
    variances reach ~1e2 here, where one f32 ulp is 8e-6).  f32 on both sides,
    the same arithmetic in another order."""
    from asy_vrnet_tpu_torch.utils.weights import flax_from_train_state

    for k in ("loss", "loss_det", "loss_seg", "f_score", "num_fg"):
        np.testing.assert_allclose(float(r["tm1"][k]), float(r["jm1"][k]), rtol=1e-4,
                                   err_msg=k)
    j1, t1 = r["j1"], r["t1"]
    got = flax_from_train_state(t1, j1.params, j1.batch_stats)
    assert_trees_close(got["params"], j1.params, 1e-5, "params")
    assert_trees_close(got["ema_params"], j1.ema_params, 1e-5, "ema_params")
    for name, want in (("batch_stats", j1.batch_stats),
                       ("ema_batch_stats", j1.ema_batch_stats)):
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree.leaves(got[name])):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-5,
                                       err_msg=f"{name} {jax.tree_util.keystr(path)}")
    assert t1.step == int(j1.step) == 1 and t1.ema_updates == float(j1.ema_updates) == 1.0


def check_second_step(r):
    """The second step's metrics, from the port's own state and from a new
    port state bridged from the JAX state after step one: rtol 1e-3."""
    own, m_own = r["tstep"](r["t1"], r["batches"][1])
    bridged, m_br = r["tstep"](port_state_from_jax(r["tcfg"], r["j1"]), r["batches"][1])
    for m in (m_own, m_br):
        for k in ("loss", "loss_det", "loss_seg", "f_score", "num_fg"):
            np.testing.assert_allclose(float(m[k]), float(r["jm2"][k]), rtol=1e-3, err_msg=k)
    assert own.step == bridged.step == 2
    return own, bridged


# ---------------------------------------------------------------------------
# stochastic depth: the module-path blocks whose cluster mix is the
# stand-alone kernel pair (K7/K7b)
# ---------------------------------------------------------------------------

DROPPATH_VARIANT = "coc_dryrun_droppath"


def register_droppath_variant(monkeypatch, rate: float = 1e-9):
    """coc_dryrun with `drop_path_rate = rate`, in both packages' variant
    tables for the calling test only."""
    import dataclasses

    from asy_vrnet_tpu import config as jconfig
    from asy_vrnet_tpu_torch import config as tconfig

    for mod in (jconfig, tconfig):
        v = dataclasses.replace(mod.COC_VARIANTS["coc_dryrun"], drop_path_rate=rate)
        monkeypatch.setitem(mod.COC_VARIANTS, DROPPATH_VARIANT, v)


def check_stochastic_depth_step(monkeypatch, size: int, mix_calls: int):
    """A stochastic-depth model's train-mode forward and every parameter's
    gradient under a seeded output cotangent, JAX against the port, f32,
    batch 2; `mix_calls` blocks take the stand-alone kernel pair in the
    port (its twins, counted on the wrappers).

    Weights: `noisy_model_pair`'s seed-1 draw (no ReLU input within f32
    rounding of 0 here).  Tolerances: outputs atol 5e-5, rtol 1e-4
    (check_forward_and_boxes's); gradients rtol 1e-4 and atol 2e-5 * G,
    with G the largest |gradient| of any parameter (511 at 128^2): the
    gradients span five decades, and f32 sums in another order through
    the whole backward leave errors of G's size in the small ones, e.g.
    a bias in front of a batch-stat BatchNorm, whose true gradient is 0
    (measured: at most 1.2e-5 * G)."""
    import torch

    from asy_vrnet_tpu import config as jconfig

    from asy_vrnet_tpu_torch import config as tconfig
    from asy_vrnet_tpu_torch.models.layers import set_generator
    from asy_vrnet_tpu_torch.ops import cluster_fused as cf
    from asy_vrnet_tpu_torch.utils.weights import flax_from_state_dict

    register_droppath_variant(monkeypatch)
    kw = dict(phi="nano", variant=DROPPATH_VARIANT, compute_dtype="float32",
              use_pallas_cluster=True, prestem_s2d=False, input_size=(size, size))
    jm, params, bstats, port = noisy_model_pair(jconfig.ModelConfig(**kw),
                                                tconfig.ModelConfig(**kw), size, seed=1)
    img, rad = inputs(size)

    def fwd(p):
        out, _ = jm.apply({"params": p, "batch_stats": bstats}, img, rad, train=True,
                          rngs={"droppath": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return out

    rng = np.random.default_rng(5)
    cot = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                       jax.eval_shape(fwd, params))

    @jax.jit
    def fwd_bwd(p, c):
        out, vjp = jax.vjp(fwd, p)
        return out, vjp(c)[0]

    (jdet, jseg), jgrad = fwd_bwd(params, cot)

    calls = {"cluster_mix_fwd": 0, "cluster_mix_bwd": 0}
    for name in calls:
        real = getattr(cf, name)
        monkeypatch.setattr(cf, name, lambda *a, _n=name, _r=real, **k: (
            calls.__setitem__(_n, calls[_n] + 1), _r(*a, **k))[1])
    port.train()
    set_generator(port, torch.Generator().manual_seed(0))
    det, seg = port(torch.from_numpy(img), torch.from_numpy(rad))
    cdet, cseg = cot
    total = sum((o * torch.from_numpy(c)).sum() for o, c in zip(det, cdet))
    (total + (seg * torch.from_numpy(cseg)).sum()).backward()
    assert calls == {"cluster_mix_fwd": mix_calls, "cluster_mix_bwd": mix_calls}

    for a, b in zip((*det, seg), (*jdet, jseg)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=5e-5, rtol=1e-4)
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in port.named_parameters()}
    got = jax.tree_util.tree_leaves(flax_from_state_dict(grads, params))
    want = jax.tree_util.tree_leaves_with_path(jgrad)
    assert len(got) == len(want) == len(grads)
    scale = max(float(np.abs(np.asarray(w)).max()) for _, w in want)
    for (path, w), g in zip(want, got):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g).reshape(w.shape), w, rtol=1e-4,
                                   atol=2e-5 * scale, err_msg=jax.tree_util.keystr(path))
