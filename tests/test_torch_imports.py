"""The port imports no JAX: a static check over its sources.  (A runtime
`sys.modules` check cannot work here, because the environment may import
JAX before any test runs.)"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "asy_vrnet_tpu"}
SOURCES = sorted((ROOT / "asy_vrnet_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_walk_covers_the_training_modules_and_the_smoke_script():
    """Every module the train step (module path and fused blocks) and the
    mixer ablation tool run is among the checked sources."""
    have = {str(p.relative_to(ROOT)) for p in SOURCES}
    want = {"chip_smoke.py"} | {f"asy_vrnet_tpu_torch/{m}.py" for m in (
        "ops/losses_seg", "ops/losses_seg_fused", "ops/simota", "ops/simota_fused",
        "ops/losses_det", "ops/kernels", "train/optim", "train/state", "train/train_step",
        "data/synthetic", "data/preprocess", "utils/weights", "utils/device",
        "ops/block", "ops/cluster", "ops/cluster_fused", "models/cluster_block",
        "models/remat", "utils/profiling", "ops/mixer_ablate", "tools/ablate_mixer_fwd")}
    assert want <= have, sorted(want - have)


def test_checker_sees_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom asy_vrnet_tpu.ops import cluster\n"
                   "import asy_vrnet_tpu_torch\nfrom . import sibling\n"
                   "def f():\n    import flax\n")
    assert set(_imported_roots(src)) == {"jax", "asy_vrnet_tpu", "asy_vrnet_tpu_torch",
                                         "flax"}
