"""The benchmark loads neither JAX nor the JAX package, and its reference
loads nothing of the port: every `vrbench` module is imported in a fresh
interpreter and the top-level names in `sys.modules` are compared whole."""
from __future__ import annotations

import json
import os
import subprocess
import sys

from vrbench import run

FORBIDDEN = ("jax", "jaxlib", "flax", "asy_vrnet_tpu")


def _modules() -> list[str]:
    out = []
    for dirpath, _, files in os.walk(run.HERE):
        rel = os.path.relpath(dirpath, run.ROOT)
        if "tests" in rel.split(os.sep) or "__pycache__" in rel:
            continue
        for f in files:
            if f.endswith(".py") and "." not in f[:-3]:
                mod = os.path.join(rel, f[:-3]).replace(os.sep, ".")
                out.append(mod[:-len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(out)


def _loaded_after(modules: list[str]) -> set[str]:
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_jax_and_no_jax_package():
    mods = _modules()
    assert "vrbench.run" in mods and "vrbench.reference.model" in mods
    assert not _loaded_after(mods) & set(FORBIDDEN)


def test_metric_readers_load_no_jax():
    names = [f[:-3] for f in os.listdir(os.path.join(run.HERE, "metrics")) if f.endswith(".py")]
    code = ("import json, sys\nfrom vrbench import run\n"
            f"for n in {names!r}: run.metric_reader(n)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert not set(json.loads(out.stdout.strip().splitlines()[-1])) & set(FORBIDDEN)


def test_reference_loads_no_port():
    loaded = _loaded_after([m for m in _modules() if m.startswith("vrbench.reference")])
    assert "asy_vrnet_tpu_torch" not in loaded
    assert not loaded & set(FORBIDDEN)
