"""The import fence: each module of the harness, each metric reader and
the reference, imported in a fresh interpreter, loads nothing whose
top-level name (before the first dot) is jax, jaxlib, flax, optax or
uniter_tpu; the reference does not load uniter_tpu_torch either (whose
name only begins with uniter_tpu)."""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

import pytest

from gpubench.harness import FORBIDDEN, ROOT, forbidden_modules

PROBE = """
import importlib, importlib.util, json, sys
target = sys.argv[1]
if target.endswith(".py"):
    spec = importlib.util.spec_from_file_location("probe_metric", target)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
else:
    importlib.import_module(target)
print(json.dumps(sorted(sys.modules)))
"""
REFERENCE = ["gpubench.reference", "gpubench.reference.model",
             "gpubench.reference.optim", "gpubench.reference.philox",
             "gpubench.reference.batches"]
HARNESS = ["gpubench.run", "gpubench.harness", "gpubench.training",
           "gpubench.tracing", "gpubench.yardstick", "gpubench.corpus",
           "gpubench.drivers.train_vqa", "gpubench.drivers.pretrain_mix"]
METRICS = sorted(glob.glob(os.path.join(ROOT, "gpubench", "metrics", "*.py")))


def _loaded(target):
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, "-c", PROBE, target], cwd=ROOT,
                         env=env, capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("target", HARNESS + METRICS + REFERENCE)
def test_nothing_of_jax_loads(target):
    mods = _loaded(target)
    assert forbidden_modules(mods) == []
    if target in REFERENCE:
        assert not [m for m in mods if m.split(".")[0] == "uniter_tpu_torch"]


def test_names_compare_whole():
    assert forbidden_modules(["uniter_tpu_torch.ops", "jaxtyping"]) == []
    assert forbidden_modules(["uniter_tpu.ops", "jax.numpy", "optax"]) == \
        ["jax", "optax", "uniter_tpu"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "optax", "uniter_tpu"}


def test_a_cell_run_loads_the_port_and_not_jax(tmp_path):
    """A whole tiny run in a fresh interpreter: the port is loaded, JAX and
    the JAX package are not."""
    from gpubench.tests.conftest import make_checkout

    root = make_checkout(str(tmp_path))
    code = (
        "import json, sys\n"
        "from gpubench import run\n"
        f"rc = run.main(['--workload', 'tiny-vqa', '--seed', '5', "
        f"'--seconds', '1', '--trace', '0'], require_card=False, "
        f"device='cpu', root={root!r})\n"
        "print(json.dumps(sorted(sys.modules)))\n"
        "sys.exit(rc)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ROOT},
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "uniter_tpu_torch" in mods
    assert forbidden_modules(mods) == []
