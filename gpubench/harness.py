"""What every cell shares: the benchmark's files found by name, the seeds,
the weights, the card check, the caches, the import fence and the result
line."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import sys
from typing import Callable, Dict, List, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "uniter_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``uniter_tpu_torch`` is not
    ``uniter_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def cache_dirs(root: str = ROOT) -> Dict[str, str]:
    """Fixed directories inside the checkout for every cache a run writes:
    the corpus, the traces, and Triton's and PyTorch's kernel caches (the
    port builds its own kernels into ``build/uniter_tpu_torch/``)."""
    base = os.path.join(root, "gpubench", "cache")
    dirs = {"base": base, "corpus": os.path.join(base, "corpus"),
            "trace": os.path.join(base, "trace"),
            "TRITON_CACHE_DIR": os.path.join(base, "triton"),
            "TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions")}
    for k in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        os.environ[k] = dirs[k]
    return dirs


class Benchmark:
    """``BENCHMARK.json`` and the files its names lead to."""

    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise SystemExit(f"no config {name!r} in BENCHMARK.json")

    def mix(self, traffic: str) -> dict:
        path = os.path.join(self.root, "gpubench", "mixes", traffic + ".json")
        with open(path) as f:
            return json.load(f)

    def metrics(self, workload: str, section: str) -> List[dict]:
        return [m for m in self.spec[section]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> Callable:
        path = os.path.join(self.root, "gpubench", "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "gpubench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def driver(self, kind: str):
        return importlib.import_module(f"gpubench.drivers.{kind}")


class Seeds:
    """Independent streams from the run's ``--seed`` (any whole number):
    ``weights``, ``data`` (the texts' words and answers), ``loop`` (the
    train loop's seed, of the dropout masks: below 2**31). The amount and
    order of the work (lengths, images, the loader's order) are the mix's."""

    def __init__(self, seed: int):
        words = np.random.SeedSequence(abs(int(seed))).generate_state(3)
        self.weights, self.data, self.loop = (int(w) % (2**31 - 1)
                                              for w in words)


def make_params(shapes: Dict[str, tuple], kinds: Dict[str, str], seed: int,
                device, std: float) -> Dict:
    """The model's initial parameters, on ``device`` from ``seed`` with a
    generator there: every "normal" leaf (sorted by name) cut from one
    normal(0, ``std``) draw, "ones" and "zeros" filled."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    normal = sorted(n for n in shapes if kinds[n] == "normal")
    total = sum(math.prod(shapes[n]) for n in normal)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32).mul_(std)
    out, ofs = {}, 0
    for n in normal:
        k = math.prod(shapes[n])
        out[n] = flat[ofs:ofs + k].view(shapes[n])
        ofs += k
    for n in shapes:
        if kinds[n] != "normal":
            fill = torch.ones if kinds[n] == "ones" else torch.zeros
            out[n] = fill(shapes[n], device=device, dtype=torch.float32)
    return out


def reference_shapes(model) -> Dict[str, tuple]:
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              names: Optional[List[str]] = None) -> Dict[str, float]:
    """Per-leaf gaps of norms: |prog - ref| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    names = sorted(names if names is not None else ref)
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             names: Optional[List[str]] = None):
    """(worst gap, leaf) of ``leaf_gaps``."""
    gaps = leaf_gaps(prog, ref, names)
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def emit(result: dict, checks: Dict[str, dict]):
    """The checks as the last lines of standard error, then the result as
    the last line of standard output, the checks under its last key."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}"
              + ("" if c["value"] <= c["limit"] else "  FAILED"),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}))
    sys.stdout.flush()
