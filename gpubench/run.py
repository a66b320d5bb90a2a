"""Run one cell of the port's benchmark on the card:

    python3 -m gpubench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Everything is found by name: the cell in
``BENCHMARK.json``, its configuration's file, its traffic mix
``gpubench/mixes/<traffic>.json`` (whose ``kind`` names the driver,
``gpubench/drivers/<kind>.py``), and each per-layer metric's reader
``gpubench/metrics/<metric>.py``. The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, then the numbers compared beside their
limits); the numbers compared are also the last lines of standard error.
Without a card, or with fewer cards than the cell asks for, it prints no
result and exits 2. It never runs on the CPU.

``--mode control`` (with ``--seeds``) does not measure: for each seed it
builds the cell, runs its set-up steps and prints the program's and the
float8 control's numbers, with further diagnostics, as JSON lines.
``--fault`` plants a fault in the program (``half_batch``: the loss over
the first half of the rows, or half of each scoring call's images left
out; ``stale``: the optimizer leaves the state unchanged).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

from gpubench import harness  # noqa: E402

EXIT_NO_CARD = 2
EXIT_FENCE = 3


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--mode", choices=("bench", "control"), default="bench")
    p.add_argument("--seeds", default="",
                   help="comma-separated seeds for --mode control")
    p.add_argument("--fault", default=None,
                   choices=("half_batch", "stale"))
    return p.parse_args(argv)


def context(bench, args, device, seed, t_start):
    w = bench.workload(args.workload)
    cfg_entry = next(c for c in bench.spec["configs"]
                     if c["name"] == w["config"])
    return types.SimpleNamespace(
        workload=w, device=device, seconds=args.seconds,
        trace=bool(args.trace), seeds=harness.Seeds(seed),
        cfg=bench.config(w["config"]),
        cfg_path=os.path.join(bench.root, cfg_entry["file"]),
        mix=bench.mix(w["traffic"]), dirs=harness.cache_dirs(bench.root),
        fault=args.fault, t_start=t_start)


def card(chips: int):
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"gpubench: needs {chips} CUDA card(s); found {found}",
              file=sys.stderr)
        sys.exit(EXIT_NO_CARD)
    return "cuda"


def result(bench, ctx, e2e, record, limits, values, device):
    import torch

    name = ctx.workload["name"]
    if ctx.trace:
        metrics = {}
        for m in bench.metrics(name, "per_layer"):
            v = bench.reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench.metrics(name, "end_to_end")
                   if m["name"] in e2e}
    checks = harness_checks(values, limits)
    finite = all(v["value"] == v["value"] and abs(v["value"]) != float("inf")
                 for v in metrics.values())
    out = {"correct": finite and all(c["value"] <= c["limit"]
                                     for c in checks.values()),
           "attempted": len(record.steps), "failed": 0, "metrics": metrics}
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1,
           "memory_peak_bytes": int(e2e.get("peak_mem_gib", 0) * 2**30)}
    if ctx.trace and record.profile is not None:
        dev["busy_s"] = record.profile["busy_s"]
        dev["window_s"] = record.profile["wall_s"]
        out["breakdown"] = {"device_ops": record.profile["device_ops"],
                            "idle_gaps": record.profile["idle_gaps"]}
    out["device"] = dev
    return out, checks


def harness_checks(values, limits):
    return {k: {"value": float(values[k]), "limit": float(limits[k])}
            for k in limits}


def main(argv=None, require_card: bool = True, device: str = "cuda",
         root: str = harness.ROOT) -> int:
    args = parse(argv)
    bench = harness.Benchmark(root)
    w = bench.workload(args.workload)
    if require_card:
        device = card(int(w["chips"]))
    mix = bench.mix(w["traffic"])
    drv = bench.driver(mix["kind"])
    limits = mix["check"]["limits"]
    if args.mode == "control":
        seeds = [int(s) for s in args.seeds.split(",") if s] or [args.seed]
        args.seconds = min(args.seconds, 1.0)
        for seed in seeds:
            ctx = context(bench, args, device, seed, time.perf_counter())
            _, _, check = drv.run(ctx)
            print(json.dumps({"seed": seed, "fault": args.fault,
                              **check(control=True)}), flush=True)
        return 0
    ctx = context(bench, args, device, args.seed, T_START)
    e2e, record, check = drv.run(ctx)
    print("gpubench: window " + json.dumps(e2e), file=sys.stderr)
    values = check()["program"]
    out, checks = result(bench, ctx, e2e, record, limits, values, device)
    bad = harness.forbidden_modules()
    if bad:
        print(f"gpubench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return EXIT_FENCE
    harness.emit(out, checks)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
