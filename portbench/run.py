#!/usr/bin/env python3
"""Runs one cell of the benchmark of ``ipk_tpu_torch`` on one NVIDIA GPU.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. The cell, its configuration, its traffic
and its metrics are found by name through ``BENCHMARK.json``:
``portbench/configs/<config>.json`` (the deployment and the limits of the
comparison), ``portbench/traffic/<traffic>.json`` (how builds are offered)
and ``portbench/metrics/<metric>.py`` (one reader a per-layer metric).

Set-up makes the project from the seed, loads the program's kernels and
warms up with whole builds. The window then starts whole database builds
through ``ipk_tpu_torch.pipeline.build_database``, one at a time, until
``--seconds`` have passed, and lets the last one finish. With ``--trace 1``
the window runs under ``torch.profiler`` and the run reports the per-layer
metrics; otherwise the end-to-end ones. After the window the last build's
database is compared with the plain reference (``compare.py``); the numbers
compared and their limits are the last lines on standard error and the last
key of the result. The result is the last line on standard output.

Exits non-zero without a result when there is no CUDA card, when the
program cannot be imported, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level modules the run may not hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "ipk_tpu")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def cell_plan(bench: dict, workload: str) -> dict:
    """The cell's entries of ``BENCHMARK.json``: its configuration, traffic
    and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    return {"cell": cell, "config": configs[cell["config"]],
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device: str = "cuda") -> int:
    """One run; ``device="cpu"`` skips the look for a card (the CPU tests
    drive the rest of a run so)."""
    args = parse_args(argv)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    plan = cell_plan(bench, args.workload)
    config = load_json(os.path.join(ROOT, plan["config"]["file"]))
    traffic = load_json(os.path.join(
        HERE, "traffic", plan["cell"]["traffic"] + ".json"))
    threads = str(traffic["num_threads"])
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = threads
    cache = os.path.join(ROOT, "build", "portbench")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))

    import torch
    chips = int(plan["cell"]["chips"])
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        print(f"this cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import harness
    harness.DEVICE = device
    result = harness.run_cell(plan, config, traffic, args, STARTED)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark may not "
              "hold JAX or the JAX package", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
