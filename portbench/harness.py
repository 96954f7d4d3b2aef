"""One run of a cell: set-up, the window of whole builds, the traced window's
reading, the comparison with the reference and the result line.

The program is ``ipk_tpu_torch``; this module and the modules it loads from
``portbench/`` take from it only ``pipeline.BuildParams`` and
``pipeline.build_database`` (the in-process ``python -m ipk_tpu_torch
build``), the kernel library's loader, and the ``timings`` of each
``BuildResult``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

import torch

from portbench import compare, devtrace, project, reference

HERE = os.path.dirname(os.path.abspath(__file__))
#: where the builds and the reference run; the CPU tests set "cpu"
DEVICE = "cuda"


def _synchronize() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


class Window:
    """What a metric reader reads: the builds of the window, their
    ``timings``, the configuration, and with ``--trace 1`` the trace."""

    def __init__(self, config: dict, timings: List[Dict[str, float]],
                 window_s: float, trace: Optional[devtrace.Trace]):
        self.config = config
        self.timings = timings
        self.builds = len(timings)
        self.window_s = window_s
        self.trace = trace

    def mean_timing(self, key: str) -> Optional[float]:
        values = [t[key] for t in self.timings if key in t]
        if len(values) != self.builds or not values:
            return None
        return float(sum(values) / len(values))


def load_reader(name: str):
    """``portbench/metrics/<name>.py``: UNIT, and read(window) -> value or
    None."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cpu_seconds() -> float:
    """This process's CPU seconds, user and system, over all its threads:
    beside a build's wall time it shows whether a slow build worked more or
    waited."""
    t = os.times()
    return t.user + t.system


def build_params(project_files, work: str, output: str, config: dict,
                 traffic: dict):
    from ipk_tpu_torch.pipeline import BuildParams
    b = config["build"]
    return BuildParams(
        refalign=project_files.fasta_file, reftree=project_files.tree_file,
        working_dir=work, output_filename=output,
        ar_dir=project_files.ar_dir, states="nucl", model=b["model"],
        kmer_size=b["kmer_size"], omega=b["omega"], filter=b["filter"],
        ghosts=b["ghosts"], reduction_ratio=b["reduction_ratio"],
        max_candidates=b["max_candidates"],
        uncompressed=not traffic["compressed"], on_disk=traffic["on_disk"],
        num_threads=traffic["num_threads"], verbosity=0, device=DEVICE)


# spans the traced run puts around the program's layers, by where each is
# looked up when the build calls it: (module, attribute, span name)
SPANS = [
    ("ipk_tpu_torch.pipeline", "prepare", "prepare"),
    ("ipk_tpu_torch.pipeline", "build", "stage1_to_serialize"),
    ("ipk_tpu_torch.builder", "stage1_inputs", "stage1_inputs"),
    ("ipk_tpu_torch.builder", "_extract_batch", "host_extract"),
    ("ipk_tpu_torch.builder", "_extract_compact", "host_extract"),
    ("ipk_tpu_torch.builder", "_sort_batch", "sort"),
    ("ipk_tpu_torch.serialize", "save", "serialize"),
]


def _lookup(mod_name: str, attr: str):
    """The module and the function the build calls, or an error that names
    the one the program no longer has: a span that found nothing to wrap
    would move its time to ``outside_spans`` unseen."""
    import importlib
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, attr, None)
    if not callable(fn):
        raise AttributeError(f"the traced run wraps {mod_name}.{attr}, "
                             "which the program does not have")
    return mod, fn


@contextlib.contextmanager
def spans():
    """Wrap each of SPANS in a ``torch.profiler.record_function`` for the
    traced window, and the builder's stage-1 prefetch in a span over each
    wait for it; restore them after."""
    saved = []
    try:
        for mod_name, attr, label in SPANS:
            mod, fn = _lookup(mod_name, attr)

            def wrapped(*a, __fn=fn, __label=label, **kw):
                with torch.profiler.record_function("portbench." + __label):
                    return __fn(*a, **kw)

            saved.append((mod, attr, fn))
            setattr(mod, attr, wrapped)
        builder, prefetch = _lookup("ipk_tpu_torch.builder", "_prefetch")

        def waited(*a, __fn=prefetch, **kw):
            # the main thread waiting for stage 1's next batch
            items = __fn(*a, **kw)
            while True:
                with torch.profiler.record_function("portbench.wait_stage1"):
                    item = next(items, items)
                if item is items:
                    return
                yield item

        saved.append((builder, "_prefetch", prefetch))
        builder._prefetch = waited
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def run_cell(plan: dict, config: dict, traffic: dict, args,
             started: float) -> dict:
    from ipk_tpu_torch.core import _build
    from ipk_tpu_torch.pipeline import build_database

    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        return _run(plan, config, traffic, args, started, tmp,
                    _build, build_database)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(plan, config, traffic, args, started, tmp, _build,
         build_database) -> dict:
    files = project.make_project(tmp, config["num_leaves"], config["width"],
                                 args.seed, config["model"])
    if DEVICE == "cuda":
        _build.load()
    work = os.path.join(tmp, "work")
    out = os.path.join(tmp, "DB.ipk")
    params = build_params(files, work, out, config, traffic)
    with contextlib.redirect_stdout(sys.stderr):
        # whole builds of the cell's own project, written to the null
        # device: every kernel and host library loaded, the host heap the
        # program keeps grown, and no database that a window build did not
        # write left for the comparison
        slowest = 0.0
        for _ in range(traffic["warmup_builds"]):
            tb = time.perf_counter()
            build_database(dataclasses.replace(params,
                                               output_filename=os.devnull))
            took = time.perf_counter() - tb
            slowest = max(slowest, took)
            print(f"[portbench] warm-up build {took:.3f} s", file=sys.stderr)
        _synchronize()
        gc.collect()
        setup_s = time.monotonic() - started

        timings: List[Dict[str, float]] = []
        attempted = failed = 0
        profiler = (devtrace.profiler(DEVICE == "cuda") if args.trace
                    else None)
        span_ctx = spans() if args.trace else contextlib.nullcontext()
        with span_ctx:
            if profiler is not None:
                profiler.__enter__()
            marker = (torch.profiler.record_function(devtrace.WINDOW)
                      if args.trace else contextlib.nullcontext())
            with marker:
                t0 = time.perf_counter()
                cpu0 = cpu = cpu_seconds()
                deadline = t0 + args.seconds
                while True:
                    attempted += 1
                    tb = time.perf_counter()
                    # builds write to the null device until the window may
                    # end within three of the slowest builds so far; from
                    # then on each writes the file the comparison reads,
                    # after removing the last. A window whose builds all
                    # went to the null device leaves no file: not correct.
                    writes = tb + 3 * slowest >= deadline
                    if writes:
                        with contextlib.suppress(FileNotFoundError):
                            os.remove(out)
                    try:
                        res = build_database(dataclasses.replace(
                            params, output_filename=out if writes
                            else os.devnull))
                    except Exception as exc:   # a build that fails counts
                        failed += 1
                        print(f"build {attempted} failed: {exc!r}",
                              file=sys.stderr)
                        break
                    timings.append(dict(res.timings))
                    parts = " ".join(
                        f"{k} {res.timings[k]:.3f}" for k in
                        ("computation", "host_extract", "sort", "serialize")
                        if k in res.timings)
                    del res
                    last_s = time.perf_counter() - tb
                    slowest = max(slowest, last_s)
                    now = cpu_seconds()
                    print(f"[portbench] build {len(timings)} {last_s:.3f} s"
                          f"{' (writes)' if writes else ''}; {parts}; "
                          f"cpu {now - cpu:.3f} s", file=sys.stderr)
                    cpu = now
                    if time.perf_counter() >= deadline:
                        break
                window_s = time.perf_counter() - t0
                print(f"[portbench] window {window_s:.3f} s, "
                      f"{len(timings)} builds; "
                      f"cpu {cpu_seconds() - cpu0:.3f} s", file=sys.stderr)
            if profiler is not None:
                _synchronize()
                profiler.__exit__(None, None, None)
    memory_peak = (int(torch.cuda.max_memory_allocated())
                   if DEVICE == "cuda" else 0)
    trace = None
    if profiler is not None:
        trace = devtrace.read(profiler, os.path.join(tmp, "trace.json"))
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    checks = (check(config, files, out, args.seed)
              if timings and os.path.exists(out) else {})
    correct = (failed == 0 and bool(timings) and bool(checks)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    window = Window(config, timings, window_s, trace)
    metrics = {}
    if args.trace:
        for m in plan["per_layer"]:
            value = load_reader(m["name"]).read(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in plan["end_to_end"]:
            if m["name"] == "setup_s":
                value = setup_s
            elif timings:
                value = window_s / len(timings)
            else:
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if DEVICE == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(0) if DEVICE == "cuda"
                       else "cpu"),
              "count": int(plan["cell"]["chips"]),
              "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if trace is not None:
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    result["checks"] = checks
    return result


def check(config: dict, files, db_path: str, seed: int) -> dict:
    """Compare the last build's database with the reference: {name: {value,
    limit}} for each number of ``compare``."""
    b = config["build"]
    limits = config["limits"]
    db = reference.read_ipk(db_path)
    with open(files.tree_file) as f:
        lay = reference.layout(f.read())
    logp = torch.log10(torch.from_numpy(files.probs).to(DEVICE,
                                                         torch.float32))
    keys = compare.sample_keys(b["kmer_size"], config["check_keys"], seed)
    numbers = compare.compare(db, logp, lay, keys, b["kmer_size"],
                              b["omega"], limits)
    del logp, db
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return {name: {"value": numbers[name], "limit": limits[name]}
            for name in compare.NAMES}


def emit(result: dict) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, then the result as the last line on standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
