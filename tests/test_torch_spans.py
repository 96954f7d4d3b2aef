"""The span recorder of ipk_tpu_torch (``ipk_tpu_torch/spans.py``): the one
writer of ``BuildResult.timings``.

A small dense build on the CPU returns every stage key; its spans nest as
the build does (children inside their parents, on their thread or under
the span that started the prefetch worker); ``host_extract`` is its
``unpack`` and ``extract`` spans, ``sort`` covers ``concat``, ``untraced``
is the self time of the grouping spans; under ``torch.profiler`` the spans
are ``ipk.*`` events of the Chrome trace, nested as recorded; without a
profiler no ``record_function`` is opened. The names the benchmark's traced
run wraps resolve to callables of the program.

This file imports no jax; its ``cuda``-marked test runs on a card with
``python -m pytest --noconftest -q -m cuda tests/test_torch_spans.py``.
"""

import importlib
import json
import os
import sys
import threading

import pytest
import torch

import chip_smoke
from ipk_tpu_torch.pipeline import BuildParams, build_database
from ipk_tpu_torch.spans import Recorder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the keys a dense in-RAM build that writes its database returns
DENSE_KEYS = {
    "build_database", "prepare", "prepare.alignment", "prepare.tree",
    "prepare.extend", "prepare.ar", "prepare.ar_read", "build",
    "computation", "stage1_inputs", "device_compute", "transfer",
    "transfer_bytes", "wait_stage1", "host_extract", "unpack", "extract",
    "mif0", "filter_merge", "sort", "concat", "serialize", "untraced"}
#: the spans whose self time is ``untraced``
GROUPS = {"build_database", "prepare", "build", "computation",
          "filter_merge"}


def _params(tmp, num_leaves=10, width=80, k=6, **kw):
    tree_file, fasta_file, ar_dir = chip_smoke.make_project(
        tmp, num_leaves=num_leaves, width=width, seed=7)
    return BuildParams(refalign=fasta_file, reftree=tree_file,
                       working_dir=str(tmp / "wd"), ar_dir=ar_dir,
                       kmer_size=k, omega=1.5,
                       output_filename=str(tmp / "DB.ipk"), verbosity=0,
                       device="cpu", **kw)


@pytest.fixture(scope="module")
def dense_builds(tmp_path_factory):
    """Three dense builds (16 taxa x 200 sites, k=7) whose batch crosses as
    a bitmask, so every span of the dense path runs."""
    params = _params(tmp_path_factory.mktemp("spans"), 16, 200, 7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IPK_TPU_TRANSFER", "bitmask")
        return [build_database(params) for _ in range(3)]


@pytest.fixture(scope="module")
def dense_build(dense_builds):
    return dense_builds[0]


def test_dense_build_returns_every_key(dense_build):
    t = dense_build.timings
    assert DENSE_KEYS <= set(t), DENSE_KEYS - set(t)
    assert t["transfer_bytes"] > 0 and isinstance(t["transfer_bytes"], int)
    assert all(t[k] >= 0 for k in DENSE_KEYS)
    assert dense_build.db.size() > 0


def test_children_lie_inside_their_parents(dense_build):
    recorded = dense_build.spans
    assert {s.name for s in recorded} >= DENSE_KEYS - {
        "device_compute", "transfer_bytes", "untraced"}
    roots = [s for s in recorded if s.parent is None]
    assert [s.name for s in roots] == ["build_database"]
    for s in recorded:
        assert s.start <= s.end
        if s.parent is None:
            continue
        p = s.parent
        assert p.start <= s.start and s.end <= p.end, (s.name, p.name)
        assert s.duration <= p.duration
    by_parent = {}
    for s in recorded:
        if s.parent is not None and s.parent.thread == s.thread:
            by_parent.setdefault(id(s.parent), []).append(s)
    for s in recorded:
        children = by_parent.get(id(s), [])
        assert sum(c.duration for c in children) <= s.duration
        assert s.self_time == pytest.approx(
            s.duration - sum(c.duration for c in children), abs=1e-9)
    # the prefetch worker's spans name the span that started it
    worker = [s for s in recorded if s.name in ("stage1.halves",
                                                "stage1.batch")]
    assert worker and all(s.parent.name == "computation"
                          and s.thread != s.parent.thread for s in worker)


def test_keys_cover_what_they_covered(dense_builds, dense_build):
    # host_extract is unpack + extract; the median over three builds, since
    # a loaded host can stall the main thread between two spans (the
    # prefetch worker holding the interpreter while it frees stage 1)
    gaps = sorted((b.timings["host_extract"] - b.timings["unpack"]
                   - b.timings["extract"]) / b.timings["host_extract"]
                  for b in dense_builds)
    assert gaps[0] >= 0 and gaps[1] <= 0.01, gaps
    t = dense_build.timings
    assert t["mif0"] <= t["extract"]
    assert t["concat"] <= t["sort"]
    assert t["sort"] + t["serialize"] <= t["filter_merge"]
    assert t["stage1_inputs"] + t["host_extract"] + t["wait_stage1"] <= (
        t["computation"])
    children = sum(t[k] for k in ("prepare.alignment", "prepare.tree",
                                  "prepare.extend", "prepare.ar",
                                  "prepare.ar_read"))
    assert children <= t["prepare"]
    assert t["prepare"] + t["build"] <= t["build_database"]


def test_untraced_is_the_self_time_of_the_groups(dense_build):
    t = dense_build.timings
    groups = [s for s in dense_build.spans if s.group]
    assert {s.name for s in groups} == GROUPS
    assert t["untraced"] >= 0
    assert t["untraced"] == pytest.approx(
        sum(s.self_time for s in groups), rel=1e-9)
    assert t["untraced"] < t["build_database"]


def test_record_function_only_under_a_profiler(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    rec = Recorder()
    with rec.span("outer", group=True), rec.span("inner"):
        pass
    rec.add("count", 3)
    assert opened == []
    assert set(rec.timings) == {"outer", "inner", "count", "untraced"}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with rec.span("outer"):
            pass
    assert opened == ["ipk.outer"]


def test_a_build_without_a_profiler_opens_no_record_function(
        tmp_path, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    result = build_database(_params(tmp_path))
    assert len(result.spans) > 20 and opened == []


def _events(path):
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X"
                and str(e.get("name", "")).startswith("ipk.")]


def test_profile_trace_nests_the_spans_as_recorded(tmp_path):
    """``--profile``: every span the build opened is an ``ipk.<name>``
    event of the Chrome trace, on the thread it ran on, and each lies in
    its parent's event."""
    prof_dir = tmp_path / "prof"
    result = build_database(_params(tmp_path, profile_dir=str(prof_dir)))
    events = _events(prof_dir / "trace.json")
    # the profiler runs around build(): the root and prepare precede it
    traced = [s for s in result.spans if s.name != "build_database"
              and not s.name.startswith("prepare")]
    assert sorted(e["name"] for e in events) == sorted(
        "ipk." + s.name for s in traced)
    parent_of = {s.name: s.parent.name for s in traced}
    same_thread = {s.name: s.thread == s.parent.thread for s in traced}
    for e in events:
        parent = parent_of[e["name"][len("ipk."):]]
        if parent == "build_database":
            continue
        assert any(p["name"] == "ipk." + parent
                   and p["ts"] <= e["ts"]
                   and e["ts"] + e["dur"] <= p["ts"] + p["dur"]
                   and (p["tid"] == e["tid"])
                   == same_thread[e["name"][len("ipk."):]]
                   for p in events), e["name"]


def test_recorder_counts_exactly_across_threads():
    """More threads than cores add to one key and open spans under an
    adopted parent while the interpreter switches threads often: no update
    is lost and every span lands under its parent."""
    rec = Recorder()
    n_threads, n_adds = 3 * (os.cpu_count() or 1) + 2, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with rec.span("root", group=True):
            root = rec.current()

            def work():
                rec.adopt(root)
                for _ in range(n_adds):
                    with rec.span("leaf"):
                        rec.add("n", 1)

            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert rec.timings["n"] == n_threads * n_adds
    leaves = [s for s in rec.spans if s.name == "leaf"]
    assert len(leaves) == n_threads * n_adds
    assert all(s.parent is root for s in leaves)
    assert rec.timings["leaf"] == pytest.approx(
        sum(s.duration for s in leaves), rel=1e-9)
    # spans on other threads do not count against the root's self time
    assert rec.timings["untraced"] == pytest.approx(root.duration)


def test_traced_run_wraps_callables_of_the_program():
    sys.path.insert(0, REPO)
    try:
        harness = importlib.import_module("portbench.harness")
    finally:
        sys.path.remove(REPO)
    wrapped = list(harness.SPANS) + [
        ("ipk_tpu_torch.builder", "_prefetch", "wait_stage1")]
    for mod_name, attr, _ in wrapped:
        fn = getattr(importlib.import_module(mod_name), attr, None)
        assert callable(fn), f"{mod_name}.{attr}"
        assert fn.__module__.startswith("ipk_tpu_torch."), (mod_name, attr)


@pytest.mark.cuda
def test_device_span_on_the_card_takes_the_events_time(cuda_device):
    """On the card a device span's key is the events' time of the work it
    waits for: positive, within its host duration, and near the time of the
    kernels alone."""
    rec = Recorder()
    x = torch.randn(4096, 4096, device=cuda_device)
    for _ in range(3):      # the math library's first calls set it up
        x = x @ x.t()
        x = x / x.norm()
    torch.cuda.synchronize()
    with rec.span("work", key="device_compute", device=cuda_device) as s:
        for _ in range(20):
            x = x @ x.t()
            x = x / x.norm()
        torch.cuda.synchronize()
    begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    begin.record()
    for _ in range(20):
        x = x @ x.t()
        x = x / x.norm()
    end.record()
    end.synchronize()
    alone = begin.elapsed_time(end) / 1e3
    got = rec.timings["device_compute"]
    assert 0 < got <= s.duration
    assert got == pytest.approx(alone, rel=0.5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")
