"""The span recorder of ipk_tpu_torch (``ipk_tpu_torch/spans.py``): the one
writer of ``BuildResult.timings``.

A small dense build on the CPU returns every stage key; its spans nest as
the build does (children inside their parents, on their thread or under
the span that started the prefetch worker); stage 2 runs in the prefetch
worker, its ``mif0`` span inside ``stage1.batch``, and ``host_extract`` only
makes the keys; ``sort`` covers ``concat``, ``untraced``
is the self time of the grouping spans; under ``torch.profiler`` the spans
are ``ipk.*`` events of the Chrome trace, nested as recorded; without a
profiler no ``record_function`` is opened. The names the benchmark's traced
run wraps resolve to callables of the program. An on-disk build (the DNA
k=10 configuration of the benchmark at 4 taxa x 20 sites, four key batches)
records its spill and its merge, its write's counters add up to the
decompressed payload, and its database passes the benchmark's comparison
with the plain reference; an in-RAM build records neither.

This file imports no jax; its ``cuda``-marked test runs on a card with
``python -m pytest --noconftest -q -m cuda tests/test_torch_spans.py``.
"""

import importlib
import json
import os
import sys
import threading
import zlib

import pytest
import torch

import chip_smoke
from ipk_tpu_torch import serialize
from ipk_tpu_torch.pipeline import BuildParams, build_database
from ipk_tpu_torch.spans import Recorder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the keys a dense in-RAM build that writes its database returns
DENSE_KEYS = {
    "build_database", "prepare", "prepare.alignment", "prepare.tree",
    "prepare.extend", "prepare.ar", "prepare.ar_read", "build",
    "computation", "stage1_inputs", "device_compute", "transfer",
    "transfer_bytes", "card_extract_batches", "wait_stage1", "host_extract",
    "mif0", "filter_merge", "sort", "concat", "serialize", "untraced"}
#: the counters among them
COUNTERS = {"transfer_bytes", "card_extract_batches"}
#: the spans whose self time is ``untraced``
GROUPS = {"build_database", "prepare", "build", "computation",
          "filter_merge"}
#: the keys only an on-disk build records, and the counters among them
DISK_COUNTERS = {"spill_parts", "spill_bytes", "merge_blocks", "merge_rows",
                 "merge_write_stored_bytes", "merge_write_deflated_bytes",
                 "merge_write_chunks"}
DISK_KEYS = {"spill", "merge", "merge.blocks", "merge.write"} | DISK_COUNTERS


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
    """Three dense builds (16 taxa x 200 sites, k=7), so every span of the
    dense path runs."""
    params = _params(tmp_path_factory.mktemp("spans"), 16, 200, 7)
    return [build_database(params) for _ in range(3)]


@pytest.fixture(scope="module")
def dense_build(dense_builds):
    return dense_builds[0]


def test_dense_build_returns_every_key(dense_build):
    t = dense_build.timings
    assert DENSE_KEYS <= set(t), DENSE_KEYS - set(t)
    assert all(t[k] > 0 and isinstance(t[k], int) for k in COUNTERS)
    assert all(t[k] >= 0 for k in DENSE_KEYS)
    assert dense_build.db.size() > 0


def test_children_lie_inside_their_parents(dense_build):
    recorded = dense_build.spans
    assert {s.name for s in recorded} >= DENSE_KEYS - COUNTERS - {
        "device_compute", "untraced"}
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
    # the mif0 column pass lies inside its batch's device work, on every
    # build
    for b in dense_builds:
        assert 0 < b.timings["mif0"] <= b.timings["device_compute"]
    t = dense_build.timings
    assert t["concat"] <= t["sort"]
    assert t["sort"] + t["serialize"] <= t["filter_merge"]
    assert t["stage1_inputs"] + t["host_extract"] + t["wait_stage1"] <= (
        t["computation"])
    children = sum(t[k] for k in ("prepare.alignment", "prepare.tree",
                                  "prepare.extend", "prepare.ar",
                                  "prepare.ar_read"))
    assert children <= t["prepare"]
    assert t["prepare"] + t["build"] <= t["build_database"]


def test_device_route_records_mif0_and_its_batches(dense_build):
    """Stage 2 runs beside stage 1 (the plain version of
    ``extract_columns`` here): the column pass is the ``mif0`` span, on the
    prefetch worker inside its ``stage1.batch``; every key batch adds one to
    ``card_extract_batches``; no bitmask is unpacked and no host extraction
    runs."""
    result = dense_build
    t, recorded = result.timings, result.spans
    batches = [s for s in recorded if s.name == "stage1.batch"]
    assert batches and t["card_extract_batches"] == len(batches)
    assert "unpack" not in t and "extract" not in t
    mif0 = [s for s in recorded if s.name == "mif0"]
    assert len(mif0) == len(batches) and t["mif0"] > 0
    assert all(s.parent.name == "stage1.batch" for s in mif0)
    assert "host_extract" in t and result.db.size() > 0


def _portbench(name):
    """A module of the benchmark (``portbench/``), which sits beside the
    program."""
    sys.path.insert(0, REPO)
    try:
        return importlib.import_module("portbench." + name)
    finally:
        sys.path.remove(REPO)


@pytest.fixture(scope="module")
def disk_build(tmp_path_factory):
    """The benchmark's DNA k=10 on-disk build, as its harness makes it, at 4
    taxa x 20 sites on the CPU: (result, project files, configuration, the
    output, the size of each part spilled under hashmaps/)."""
    harness, project = _portbench("harness"), _portbench("project")
    with open(os.path.join(REPO, "portbench", "configs",
                           "dna150x1500-k10.json")) as f:
        config = json.load(f)
    config.update(num_leaves=4, width=20)
    with open(os.path.join(REPO, "portbench", "traffic",
                           "build-on-disk.json")) as f:
        traffic = json.load(f)
    tmp = tmp_path_factory.mktemp("disk")
    files = project.make_project(str(tmp / "project"), 4, 20, 2**31 + 17,
                                 config["model"])
    out = str(tmp / "DB.ipk")
    spilled = {}
    real_save = serialize.save

    def save(db, filename, compressed=True):
        real_save(db, filename, compressed)
        if os.sep + "hashmaps" + os.sep in filename:
            spilled[filename] = os.path.getsize(filename)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "DEVICE", "cpu")
        params = harness.build_params(files, str(tmp / "wd"), out, config,
                                      traffic)
        mp.setattr(serialize, "save", save)
        result = build_database(params)
    return result, files, config, out, spilled


def test_on_disk_build_records_the_spill_and_the_merge(disk_build):
    result, _, _, _, _ = disk_build
    t = result.timings
    assert DISK_KEYS <= set(t), DISK_KEYS - set(t)
    assert all(t[k] > 0 and isinstance(t[k], int) for k in DISK_COUNTERS)
    assert all(t[k] > 0 for k in DISK_KEYS - DISK_COUNTERS)
    assert "sort" not in t and "serialize" not in t
    parents = {s.name: s.parent.name for s in result.spans
               if s.name in DISK_KEYS}
    assert parents == {"spill": "host_extract", "merge": "filter_merge",
                       "merge.blocks": "merge", "merge.write": "merge"}
    assert {s.name for s in result.spans if s.group} == GROUPS | {"merge"}


def test_spill_counters_count_the_parts_written(disk_build):
    result, _, _, out, spilled = disk_build
    t = result.timings
    assert len(spilled) == t["card_extract_batches"] == 4
    assert t["spill_parts"] == len(spilled)
    assert t["spill_bytes"] == sum(spilled.values())
    assert t["spill"] <= t["host_extract"]
    assert t["merge_rows"] == serialize.load(out).size()
    assert 1 <= t["merge_blocks"] <= t["merge_rows"]


def test_merge_write_counters_count_the_payload(disk_build):
    """The compressed write stores the scores (4 bytes an entry) and
    deflates the rest, the magic and the header included: the two counters
    add up to the decompressed payload."""
    result, _, _, out, _ = disk_build
    t = result.timings
    with open(out, "rb") as f:
        payload = zlib.decompress(f.read())
    assert t["merge_write_stored_bytes"] == (
        4 * serialize.load(out).num_entries())
    assert (t["merge_write_stored_bytes"] + t["merge_write_deflated_bytes"]
            == len(payload))
    assert t["merge_write_chunks"] >= 6


def test_merge_children_lie_within_the_merge(disk_build):
    result, _, _, _, _ = disk_build
    t = result.timings
    assert t["merge.blocks"] + t["merge.write"] <= t["merge"]
    assert t["merge"] <= t["filter_merge"]
    merge = next(s for s in result.spans if s.name == "merge")
    for s in result.spans:
        if s.name.startswith("merge."):
            assert merge.start <= s.start and s.end <= merge.end


def test_in_ram_build_records_no_spill_or_merge(dense_build):
    assert not DISK_KEYS & set(dense_build.timings)
    assert not DISK_KEYS & {s.name for s in dense_build.spans}


def test_on_disk_k10_build_passes_the_benchmark_comparison(disk_build):
    """The dense DNA k=10 on-disk build against the benchmark's plain
    reference (``portbench/compare.py``), over the configuration's sampled
    keys: every number within the configuration's limit, on the (f32 fv,
    key) row order of the on-disk merge."""
    compare, reference = _portbench("compare"), _portbench("reference")
    _, files, config, out, _ = disk_build
    b = config["build"]
    with open(files.tree_file) as f:
        lay = reference.layout(f.read())
    logp = torch.log10(torch.from_numpy(files.probs).to(torch.float32))
    keys = compare.sample_keys(b["kmer_size"], config["check_keys"],
                               2**31 + 17)
    db = reference.read_ipk(out)
    assert len(db.keys) > 0
    numbers = compare.compare(db, logp, lay, keys, b["kmer_size"],
                              b["omega"], config["limits"])
    assert set(numbers) == set(compare.NAMES)
    for name, value in numbers.items():
        assert value <= config["limits"][name], (name, numbers)


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
    harness = _portbench("harness")
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
