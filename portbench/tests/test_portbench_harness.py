"""CPU tests of the benchmark harness (``portbench/``), at tiny sizes.

    python -m pytest portbench/tests -q

They drive the harness without a card (``device="cpu"``): the builds of
``ipk_tpu_torch`` then run on the CPU, and the comparison with the plain
reference is the one a chip run makes.
"""

from __future__ import annotations

import ast
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
sys.path.insert(0, ROOT)

from portbench import compare, devtrace, harness, project, reference  # noqa: E402
from portbench import run as run_mod  # noqa: E402

TINY = {"num_leaves": 10, "width": 40}
with open(os.path.join(BENCH_DIR, "configs", "dna256x1500-k8.json")) as _f:
    MODEL = json.load(_f)["model"]


def tiny_config(name: str, k: int, omega: float, check_keys="all") -> dict:
    with open(os.path.join(BENCH_DIR, "configs", "dna256x1500-k8.json")) as f:
        config = json.load(f)
    config.update(name=name, check_keys=check_keys, **TINY)
    config["build"].update(kmer_size=k, omega=omega)
    return config


def tiny_traffic() -> dict:
    with open(os.path.join(BENCH_DIR, "traffic", "build.json")) as f:
        traffic = json.load(f)
    traffic.update(name="tiny", num_threads=2)
    return traffic


@pytest.fixture
def tree_copy(tmp_path):
    """A checkout holding BENCHMARK.json and portbench/, beside the
    program, with a tiny configuration, traffic and metric dropped in and
    listed in BENCHMARK.json: no file that was there is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "ipk_tpu_torch"), root / "ipk_tpu_torch")
    os.symlink(os.path.join(ROOT, "native"), root / "native")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(root / "portbench" / "configs" / "tiny-k6.json", "w") as f:
        json.dump(tiny_config("tiny-k6", 6, 1.5), f)
    with open(root / "portbench" / "traffic" / "tiny.json", "w") as f:
        json.dump(tiny_traffic(), f)
    (root / "portbench" / "metrics" / "builds_done.count.py").write_text(
        "def read(window):\n    return window.builds\n")
    bench["configs"].append({"name": "tiny-k6", "source": "test",
                             "file": "portbench/configs/tiny-k6.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-k6.tiny", "config": "tiny-k6",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "build_s.tiny", "unit": "s",
                                "better": "lower", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["tiny-k6.tiny"]})
    bench["per_layer"].append({"name": "builds_done.count", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "build_s.tiny",
                               "workloads": ["tiny-k6.tiny"]})
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return root


def run_copy(root, trace: int, seed: int = 2**31 + 3):
    """run.py of the copy, in a fresh process, without the look for a card:
    (exit code, last stdout line, the modules the run held)."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "from portbench import run\n"
        "rc = run.main(['--workload', 'tiny-k6.tiny', '--seed', "
        f"'{seed}', '--seconds', '0.5', '--trace', '{trace}'], "
        "device='cpu')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
        "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    return proc.returncode, lines[-2] if len(lines) > 1 else "", \
        json.loads(lines[-1]) if lines else [], proc.stderr


@pytest.mark.parametrize("trace", [0, 1])
def test_dropped_files_run_end_to_end(tree_copy, trace):
    rc, line, modules, err = run_copy(tree_copy, trace)
    assert rc == 0, err[-3000:]
    result = json.loads(line)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    names = set(result["metrics"])
    if trace:
        assert names == {"builds_done.count"}
        assert result["metrics"]["builds_done.count"]["value"] >= 1
        assert result["device"]["window_s"] > 0
        assert "idle_gaps" in result["breakdown"]
    else:
        assert names == {"build_s.tiny", "setup_s"}
    for name, c in result["checks"].items():
        assert f"check {name} {c['value']!r} limit {c['limit']!r}" in err
    assert not set(modules) & {"jax", "jaxlib", "flax", "ipk_tpu"}


def test_control_script_separates_program_and_control(tree_copy):
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "from portbench import control\n"
            "sys.exit(control.main(['--config', 'tiny-k6', '--traffic', "
            "'tiny', '--seeds', '11', '12', '--control', '1'], "
            "device='cpu'))")
    proc = subprocess.run([sys.executable, "-c", code, str(tree_copy)],
                          cwd=tree_copy, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    limits = last["limits"]
    assert all(last["program_max"][n] <= limits[n] for n in compare.NAMES)
    assert last["control_min"]["score_gap"] > limits["score_gap"]


def test_run_refuses_without_a_card(tree_copy):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "tiny-k6.tiny",
         "--seed", "1", "--seconds", "1"], cwd=tree_copy,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys; sys.path.insert(0, '.'); from portbench import run;"
            "sys.exit(run.main(['--workload', 'dna256x1500-k8.build', "
            "'--seed', '1', '--seconds', '1'], device='cpu'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def recorded_window(config: dict) -> harness.Window:
    """Two builds, a one-second traced window: combine_max 2 x 2 ms,
    staircase 0.3 + 0.2 ms, one 1 ms copy overlapping the first kernel;
    spans host_extract and wait_stage1 on the window's thread."""
    us = 1.0
    ev = [{"ph": "X", "name": devtrace.WINDOW, "ts": 0.0, "dur": 1e6,
           "pid": 1, "tid": 7},
          {"ph": "X", "cat": "kernel", "name": "void combine_max_kernel<false>",
           "ts": 1000.0, "dur": 2000 * us},
          {"ph": "X", "cat": "kernel", "name": "void combine_max_kernel<false>",
           "ts": 501000.0, "dur": 2000 * us},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
           "ts": 2500.0, "dur": 1000 * us},
          {"ph": "X", "cat": "kernel", "name": "staircase_warp_kernel(Args)",
           "ts": 10000.0, "dur": 300 * us},
          {"ph": "X", "cat": "kernel", "name": "staircase_block_kernel(Args)",
           "ts": 20000.0, "dur": 200 * us},
          {"ph": "X", "name": "portbench.wait_stage1", "ts": 0.0,
           "dur": 100000.0, "pid": 1, "tid": 7},
          {"ph": "X", "name": "portbench.host_extract", "ts": 100000.0,
           "dur": 400000.0, "pid": 1, "tid": 7},
          {"ph": "X", "name": "portbench.host_extract", "ts": 0.0,
           "dur": 900000.0, "pid": 1, "tid": 8}]
    timings = [{"host_extract": 0.25, "filter_merge": 0.5, "host_merge": 1.0},
               {"host_extract": 0.35, "filter_merge": 0.7, "host_merge": 3.0}]
    return harness.Window(config, timings, 1.0, devtrace.Trace(ev))


def test_metric_readers_on_a_recorded_trace():
    with open(os.path.join(BENCH_DIR, "configs", "dna256x1500-k8.json")) as f:
        config = json.load(f)
    w = recorded_window(config)
    busy = 2500 + 2000 + 300 + 200     # the copy overlaps the first kernel
    assert w.trace.busy_s == pytest.approx(busy / 1e6)

    def read(name):
        return harness.load_reader(name).read(w)

    assert read("host_extract_s.dense") == pytest.approx(0.30)
    assert read("filter_merge_s.dense") == pytest.approx(0.60)
    assert read("device_idle_pct.dense") == pytest.approx(
        100 * (1 - busy / 1e6))
    G, W = 1020, 1493
    need = max(2 * G * W * 65536 / 67e12,
               (4 * G * W * 512 + 4 * G * 65536 + 8 * G) / 3.35e12)
    assert read("combine_max_roofline") == pytest.approx(
        100 * 2 * need / 4e-3)
    gaps = dict(w.trace.breakdown()["idle_gaps"])
    assert gaps["wait_stage1"] == pytest.approx((100000 - 3000) / 1e6)
    assert gaps["host_extract"] == pytest.approx(400000 / 1e6)
    assert gaps["outside_spans"] == pytest.approx((500000 - 2000) / 1e6)
    ops = dict(w.trace.breakdown()["device_ops"])
    assert ops["void combine_max_kernel<false>"] == pytest.approx(4e-3)


def test_readers_find_nothing_without_a_trace():
    with open(os.path.join(BENCH_DIR, "configs", "dna256x1500-k8.json")) as f:
        config = json.load(f)
    w = harness.Window(config, [{"host_extract": 1.0}], 1.0, None)
    for name in ("combine_max_roofline", "device_idle_pct.dense"):
        assert harness.load_reader(name).read(w) is None
    assert harness.load_reader("filter_merge_s.dense").read(w) is None


def build_tiny(tmp_path, k: int, omega: float, seed: int):
    from ipk_tpu_torch.pipeline import build_database
    files = project.make_project(str(tmp_path), TINY["num_leaves"],
                                 TINY["width"], seed, MODEL)
    config = tiny_config("t", k, omega)
    out = str(tmp_path / "DB.ipk")
    harness.DEVICE = "cpu"
    with contextlib.redirect_stdout(io.StringIO()):
        build_database(harness.build_params(files, str(tmp_path / "w"), out,
                                            config, tiny_traffic()))
    return files, config, out


@pytest.mark.parametrize("k,omega,keys", [(6, 1.5, "all"), (7, 1.5, "all"),
                                          (12, 2.0, 3000)])
def test_reference_agrees_with_the_port_and_the_control_does_not(
        tmp_path, k, omega, keys):
    files, config, out = build_tiny(tmp_path, k, omega, seed=4242 + k)
    lay = reference.layout(open(files.tree_file).read())
    logp = torch.log10(torch.from_numpy(files.probs).float())
    sample = compare.sample_keys(k, keys, 9)
    limits = config["limits"]
    got = compare.compare(reference.read_ipk(out), logp, lay, sample, k,
                          omega, limits)
    assert all(got[n] <= limits[n] for n in compare.NAMES), got
    assert got["score_gap"] < 1e-5
    control = compare.reference_database(logp.to(torch.bfloat16), lay,
                                         sample, k, omega)
    bad = compare.compare(control, logp, lay, sample, k, omega, limits)
    assert bad["score_gap"] > 10 * limits["score_gap"], bad
    if keys == "all":          # 3000 keys of 4^12 hold few near eps
        assert bad["entries_off"] > 0


def test_layout_follows_the_extended_tree():
    root = project.parse_newick("((L0:1,L1:1):1,L2:1)root;")
    ext = project.extend(root, 5)
    inner = [n for n in project.postorder(ext) if n.children]
    names = [n.label for n in inner]
    lay = reference.layout("((L0:1,L1:1):1,L2:1)root;")
    # preorder of the non-root nodes: (L0,L1), L0, L1, L2; postorder ids
    assert lay.branch_ids.tolist() == [2, 0, 1, 3]
    assert lay.num_nodes == 5
    for (x1, x0), v in zip(lay.ghost_rows, ["", "L0", "L1", "L2"]):
        assert names[x1].endswith("_X1") and names[x0].endswith("_X0")
        assert int(names[x1].split("_")[0]) == int(names[x0].split("_")[0]) + 1


def test_project_is_a_function_of_the_seed(tmp_path):
    a = project.make_project(str(tmp_path / "a"), 12, 30, 2**40 + 1,
                             MODEL)
    b = project.make_project(str(tmp_path / "b"), 12, 30, 2**40 + 1,
                             MODEL)
    c = project.make_project(str(tmp_path / "c"), 12, 30, 2**40 + 2,
                             MODEL)
    for name in ("tree.newick", "reference.fasta",
                 "ar_out/align.raxml.ancestralProbs",
                 "ar_out/align.raxml.ancestralTree"):
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes()
    assert not np.array_equal(a.probs, c.probs)
    np.testing.assert_array_equal(a.probs, b.probs)
    # the file holds each probability as the decimal of the returned value
    rows = (tmp_path / "a" / "ar_out" /
            "align.raxml.ancestralProbs").read_text().splitlines()[1:]
    vals = np.array([[float(x) for x in r.split("\t")[3:]] for r in rows])
    np.testing.assert_array_equal(vals, a.probs.reshape(-1, 4))


def fault_unchanged(monkeypatch):
    """A build that returns at once and leaves the output as it was."""
    from ipk_tpu_torch import pipeline
    monkeypatch.setattr(pipeline, "build_database",
                        lambda p: types.SimpleNamespace(timings={}))


def fault_half_left_out(monkeypatch):
    """Half of the branches' ghost posteriors left out of stage 1."""
    from ipk_tpu_torch import builder
    real = builder.stage1_inputs

    def half(*a, **kw):
        s1 = real(*a, **kw)
        P = s1.P_all.copy()
        P[P.shape[0] // 2:] = -np.inf
        return s1._replace(P_all=P, prefix_all=builder.dense.
                           best_score_prefix(P))

    monkeypatch.setattr(builder, "stage1_inputs", half)


def fault_altered(monkeypatch):
    """Every score nudged by 4e-3 where the rows are sorted for writing."""
    from ipk_tpu_torch import builder
    real = builder._sort_batch

    def nudged(*a):
        keys, fv, offsets, branches, scores, positions = real(*a)
        return keys, fv, offsets, branches, scores + np.float32(4e-3), \
            positions

    monkeypatch.setattr(builder, "_sort_batch", nudged)


def fault_unsorted(monkeypatch):
    """Rows written in key order, each with its own fv, not in (fv, key)
    order."""
    from ipk_tpu_torch import builder
    real = builder._sort_batch

    def by_key(keys, fv, counts, branches, scores, positions):
        flat = np.zeros_like(fv)
        out = real(keys, flat, counts, branches, scores, positions)
        return (out[0], fv[np.lexsort((keys, flat))]) + tuple(out[2:])

    monkeypatch.setattr(builder, "_sort_batch", by_key)


@pytest.mark.parametrize("fault,number", [
    (fault_unchanged, None), (fault_half_left_out, "entries_off"),
    (fault_altered, "score_gap"), (fault_unsorted, "order_off")])
def test_a_broken_build_is_not_correct(monkeypatch, fault, number):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        plan = run_mod.cell_plan(json.load(f), "dna256x1500-k8.build")
    config = tiny_config("t", 6, 1.5)
    harness.DEVICE = "cpu"
    fault(monkeypatch)
    args = types.SimpleNamespace(seed=77, seconds=0.2, trace=0)
    result = harness.run_cell(plan, config, tiny_traffic(), args, 0.0)
    assert result["correct"] is False, result["checks"]
    if number is None:          # no database was written: nothing compared
        assert result["checks"] == {}
    else:
        c = result["checks"][number]
        assert c["value"] > c["limit"], result["checks"]


FORBIDDEN = {"jax", "jaxlib", "flax", "ipk_tpu"}


def imported_names(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("name", sorted(
    os.path.relpath(os.path.join(d, f), BENCH_DIR)
    for d, _, fs in os.walk(BENCH_DIR) for f in fs if f.endswith(".py")))
def test_no_file_imports_jax_or_the_jax_package(name):
    found = imported_names(os.path.join(BENCH_DIR, name))
    assert not found & FORBIDDEN, found


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, json; sys.path.insert(0, sys.argv[1])\n"
            "from portbench import compare, peaks, project, reference\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    proc = subprocess.run([sys.executable, "-c", code, ROOT],
                          capture_output=True, text=True, timeout=300)
    held = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not held & (FORBIDDEN | {"ipk_tpu_torch"}), held
    for name in ("reference.py", "compare.py", "project.py", "peaks.py"):
        found = imported_names(os.path.join(BENCH_DIR, name))
        assert "ipk_tpu_torch" not in found, (name, found)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ipk_tpu_torch_like", types.ModuleType(
        "ipk_tpu_torch_like"))
    assert run_mod.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ipk_tpu.sub", types.ModuleType("x"))
    assert run_mod.forbidden_modules() == ["ipk_tpu"]


def test_a_window_that_writes_no_database_is_not_correct(monkeypatch):
    """The warm-up writes to the null device, so when a host stall makes
    the window's only build end past the deadline before any build was due
    to write, nothing is left to compare: not correct."""
    from ipk_tpu_torch import pipeline
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        plan = run_mod.cell_plan(json.load(f), "dna256x1500-k8.build")
    real = pipeline.build_database
    calls = []

    def stalled(p):
        calls.append(p.output_filename)
        res = real(p)
        if len(calls) == 2:               # the window's first build
            import time
            time.sleep(4.0)
        return res

    monkeypatch.setattr(pipeline, "build_database", stalled)
    harness.DEVICE = "cpu"
    args = types.SimpleNamespace(seed=78, seconds=3.0, trace=0)
    result = harness.run_cell(plan, tiny_config("t", 6, 1.5),
                              tiny_traffic(), args, 0.0)
    assert calls == [os.devnull, os.devnull], calls
    assert result["correct"] is False and result["checks"] == {}


def test_spans_fail_on_a_function_the_program_lacks(monkeypatch):
    from ipk_tpu_torch import builder, pipeline
    prepare = pipeline.prepare
    monkeypatch.delattr(builder, "_sort_batch")
    with pytest.raises(AttributeError, match="_sort_batch"):
        with harness.spans():
            pass
    assert pipeline.prepare is prepare      # what was wrapped is restored


def test_posteriors_are_the_exact_marginals():
    """On a three-taxon tree the posteriors of every inner node of the
    extended tree equal those summed over every assignment of states."""
    import itertools
    law = project.Model.of(MODEL)
    assert law.rates.mean() == pytest.approx(1.0)
    assert law.frequencies @ law.transition(0.3)[1] == pytest.approx(
        law.frequencies)
    root = project.parse_newick("((L0:0.2,L1:0.05):0.1,L2:0.3)root;")
    states = {"L0": np.array([0, 1, 2]), "L1": np.array([0, 3, 2]),
              "L2": np.array([1, 1, 0])}
    ar = project.extend(root, 5)
    got = project.posteriors(ar, law, states, 3)
    nodes = list(project.postorder(ar))
    inner = [n for n in nodes if n.children]
    at = {id(n): i for i, n in enumerate(inner)}
    parent = {id(c): n for n in nodes for c in n.children}
    combos = np.array(list(itertools.product(range(4), repeat=len(inner))))
    for s in range(3):
        total = np.zeros(len(combos))
        for c in range(len(law.rates)):
            like = law.frequencies[combos[:, at[id(ar)]]].copy()
            for n in nodes:
                if n is ar or (not n.children and n.label not in states):
                    continue
                p = law.transition(n.length)[c]
                x = combos[:, at[id(parent[id(n)])]]
                y = combos[:, at[id(n)]] if n.children else states[n.label][s]
                like *= p[x, y]
            total += like
        for i in range(len(inner)):
            want = [total[combos[:, i] == x].sum() / total.sum()
                    for x in range(4)]
            np.testing.assert_allclose(got[i, s], want, atol=1e-12)
