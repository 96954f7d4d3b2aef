"""CPU tests of the on-disk cells (``dna150x1500-k10.build-on-disk``,
``dna256x1500-k8.build-on-disk``): the readers of their per-layer metrics
(``portbench/metrics/{spill,merge,merge_write}_s.disk.py``), the entries
that list them, and a tiny cell of the ``build-on-disk`` traffic run
through the harness on the CPU.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402
from portbench import run as run_mod  # noqa: E402

READERS = {"spill_s.disk": "spill", "merge_s.disk": "merge.blocks",
           "merge_write_s.disk": "merge.write"}
CELLS = ["dna150x1500-k10.build-on-disk", "dna256x1500-k8.build-on-disk"]


def window(timings):
    return harness.Window({}, timings, window_s=10.0, trace=None)


def load_bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,key", sorted(READERS.items()))
def test_reader_is_the_mean_of_its_key(name, key):
    builds = [{key: 2.0, "merge": 9.0}, {key: 3.0}, {key: 4.0}]
    assert harness.load_reader(name).read(window(builds)) == (
        pytest.approx(3.0))


@pytest.mark.parametrize("name,key", sorted(READERS.items()))
def test_reader_is_none_without_its_key(name, key):
    """An in-RAM build, or the program before its on-disk spans: the
    metric is left out, and nothing raises."""
    reader = harness.load_reader(name)
    in_ram = {"filter_merge": 1.0, "sort": 0.2, "serialize": 0.8}
    assert reader.read(window([in_ram, in_ram])) is None
    assert reader.read(window([{key: 1.0}, in_ram])) is None
    assert reader.read(window([])) is None


@pytest.mark.parametrize("cell", CELLS)
def test_on_disk_cells_report_their_metrics(cell):
    plan = run_mod.cell_plan(load_bench(), cell)
    assert plan["cell"]["traffic"] == "build-on-disk"
    assert plan["cell"]["chips"] == 1
    assert [m["name"] for m in plan["end_to_end"]] == ["build_s.dense",
                                                      "setup_s"]
    assert {m["name"] for m in plan["per_layer"]} == {
        "combine_max_roofline", "device_idle_pct.dense", *READERS}
    for m in plan["per_layer"]:
        if m["name"] in READERS:
            assert (m["source"], m["moves"], m["workloads"]) == (
                "program_span", "build_s.dense", CELLS)
    for name in ("configs/" + plan["cell"]["config"] + ".json",
                 "traffic/build-on-disk.json"):
        assert os.path.exists(os.path.join(BENCH_DIR, name))


def test_on_disk_traffic_is_the_build_traffic_on_disk():
    def load(name):
        with open(os.path.join(BENCH_DIR, "traffic", name + ".json")) as f:
            return json.load(f)

    ram, disk = load("build"), load("build-on-disk")
    assert disk["on_disk"] is True and ram["on_disk"] is False
    same = ("loop", "clients", "warmup_builds", "num_threads", "compressed")
    assert {k: disk[k] for k in same} == {k: ram[k] for k in same}


@pytest.fixture
def disk_copy(tmp_path):
    """A checkout holding BENCHMARK.json and portbench/ beside the program,
    with a tiny DNA k=10 configuration (the k=10 file at 4 taxa x 20
    sites: four key batches) and the ``build-on-disk`` traffic on two
    threads dropped in, its cell listed under the on-disk metrics."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "ipk_tpu_torch"), root / "ipk_tpu_torch")
    os.symlink(os.path.join(ROOT, "native"), root / "native")
    bench = load_bench()
    with open(os.path.join(BENCH_DIR, "configs",
                           "dna150x1500-k10.json")) as f:
        config = json.load(f)
    config.update(name="tiny-k10", num_leaves=4, width=20)
    with open(root / "portbench" / "configs" / "tiny-k10.json", "w") as f:
        json.dump(config, f)
    with open(os.path.join(BENCH_DIR, "traffic", "build-on-disk.json")) as f:
        traffic = json.load(f)
    traffic.update(name="tiny-on-disk", num_threads=2)
    with open(root / "portbench" / "traffic" / "tiny-on-disk.json",
              "w") as f:
        json.dump(traffic, f)
    cell = "tiny-k10.tiny-on-disk"
    bench["configs"].append({"name": "tiny-k10", "source": "test",
                             "file": "portbench/configs/tiny-k10.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": "tiny-k10",
                               "traffic": "tiny-on-disk", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("build_s.dense", *READERS):
            m["workloads"].append(cell)
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return root, cell


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_on_disk_cell_runs_correct(disk_copy, trace):
    root, cell = disk_copy
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "from portbench import run\n"
        f"sys.exit(run.main(['--workload', {cell!r}, '--seed', "
        f"'{2**31 + 77}', '--seconds', '0.5', '--trace', '{trace}'], "
        "device='cpu'))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    metrics = result["metrics"]
    if trace:
        assert set(READERS) <= set(metrics), metrics
        assert all(metrics[n]["value"] > 0 for n in READERS)
    else:
        assert set(metrics) == {"build_s.dense", "setup_s"}
