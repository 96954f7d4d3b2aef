"""The readers of the per-layer metrics that read the program's spans
(``portbench/metrics/{prepare,serialize,mif0,unpack,untraced}_s.dense.py``):
each is the mean over a window's builds of one key of
``BuildResult.timings``, and None when a build of the window lacks the key
(the program before its spans: the metric is then left out).

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

READERS = {"prepare_s.dense": "prepare", "serialize_s.dense": "serialize",
           "mif0_s.dense": "mif0", "unpack_s.dense": "unpack",
           "untraced_s.dense": "untraced"}


def window(timings):
    return harness.Window({}, timings, window_s=10.0, trace=None)


@pytest.mark.parametrize("name,key", sorted(READERS.items()))
def test_reader_is_the_mean_of_its_key(name, key):
    builds = [{key: 0.5, "other": 9.0}, {key: 0.75, "other": 1.0},
              {key: 1.0}]
    assert harness.load_reader(name).read(window(builds)) == (
        pytest.approx(0.75))


@pytest.mark.parametrize("name,key", sorted(READERS.items()))
def test_reader_is_none_when_a_build_lacks_its_key(name, key):
    reader = harness.load_reader(name)
    assert reader.read(window([{key: 0.5}, {"other": 1.0}])) is None
    assert reader.read(window([])) is None


def test_readers_are_listed_for_the_build_cell():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert (m["source"], m["moves"], m["workloads"]) == (
            "program_span", "build_s.dense", ["dna256x1500-k8.build"])
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           name + ".py"))
