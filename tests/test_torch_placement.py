"""ipk_tpu_torch.placement against ipk_tpu.placement, on the CPU.

Tolerances are those of ipk_tpu's own placement tests: the device scorers
sum float32 rows in their own order, so totals agree with ipk_tpu's device
scorer within rtol 1e-6 / atol 1e-5 (tests/test_placement.py) and with the
published formula within rtol 1e-4 / atol 5e-3
(tests/test_placement_fidelity.py); rankings and branch ids are exact.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ipk_tpu import serialize
from ipk_tpu.alignment import read_fasta
from ipk_tpu.db import PhyloKmerDB
from ipk_tpu.pipeline import BuildParams, build_database
from ipk_tpu.placement import TpuPlacementIndex
from ipk_tpu.placement import place_queries as jax_place_queries
from ipk_tpu_torch import db as tdb
from ipk_tpu_torch import serialize as tserialize
from ipk_tpu_torch.placement import TorchPlacementIndex, place_queries

from fixtures import make_project
from test_placement_fidelity import (make_db, make_queries,
                                     naive_published_score)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_db(db):
    """The port's PhyloKmerDB holding an ipk_tpu database's arrays (the
    two packages share no classes)."""
    out = tdb.PhyloKmerDB(db.kmer_size, db.omega, db.sequence_type, db.tree,
                          db.tree_index)
    out.set_data(db.keys, db.filter_values, db.offsets, db.branches,
                 db.scores, db.positions)
    return out


@pytest.fixture(scope="module")
def built_db(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_place")
    tree_file, fasta_file, ar_dir = make_project(tmp, num_leaves=6, width=30,
                                                 seed=33)
    out = str(tmp / "DB.ipk")
    build_database(BuildParams(
        refalign=fasta_file, reftree=tree_file, states="nucl",
        working_dir=str(tmp / "wd"), ar_dir=ar_dir, kmer_size=5, omega=1.5,
        output_filename=out, verbosity=0))
    return tmp, out, fasta_file


def test_torch_index_matches_tpu_index(built_db):
    tmp, out, fasta = built_db
    db = serialize.load(out)
    seqs = [s for _, s in read_fasta(fasta)]
    seqs += ["ACGNACGTAC", "ACG"]   # an ambiguity; shorter than k
    ids_j, tot_j, cnt_j = TpuPlacementIndex(db).place_batch(seqs)
    index = TorchPlacementIndex(tserialize.load(out), device="cpu")
    ids_t, tot_t, cnt_t = index.place_batch(seqs, device_batch=3)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(cnt_t, cnt_j)
    np.testing.assert_allclose(tot_t, tot_j, rtol=1e-6, atol=1e-5)
    top_t = index.place_batch_topk(seqs, top=3, device_batch=4)
    top_j = TpuPlacementIndex(db).place_batch_topk(seqs, top=3)
    np.testing.assert_array_equal(top_t[0], top_j[0])
    np.testing.assert_allclose(top_t[1], top_j[1], rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(top_t[2], top_j[2])


def test_torch_index_matches_published_formula():
    rng = np.random.default_rng(11)
    db = make_db(rng)
    queries = make_queries(rng, db)
    ids, totals, _ = TorchPlacementIndex(port_db(db),
                                         device="cpu").place_batch(queries)
    top1 = 0
    for qi, seq in enumerate(queries):
        ref = naive_published_score(db, seq)
        ref_vec = np.array([ref[int(b)] for b in ids])
        np.testing.assert_allclose(totals[qi], ref_vec, rtol=1e-4, atol=5e-3)
        top1 += int(ids[np.argmax(totals[qi])] == max(ref, key=ref.get))
    assert top1 == len(queries)


def test_topk_exact_tie_takes_lower_column():
    """Branches with equal totals rank by column, lower first, as
    jax.lax.top_k ranks them."""
    k = 3
    keys = np.array([0, 5, 9], np.uint64)          # AAA, ACC, AGC
    offsets = np.array([0, 3, 5, 7], np.int64)
    branches = np.array([4, 1, 7, 7, 1, 2, 4], np.uint32)
    scores = np.array([-0.5, -0.5, -0.5, -0.25, -0.25, -0.75, -0.75],
                      np.float32)
    db = PhyloKmerDB(k, 1.5, "nucl", "(a,b)r;", [])
    db.set_data(keys, np.zeros(3, np.float32), offsets, branches, scores)
    queries = ["AAA", "ACC", "AGC", "AAAAC", "TTT"]
    ids_t, sc_t, _ = TorchPlacementIndex(
        port_db(db), device="cpu").place_batch_topk(queries, top=4)
    ids_j, sc_j, _ = TpuPlacementIndex(db).place_batch_topk(queries, top=4)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(sc_t, sc_j)
    # AAA: branches 1, 4, 7 tie at -0.5 ahead of 2; columns are ascending ids
    assert ids_t[0].tolist() == [1, 4, 7, 2]
    assert ids_t[4].tolist() == [1, 2, 4, 7]      # nothing hit: all tie


@pytest.mark.parametrize("n_queries", [16, 80])
def test_place_queries_matches_ipk_tpu(built_db, n_queries):
    """Below 64 queries both take the host engine, from 64 on the device
    engines: the same branch ids and scores."""
    tmp, out, fasta = built_db
    db = serialize.load(out)
    base = list(read_fasta(fasta))
    queries = [(f"q{i}", base[i % len(base)][1][i % 7:])
               for i in range(n_queries)]
    got = place_queries(tserialize.load(out), queries, top=3, device="cpu")
    want = jax_place_queries(db, queries, top=3)
    assert len(got) == len(want) == n_queries
    for a, b in zip(got, want):
        assert a["n"] == b["n"]
        assert [p[0] for p in a["p"]] == [p[0] for p in b["p"]]
        np.testing.assert_allclose([p[1] for p in a["p"]],
                                   [p[1] for p in b["p"]], rtol=1e-6,
                                   atol=1e-5)


def test_cli_place_and_diff_text(built_db):
    """python -m ipk_tpu_torch place writes a jplace v3 file with the branch
    ids ipk_tpu ranks first; diff-text is ipk_tpu's tolerant comparator."""
    tmp, out, fasta = built_db
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])

    def cli(*args):
        return subprocess.run([sys.executable, "-m", "ipk_tpu_torch", *args],
                              cwd=str(tmp), env=env, capture_output=True,
                              text=True, timeout=300)

    jp = str(tmp / "out.jplace")
    r = cli("place", out, fasta, "-o", jp, "--top", "3", "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("Placed 6 queries")
    doc = json.load(open(jp))
    assert doc["version"] == 3 and "{" in doc["tree"]
    db = serialize.load(out)
    want = jax_place_queries(db, read_fasta(fasta), top=3)
    assert [[p[0] for p in pl["p"]] for pl in doc["placements"]] == \
        [[p[0] for p in pl["p"]] for pl in want]

    r = cli("diff-text", out, out)
    assert r.returncode == 0, r.stdout + r.stderr
    # a database with one score moved by far more than eps differs
    other = serialize.load(out)
    other.scores = other.scores.copy()
    other.scores[0] += np.float32(0.5)
    moved = str(tmp / "moved.ipk")
    serialize.save(other, moved)
    r = cli("diff-text", out, moved, "--eps", "1e-3")
    assert r.returncode == 1
