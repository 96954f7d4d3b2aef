"""The port's builds over several ranks (gloo on the CPU), against ipk_tpu's
builds over conftest's 8 virtual devices: tests/test_builder_modes.py's
sharded modes (dense, key-batched, forced sparse through the device key
merge, the chunked host merge, the merge's bin-overflow fallback that
reuses the enumeration, the merge's budget boundary, positions, on-disk,
``--device-mi`` with 1 and 4 key batches and amino) at 2 ranks, the dense,
sparse and positions builds at 4. (tests/test_multihost.py's two-process
build through the port's CLI is tests/test_torch_build.py's.)

Every rank writes the whole database. Tolerance: none (decompressed
payloads), except ``--device-mi``, whose f32 filter values are held within
rtol 2e-5 / atol 1e-7 of the host f64 filter with every row's branches and
scores equal (tests/test_builder_modes.py's rule; rows whose f32 values tie
may change places).
"""

import json
import os
import zlib

import numpy as np
import pytest

import ipk_tpu.builder as jax_builder
from ipk_tpu import serialize
from ipk_tpu.pipeline import BuildParams as JaxParams
from ipk_tpu.pipeline import build_database as jax_build_database
from ipk_tpu.seq import AA

from fixtures import make_project
from torch_ranks import run_ranks

#: (job name, ranks, project, port options, builder patch, env); the
#: reference is ipk_tpu's build with the same options and patch
BUILDS = [
    ("dense", 2, "dna", {}, {}, {}),
    ("kb4", 2, "dna", {}, {"key_batches": 4}, {}),
    ("sparse", 2, "dna", {}, {"sparse": True}, {}),
    ("sparse_merge_branches", 2, "dna", {"merge_branches": True},
     {"sparse": True}, {}),
    ("sparse_chunked", 2, "dna", {}, {"sparse": True},
     {"IPK_TPU_NO_DEVICE_MERGE": "1"}),
    ("sparse_bin_overflow", 2, "dna", {},
     {"sparse": True, "merge_overflow": True}, {}),
    ("sparse_over_budget", 2, "dna", {}, {"sparse": True, "budget": 1}, {}),
    # AA k=4: half-window codes above 20^2, the bit-packed key space
    ("aa_sparse", 2, "aa", {"kmer_size": 4}, {"sparse": True}, {}),
    ("positions", 2, "dna", {"keep_positions": True}, {}, {}),
    ("on_disk", 2, "dna", {"on_disk": True}, {"key_batches": 4}, {}),
    ("on_disk_sparse", 2, "dna", {"on_disk": True}, {"sparse": True}, {}),
    ("dense", 4, "dna", {}, {}, {}),
    ("sparse", 4, "dna", {}, {"sparse": True}, {}),
    ("positions", 4, "dna", {"keep_positions": True}, {}, {}),
]
#: (job name, ranks, key batches, amino)
DEVICE_MI = [("mi_kb1", 2, 1, False), ("mi_kb4", 2, 4, False),
             ("mi_amino", 2, None, True)]
#: the route each sparse build's merge takes
MERGE_ROUTE = {"sparse": "device", "sparse_merge_branches": "device",
               "on_disk_sparse": "device", "aa_sparse": "device",
               "sparse_chunked": "host",
               "sparse_bin_overflow": "host, after a bin overflow",
               "sparse_over_budget": "host"}


def payload(path):
    raw = open(path, "rb").read()
    try:
        return zlib.decompress(raw)
    except zlib.error:
        return raw


def project_params(project):
    tmp, states, k, omega, tree_file, fasta_file, ar_dir = project
    return dict(refalign=fasta_file, reftree=tree_file, states=states,
                ar_dir=ar_dir, kmer_size=k, omega=omega)


def jax_build(project, name, monkeypatch, patch=None, env=None, **opts):
    """ipk_tpu's build (sharded over the 8 virtual devices) of the same
    options and builder patch: (database path, explored tuples)."""
    tmp = project[0]
    patch, env = patch or {}, env or {}
    with monkeypatch.context() as m:
        if "key_batches" in patch:
            m.setattr(jax_builder, "pick_key_batches",
                      lambda *a, **kw: patch["key_batches"])
        if patch.get("sparse"):
            m.setattr(jax_builder, "MAX_DENSE_KEYSPACE", 1)
        for key, value in env.items():
            m.setenv(key, value)
        out = str(tmp / f"jax_{name}.ipk")
        result = jax_build_database(JaxParams(
            **{**project_params(project), **opts},
            working_dir=str(tmp / f"wd_jax_{name}"), output_filename=out,
            verbosity=0))
    return out, result.num_explored


@pytest.fixture(scope="module")
def projects(tmp_path_factory):
    dna = tmp_path_factory.mktemp("sharded_dna")
    aa = tmp_path_factory.mktemp("sharded_aa")
    return {"dna": (dna, "nucl", 5, 1.5) + make_project(
                dna, num_leaves=6, width=25, seed=21),
            "aa": (aa, "amino", 3, 4.0) + make_project(
                aa, num_leaves=4, width=12, seed=77, traits=AA)}


@pytest.fixture(scope="module")
def ranks(projects, tmp_path_factory):
    """Every build of BUILDS and DEVICE_MI, on 2 and on 4 gloo ranks."""
    d = tmp_path_factory.mktemp("sharded_ranks")
    jobs = {2: [], 4: []}
    for name, n, project, opts, patch, env in BUILDS:
        jobs[n].append(dict(name=name, kind="build", patch=patch, env=env,
                            params={**project_params(projects[project]),
                                    **opts}))
    for name, n, kb, amino in DEVICE_MI:
        project = projects["aa" if amino else "dna"]
        patch = {} if kb is None else {"key_batches": kb}
        jobs[n].append(dict(name=name, kind="build", patch=patch, env={},
                            params={**project_params(project),
                                    "device_mi": True}))
    for n, job_list in jobs.items():
        run_ranks(n, job_list, d)
    return d


def rank_files(d, name, n):
    return [os.path.join(str(d), f"{name}.rank{r}.ipk") for r in range(n)]


def rank_route(d, name, rank):
    with open(os.path.join(str(d), f"{name}.rank{rank}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,n,project,opts,patch,env", BUILDS,
                         ids=[f"{b[0]}-{b[1]}ranks" for b in BUILDS])
def test_sharded_build_matches_ipk_tpu(projects, ranks, monkeypatch, name,
                                       n, project, opts, patch, env):
    """Each rank's database is payload-equal to ipk_tpu's build of the same
    mode, with the same explored-tuple count (summed once over the ranks);
    a sparse build's merge takes ipk_tpu's route."""
    ref, explored = jax_build(projects[project], f"{name}_{n}", monkeypatch,
                              patch=patch, env=env, **opts)
    ref = payload(ref)
    assert serialize.load(rank_files(ranks, name, n)[0]).size() > 0
    for r, path in enumerate(rank_files(ranks, name, n)):
        assert payload(path) == ref, f"rank {r}"
        assert rank_route(ranks, name, r)["num_explored"] == explored
        if name in MERGE_ROUTE:
            assert rank_route(ranks, name, r)["merge"] == MERGE_ROUTE[name]
    if opts.get("keep_positions"):
        assert serialize.load(rank_files(ranks, name, n)[0]).positions \
            is not None


def rows(db):
    """{key: (branches, scores, filter value)} of a database."""
    out = {}
    for i, key in enumerate(db.keys.tolist()):
        lo, hi = db.offsets[i], db.offsets[i + 1]
        out[key] = (db.branches[lo:hi].tolist(), db.scores[lo:hi].tolist(),
                    db.filter_values[i])
    return out


@pytest.mark.parametrize("name,n,kb,amino", DEVICE_MI,
                         ids=[m[0] for m in DEVICE_MI])
def test_device_mi_matches_host_filter(projects, ranks, monkeypatch, name, n,
                                       kb, amino):
    """--device-mi over the ranks: rows equal to ipk_tpu's host-f64 build,
    fv within rtol 2e-5 / atol 1e-7 of it and of ipk_tpu's own device-mi
    build."""
    project = projects["aa" if amino else "dna"]
    patch = {} if kb is None else {"key_batches": kb}
    host = rows(serialize.load(jax_build(project, f"{name}_host",
                                         monkeypatch, patch=patch)[0]))
    jax_mi = rows(serialize.load(jax_build(project, f"{name}_jax",
                                           monkeypatch, patch=patch,
                                           device_mi=True)[0]))
    assert host
    for path in rank_files(ranks, name, n):
        got = rows(serialize.load(path))
        assert set(got) == set(host)
        for key, (branches, scores, fv) in got.items():
            assert branches == host[key][0], key
            assert scores == host[key][1], key
            np.testing.assert_allclose(fv, host[key][2], rtol=2e-5,
                                       atol=1e-7)
            np.testing.assert_allclose(fv, jax_mi[key][2], rtol=2e-5,
                                       atol=1e-7)

