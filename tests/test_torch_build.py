"""The port's dense build end to end on the CPU, against ipk_tpu.

Tolerance: none. Databases are compared by their decompressed payload (every
header field, column byte and row order), as tests/test_golden.py does.
"""

import os
import subprocess
import sys
import zlib

import pytest
import torch

import ipk_tpu.builder as jax_builder
import ipk_tpu_torch.builder as torch_builder
from ipk_tpu.pipeline import BuildParams as JaxParams
from ipk_tpu.pipeline import build_database as jax_build_database
from ipk_tpu.seq import AA
from ipk_tpu_torch.pipeline import BuildParams, build_database

from fixtures import make_project

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "golden")


def payload(path):
    raw = open(path, "rb").read()
    try:
        return zlib.decompress(raw)
    except zlib.error:
        return raw


def subprocess_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


@pytest.mark.parametrize("proj,states,k,omega,golden", [
    ("D-dna", "nucl", 7, 2.0, "DB_k7_o2.0.ipk"),
    ("D-aa", "amino", 4, 10.0, "DB_k4_o10.ipk"),
])
def test_port_rebuilds_golden(tmp_path, proj, states, k, omega, golden):
    root = os.path.join(GOLDEN, proj)
    out = str(tmp_path / "DB.ipk")
    result = build_database(BuildParams(
        refalign=os.path.join(root, "reference.fasta"),
        reftree=os.path.join(root, "tree.newick"),
        states=states, working_dir=str(tmp_path / "wd"),
        ar_dir=os.path.join(root, "ar_out"), kmer_size=k, omega=omega,
        output_filename=out, verbosity=0, device="cpu"))
    assert payload(out) == payload(os.path.join(root, golden))
    assert set(result.timings) >= {
        "device_compute", "transfer", "transfer_bytes", "host_extract",
        "computation", "sort", "serialize", "filter_merge"}


@pytest.fixture(scope="module")
def dna_project(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_dna")
    return (tmp, "nucl", 5, 1.5) + make_project(tmp, num_leaves=6, width=25,
                                                seed=21)


@pytest.fixture(scope="module")
def aa_project(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_aa")
    return (tmp, "amino", 3, 4.0) + make_project(
        tmp, num_leaves=5, width=15, seed=5, traits=AA)


@pytest.fixture(scope="module")
def k12_project(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_k12")
    return (tmp, "nucl", 12, 2.0) + make_project(tmp, num_leaves=5, width=30,
                                                 seed=12)


def build_pair(project, name, monkeypatch, key_batches=None, transfer=None,
               sparse=False, **overrides):
    """(ipk_tpu DB path, ipk_tpu_torch DB path) for the same project and
    options; ``sparse`` forces both builders onto the sparse path."""
    tmp, states, k, omega, tree_file, fasta_file, ar_dir = project
    if sparse:
        for mod in (jax_builder, torch_builder):
            monkeypatch.setattr(mod, "MAX_DENSE_KEYSPACE", 1)
    if key_batches is not None:
        for mod in (jax_builder, torch_builder):
            monkeypatch.setattr(mod, "pick_key_batches",
                                lambda *a, **kw: key_batches)
    if transfer is not None:
        monkeypatch.setenv("IPK_TPU_TRANSFER", transfer)
    outs = []
    for tag, params_cls, run, extra in [
            ("jax", JaxParams, jax_build_database, {}),
            ("torch", BuildParams, build_database, {"device": "cpu"})]:
        out = str(tmp / f"{name}_{tag}.ipk")
        params = params_cls(
            refalign=fasta_file, reftree=tree_file, states=states,
            working_dir=str(tmp / f"wd_{name}_{tag}"), ar_dir=ar_dir,
            kmer_size=k, omega=omega, output_filename=out, verbosity=0,
            **overrides, **extra)
        run(params)
        outs.append(out)
    return outs


@pytest.mark.parametrize("name,opts", [
    ("mif0", {}),
    ("random", {"filter": "random"}),
    ("merge", {"merge_branches": True}),
    ("kb2", {"key_batches": 2}),
    ("kb4", {"key_batches": 4}),
    ("idx", {"transfer": "idx"}),
    ("bitmask", {"transfer": "bitmask"}),
    ("dense", {"transfer": "dense"}),
    ("dense_merge", {"transfer": "dense", "merge_branches": True}),
])
def test_port_matches_jax_build(dna_project, monkeypatch, name, opts):
    jax_out, torch_out = build_pair(dna_project, name, monkeypatch, **opts)
    assert payload(torch_out) == payload(jax_out)


@pytest.mark.parametrize("name,opts", [
    ("aa_mif0", {}),
    ("aa_bitmask_merge", {"transfer": "bitmask", "merge_branches": True}),
])
def test_port_matches_jax_build_amino(aa_project, monkeypatch, name, opts):
    from ipk_tpu import serialize
    jax_out, torch_out = build_pair(aa_project, name, monkeypatch, **opts)
    assert payload(torch_out) == payload(jax_out)
    assert serialize.load(torch_out).size() > 0


@pytest.mark.parametrize("name,opts", [
    ("sparse_mif0", {}),
    ("sparse_random", {"filter": "random"}),
    ("sparse_merge", {"merge_branches": True}),
])
def test_port_matches_jax_build_sparse(dna_project, monkeypatch, name, opts):
    jax_out, torch_out = build_pair(dna_project, name, monkeypatch,
                                    sparse=True, **opts)
    assert payload(torch_out) == payload(jax_out)


def test_port_matches_jax_build_sparse_amino(aa_project, monkeypatch):
    from ipk_tpu import serialize
    jax_out, torch_out = build_pair(aa_project, "aa_sparse", monkeypatch,
                                    sparse=True)
    assert payload(torch_out) == payload(jax_out)
    assert serialize.load(torch_out).size() > 0


def test_sparse_equals_dense_build(dna_project, monkeypatch):
    """The port's forced-sparse build is byte-identical to its dense build
    (tests/test_builder_modes.py's check of ipk_tpu's two paths)."""
    tmp, states, k, omega, tree_file, fasta_file, ar_dir = dna_project
    outs = []
    for name, limit in (("dense_ref", torch_builder.MAX_DENSE_KEYSPACE),
                        ("sparse_run", 1)):
        monkeypatch.setattr(torch_builder, "MAX_DENSE_KEYSPACE", limit)
        out = str(tmp / f"{name}_port.ipk")
        build_database(BuildParams(
            refalign=fasta_file, reftree=tree_file, states=states,
            working_dir=str(tmp / f"wd_{name}_port"), ar_dir=ar_dir,
            kmer_size=k, omega=omega, output_filename=out, verbosity=0,
            device="cpu"))
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]


def test_port_routes_k12_to_sparse(k12_project, monkeypatch):
    """DNA k=12 (σ^k = 2^24) takes the sparse path by keyspace alone and is
    payload-equal to ipk_tpu's build."""
    from ipk_tpu import serialize

    def no_dense(*args, **kwargs):
        raise AssertionError("the dense path ran at k=12")

    monkeypatch.setattr(torch_builder, "_enumerate_batches", no_dense)
    jax_out, torch_out = build_pair(k12_project, "k12", monkeypatch)
    assert payload(torch_out) == payload(jax_out)
    assert serialize.load(torch_out).size() > 0


def test_sparse_capacity_raises(dna_project, monkeypatch):
    tmp, states, k, omega, tree_file, fasta_file, ar_dir = dna_project
    monkeypatch.setattr(torch_builder, "MAX_DENSE_KEYSPACE", 1)
    with pytest.raises(RuntimeError, match="capacity 8 exceeded"):
        build_database(BuildParams(
            refalign=fasta_file, reftree=tree_file, states=states,
            working_dir=str(tmp / "wd_ovf_port"), ar_dir=ar_dir, kmer_size=5,
            omega=0.01, max_candidates=8,
            output_filename=str(tmp / "ovf_port.ipk"), verbosity=0,
            device="cpu"))


def test_sparse_rejects_keep_positions(tmp_path):
    tree_file, fasta_file, ar_dir = make_project(tmp_path, num_leaves=4,
                                                 width=20, seed=8)
    with pytest.raises(RuntimeError, match="sparse"):
        build_database(BuildParams(
            refalign=fasta_file, reftree=tree_file,
            working_dir=str(tmp_path / "wd"), ar_dir=ar_dir, kmer_size=12,
            keep_positions=True, output_filename=str(tmp_path / "x.ipk"),
            verbosity=0, device="cpu"))


def test_cli_build_diff_dump(tmp_path):
    tree_file, fasta_file, ar_dir = make_project(tmp_path, num_leaves=5,
                                                 width=20, seed=3)
    env = subprocess_env()

    def cli(*args):
        return subprocess.run([sys.executable, "-m", "ipk_tpu_torch", *args],
                              cwd=str(tmp_path), env=env, capture_output=True,
                              text=True, timeout=300)

    outs = []
    for omega in ("1.5", "2.0"):
        out = str(tmp_path / f"DB_{omega}.ipk")
        r = cli("build", "-r", fasta_file, "-t", tree_file,
                "-w", str(tmp_path / f"wd_{omega}"), "-k", "4",
                "--omega", omega, "--ar-dir", ar_dir, "-o", out, "-v", "0",
                "-m", "GTR", "--device", "cpu")
        assert r.returncode == 0, r.stderr
        outs.append(out)
    r = cli("diff", outs[0], outs[0])
    assert r.returncode == 0 and "DIFF" not in r.stdout
    r = cli("diff", outs[0], outs[1])
    assert r.returncode == 1 and "DIFF" in r.stdout
    r = cli("dump", outs[0])
    assert r.returncode == 0
    lines = r.stdout.splitlines()
    assert len(lines) > 2 and set(lines[0]) <= set("ACGT")
    assert lines[1].startswith("\t")
    # the option surface rejects what ipk_tpu's does
    r = cli("build", "-r", fasta_file, "-t", tree_file, "-w",
            str(tmp_path / "bad"), "-m", "NOTAMODEL", "--device", "cpu")
    assert r.returncode != 0


@pytest.mark.parametrize("what", ["keep_positions", "on_disk", "ar_native",
                                  "profile"])
def test_unported_modes_raise(tmp_path, what):
    tree_file, fasta_file, ar_dir = make_project(tmp_path, num_leaves=4,
                                                 width=20, seed=8)
    params = BuildParams(refalign=fasta_file, reftree=tree_file,
                         working_dir=str(tmp_path / "wd"), ar_dir=ar_dir,
                         kmer_size=5, output_filename=str(tmp_path / "x.ipk"),
                         verbosity=0, device="cpu")
    if what == "keep_positions":
        params.keep_positions = True
    elif what == "on_disk":
        params.on_disk = True
    elif what == "ar_native":
        params.ar_dir, params.ar_binary = "", "native"
    else:
        params.profile_dir = str(tmp_path / "trace")
    with pytest.raises(NotImplementedError, match="ROADMAP.md item"):
        build_database(params)


def test_cli_multi_host_raises(tmp_path):
    from ipk_tpu_torch.cli import main
    tree_file, fasta_file, ar_dir = make_project(tmp_path, num_leaves=4,
                                                 width=12, seed=8)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 8"):
        main(["build", "-r", fasta_file, "-t", tree_file, "-w",
              str(tmp_path / "wd"), "--ar-dir", ar_dir, "-m", "GTR",
              "--num-hosts", "2", "--device", "cpu"])


def test_cuda_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from ipk_tpu_torch import device
    with pytest.raises(RuntimeError, match="is_available"):
        device.resolve("cuda")


def test_port_runs_without_jax_or_click(tmp_path):
    """The port's CLI and pipeline import, and build on the dense (k=4) and
    the sparse (k=12) path, with neither jax nor click loaded."""
    tree_file, fasta_file, ar_dir = make_project(tmp_path, num_leaves=4,
                                                 width=20, seed=4)
    script = (
        "import sys\n"
        "import ipk_tpu_torch.cli, ipk_tpu_torch.pipeline as pl\n"
        "for k, omega in ((4, 1.5), (12, 2.0)):\n"
        f"    r = pl.build_database(pl.BuildParams(refalign={fasta_file!r}, "
        f"reftree={tree_file!r}, working_dir={str(tmp_path / 'wd')!r}, "
        f"ar_dir={ar_dir!r}, kmer_size=k, omega=omega, "
        f"output_filename={str(tmp_path / 'DB.ipk')!r}, verbosity=0, "
        "device='cpu'))\n"
        "    assert r.db.size() > 0, k\n"
        "assert r.stats['final_caps'], 'k=12 did not take the sparse path'\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'click' not in sys.modules, 'click imported'\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                       env=subprocess_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")
