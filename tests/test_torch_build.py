"""The port's builds end to end on the CPU, against ipk_tpu: the dense and
sparse paths, --keep-positions, --on-disk, --device-mi on one device,
--profile, and the CLI's two-process build.

Tolerance: none. Databases are compared by their decompressed payload (every
header field, column byte and row order), as tests/test_golden.py does.
"""

import os
import socket
import subprocess
import sys
import zlib

import numpy as np
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


def build_pair(project, name, monkeypatch, key_batches=None, sparse=False,
               **overrides):
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
    ("kb2_random", {"key_batches": 2, "filter": "random"}),
    ("kb4_random", {"key_batches": 4, "filter": "random"}),
    ("kb4_merge", {"key_batches": 4, "merge_branches": True}),
    ("random_merge", {"filter": "random", "merge_branches": True}),
    ("inner_only", {"ghosts": "inner-only"}),
    ("outer_only", {"ghosts": "outer-only"}),
])
def test_port_matches_jax_build(dna_project, monkeypatch, name, opts):
    jax_out, torch_out = build_pair(dna_project, name, monkeypatch, **opts)
    assert payload(torch_out) == payload(jax_out)


@pytest.mark.parametrize("name,opts", [
    ("aa_mif0", {}),
    ("aa_merge", {"merge_branches": True}),
    ("aa_outer_only", {"ghosts": "outer-only"}),
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


def test_port_matches_jax_build_unrooted(tmp_path, monkeypatch):
    """--use-unrooted: an unrooted reference tree (a root trifurcation)
    builds payload-equal to ipk_tpu's build (tests/test_tree.py's
    preprocess check, through the whole build)."""
    from fixtures import make_ar_dir, random_alignment
    from ipk_tpu.alignment import save_alignment
    from ipk_tpu.tree import extend_tree, parse_newick
    newick = ("((L0:0.3,L1:0.2):0.1,L2:0.4,(L3:0.25,(L4:0.5,L5:0.15):0.2)"
              ":0.3);")
    tree_file = str(tmp_path / "tree.newick")
    with open(tree_file, "w") as f:
        f.write(newick + "\n")
    rng = np.random.default_rng(31)
    fasta_file = str(tmp_path / "reference.fasta")
    save_alignment(random_alignment(rng, [f"L{i}" for i in range(6)], 25,
                                    gap_prob=0.0), fasta_file, "fasta")
    ar_dir, _ = make_ar_dir(tmp_path, extend_tree(parse_newick(newick))[0],
                            25, seed=32)
    project = (tmp_path, "nucl", 5, 1.5, tree_file, fasta_file, ar_dir)
    jax_out, torch_out = build_pair(project, "unrooted", monkeypatch,
                                    use_unrooted=True)
    assert payload(torch_out) == payload(jax_out)
    from ipk_tpu import serialize
    assert serialize.load(torch_out).size() > 0


def test_port_matches_jax_build_convert_uo(aa_project, monkeypatch):
    """--convert-uo: an amino alignment holding U and O builds, with them
    read as C and L, payload-equal to ipk_tpu's build."""
    tmp, states, k, omega, tree_file, fasta_file, ar_dir = aa_project
    lines = open(fasta_file).read().splitlines()
    rng = np.random.default_rng(4)
    for i, line in enumerate(lines):
        if not line.startswith(">"):
            chars = list(line)
            for j in rng.choice(len(chars), 3, replace=False):
                chars[j] = "UO"[j % 2]
            lines[i] = "".join(chars)
    uo_fasta = str(tmp / "reference_uo.fasta")
    with open(uo_fasta, "w") as f:
        f.write("\n".join(lines) + "\n")
    project = (tmp, states, k, omega, tree_file, uo_fasta, ar_dir)
    jax_out, torch_out = build_pair(project, "convert_uo", monkeypatch,
                                    convert_uo=True)
    assert payload(torch_out) == payload(jax_out)


def test_port_matches_jax_build_write_reduction(dna_project, monkeypatch):
    """--write-reduction: the reduced alignment the port writes is
    byte-equal to ipk_tpu's, and so are the databases."""
    tmp, states, k, omega, tree_file, fasta_file, ar_dir = dna_project
    outs = []
    for tag, params_cls, run, extra in [
            ("jax", JaxParams, jax_build_database, {}),
            ("torch", BuildParams, build_database, {"device": "cpu"})]:
        out = str(tmp / f"reduction_{tag}.ipk")
        red = str(tmp / f"reduction_{tag}.fasta")
        run(params_cls(refalign=fasta_file, reftree=tree_file, states=states,
                       working_dir=str(tmp / f"wd_reduction_{tag}"),
                       ar_dir=ar_dir, kmer_size=k, omega=omega,
                       output_filename=out, write_reduction=red,
                       verbosity=0, **extra))
        outs.append((payload(out), open(red, "rb").read()))
    assert outs[0] == outs[1] and outs[0][1]


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
    """None of the modes the first port left out raises any more:
    --keep-positions, --on-disk and --ar native build a database, and
    --profile writes a torch.profiler Chrome trace of the build beside a
    database equal to the unprofiled build's."""
    tree_file, fasta_file, ar_dir = make_project(tmp_path, num_leaves=4,
                                                 width=20, seed=8)
    out = str(tmp_path / "x.ipk")
    params = BuildParams(refalign=fasta_file, reftree=tree_file,
                         working_dir=str(tmp_path / "wd"), ar_dir=ar_dir,
                         kmer_size=5, output_filename=out, verbosity=0,
                         device="cpu")
    if what == "profile":
        build_database(params)
        plain = payload(out)
        params.profile_dir = str(tmp_path / "trace")
        build_database(params)
        import json
        with open(tmp_path / "trace" / "trace.json") as f:
            events = json.load(f)["traceEvents"]
        assert any(str(e.get("name", "")).startswith("aten::")
                   for e in events)
        assert payload(out) == plain
        return
    if what == "keep_positions":
        params.keep_positions = True
    elif what == "on_disk":
        params.on_disk = True
    else:
        params.ar_dir, params.ar_binary = "", "native"
    build_database(params)
    from ipk_tpu import serialize
    db = serialize.load(out)
    assert db.size() > 0
    assert (db.positions is not None) == (what == "keep_positions")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_multi_host_raises(tmp_path):
    """--num-hosts 2 no longer raises: tests/test_multihost.py through the
    port's CLI on the CPU, where two ranks joined by --coordinator,
    --num-hosts and --host-id (gloo) each write a file byte-equal to the
    one-process build's."""
    tree_file, fasta_file, ar_dir = make_project(tmp_path, num_leaves=12,
                                                 width=80, seed=5)

    def argv(tag, extra=()):
        out = tmp_path / f"DB_{tag}.ipk"
        return [sys.executable, "-m", "ipk_tpu_torch", "build",
                "-r", fasta_file, "-t", tree_file, "-m", "GTR",
                "--ar-dir", ar_dir, "-k", "6",
                "-w", str(tmp_path / f"wd_{tag}"), "-o", str(out), "-v", "0", "--device", "cpu", *extra], out

    dist = ["--coordinator", f"127.0.0.1:{free_port()}", "--num-hosts", "2"]
    runs = [argv("single")] + [argv(f"h{r}", dist + ["--host-id", str(r)])
                               for r in range(2)]
    procs = [subprocess.Popen(args, env=subprocess_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for args, _ in runs]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err.decode()[-3000:]
    single = runs[0][1].read_bytes()
    assert single and all(out.read_bytes() == single for _, out in runs[1:])


def test_cli_multi_host_needs_rank_and_coordinator(tmp_path):
    """--num-hosts above 1 without a rank or a coordinator raises before any
    rendezvous."""
    from ipk_tpu_torch.cli import main
    tree_file, fasta_file, ar_dir = make_project(tmp_path, num_leaves=4,
                                                 width=12, seed=8)
    base = ["build", "-r", fasta_file, "-t", tree_file, "-w",
            str(tmp_path / "wd"), "--ar-dir", ar_dir, "-m", "GTR",
            "--num-hosts", "2", "--device", "cpu"]
    with pytest.raises(ValueError, match="process_id"):
        main(base + ["--coordinator", "127.0.0.1:1"])
    with pytest.raises(ValueError, match="coordinator"):
        main(base + ["--host-id", "1"])


def test_cuda_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from ipk_tpu_torch import device
    with pytest.raises(RuntimeError, match="is_available"):
        device.resolve("cuda")


def test_port_runs_without_jax_or_click(tmp_path):
    """The port's CLI, pipeline, placement and native AR import, and build
    on the dense (k=4) and the sparse (k=12) path, with positions, on disk
    and from the native AR with its ML fit, then place (host and device
    engines, jplace), diff and dump, with neither jax nor click (nor optax)
    loaded and ipk_tpu blocked from import."""
    tree_file, fasta_file, ar_dir = make_project(tmp_path, num_leaves=4,
                                                 width=20, seed=4)
    script = (
        "import io, sys\n"
        "sys.modules['ipk_tpu'] = None\n"
        "import ipk_tpu_torch.cli, ipk_tpu_torch.pipeline as pl\n"
        "import ipk_tpu_torch.placement as place\n"
        "import ipk_tpu_torch.ar.native, ipk_tpu_torch.ar.optimize\n"
        "from ipk_tpu_torch import serialize, tools\n"
        "from ipk_tpu_torch.alignment import read_fasta\n"
        "runs = [dict(kmer_size=4, omega=1.5), dict(kmer_size=12, omega=2.0),"
        " dict(kmer_size=4, omega=1.5, keep_positions=True),"
        " dict(kmer_size=12, omega=2.0, on_disk=True),"
        " dict(kmer_size=4, omega=1.5, ar_dir='', ar_binary='native',"
        " ar_optimize=True, ar_opt_steps=2)]\n"
        "for n, kw in enumerate(runs):\n"
        f"    kw = {{'ar_dir': {ar_dir!r}, **kw}}\n"
        f"    out = {str(tmp_path)!r} + f'/DB{{n}}.ipk'\n"
        f"    r = pl.build_database(pl.BuildParams(refalign={fasta_file!r}, "
        f"reftree={tree_file!r}, working_dir={str(tmp_path)!r} + f'/wd{{n}}', "
        "output_filename=out, verbosity=0, device='cpu', **kw))\n"
        "    assert serialize.load(out).size() > 0, kw\n"
        "    if n == 1:\n"
        "        assert r.stats['final_caps'], 'k=12 took the dense path'\n"
        f"db0 = {str(tmp_path)!r} + '/DB0.ipk'\n"
        "db = serialize.load(db0)\n"
        f"queries = list(read_fasta({fasta_file!r}))\n"
        "for engine in ('host', 'device'):\n"
        "    placed = place.place_queries(db, queries, top=3, engine=engine,"
        " device='cpu')\n"
        "    assert [p['n'] for p in placed] == [[q[0]] for q in queries]\n"
        f"place.write_jplace(db, placed, {str(tmp_path)!r} + '/q.jplace')\n"
        "assert tools.diff_databases(db0, db0, verbose=False)\n"
        "buf = io.StringIO()\n"
        "tools.dump_database(db0, buf)\n"
        "assert buf.getvalue()\n"
        "for mod in ('jax', 'click', 'optax'):\n"
        "    assert mod not in sys.modules, mod + ' imported'\n"
        "assert not [m for m in sys.modules if m.startswith('ipk_tpu.')]\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                       env=subprocess_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


# ---------------------------------------------------------------------------
# --keep-positions, --on-disk, --device-mi on one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,opts", [
    ("pos", {}),
    ("pos_merge", {"merge_branches": True}),
    ("pos_kb1", {"key_batches": 1}),
    ("pos_kb2", {"key_batches": 2}),
])
def test_port_matches_jax_build_positions(dna_project, monkeypatch, name,
                                          opts):
    from ipk_tpu import serialize
    jax_out, torch_out = build_pair(dna_project, name, monkeypatch,
                                    keep_positions=True, **opts)
    assert payload(torch_out) == payload(jax_out)
    db = serialize.load(torch_out)
    assert db.positions is not None and db.size() > 0


@pytest.mark.parametrize("name,opts", [
    ("aa_pos", {}),
    ("aa_pos_merge", {"merge_branches": True}),
])
def test_port_matches_jax_build_positions_amino(aa_project, monkeypatch,
                                                name, opts):
    """The amino setup of test_builder_modes.py's positions test (5 taxa x
    15 sites, k=3, omega 4.0): positions are window starts in [0, S - k]."""
    from ipk_tpu import serialize
    jax_out, torch_out = build_pair(aa_project, name, monkeypatch,
                                    keep_positions=True, **opts)
    assert payload(torch_out) == payload(jax_out)
    db = serialize.load(torch_out)
    assert db.size() > 0 and db.positions.max() <= 15 - 3


def test_positions_earliest_window_tiebreak():
    """A constant matrix ties every window: each position is window 0
    (tests/test_builder_modes.py's check, through the port's stage 1)."""
    from ipk_tpu_torch.core.dense import best_score_prefix
    P = np.full((2, 10, 4), np.log10(0.25), dtype=np.float32)
    batches = list(torch_builder._enumerate_batches(
        P, best_score_prefix(P), k=2, sigma=4,
        eps=torch_builder.log_threshold_f32(0.9, 4, 2), ghosts_per_group=2,
        key_batches=1, device=torch.device("cpu"),
        keep_positions=True))
    tag, lo, A, pos, count = batches[0]
    assert tag == "dense" and pos.dtype == np.int32
    assert np.isfinite(A).any() and (pos == 0).all()


@pytest.mark.parametrize("name,opts", [
    ("disk_kb1", {"key_batches": 1}),
    ("disk_kb2", {"key_batches": 2}),
    ("disk_kb4", {"key_batches": 4}),
    ("disk_sparse", {"sparse": True}),
    ("disk_raw", {"uncompressed": True}),
])
def test_port_matches_jax_build_on_disk(dna_project, monkeypatch, name,
                                        opts):
    """--on-disk: payload-equal to ipk_tpu's on-disk build (uncompressed,
    byte-equal) and byte-equal to the port's in-RAM build (its sections
    compressed as ``save`` compresses columns); the temporary hashmaps/
    directory is gone; the returned database holds no arrays."""
    tmp, states, k, omega, tree_file, fasta_file, ar_dir = dna_project
    jax_out, torch_out = build_pair(dna_project, name, monkeypatch,
                                    on_disk=True, **opts)
    assert payload(torch_out) == payload(jax_out)
    ram_out = str(tmp / f"{name}_ram.ipk")
    build_database(BuildParams(
        refalign=fasta_file, reftree=tree_file, states=states,
        working_dir=str(tmp / f"wd_{name}_ram"), ar_dir=ar_dir, kmer_size=k,
        omega=omega, output_filename=ram_out, verbosity=0, device="cpu",
        uncompressed=opts.get("uncompressed", False)))
    assert payload(torch_out) == payload(ram_out)
    with open(torch_out, "rb") as f, open(ram_out, "rb") as g:
        assert f.read() == g.read()
    assert not os.path.exists(str(tmp / f"wd_{name}_torch" / "hashmaps"))
    result = build_database(BuildParams(
        refalign=fasta_file, reftree=tree_file, states=states,
        working_dir=str(tmp / f"wd_{name}_again"), ar_dir=ar_dir,
        kmer_size=k, omega=omega, output_filename=str(tmp / "again.ipk"),
        on_disk=True, verbosity=0, device="cpu"))
    assert result.db.size() == 0 and "sort" not in result.timings
    assert {"computation", "filter_merge", "host_extract"} <= set(
        result.timings)


def test_merge_on_disk_orders_by_stored_filter_value(tmp_path):
    """The on-disk merge orders rows by the float32 filter values it reads
    back, then by key, exactly as ipk_tpu's does: where two batches hold
    keys whose float64 values differ but round to one float32, the merged
    order is not the in-RAM (float64) order. Byte-equal to ipk_tpu's."""
    from ipk_tpu import serialize
    from ipk_tpu.db import PhyloKmerDB
    from ipk_tpu_torch.db import PhyloKmerDB as TorchPhyloKmerDB
    from ipk_tpu_torch.host import _merge_on_disk
    base = np.float32(0.25)
    step = np.float64(np.spacing(base)) / 8     # below float32 resolution
    batches = [  # (keys, float64 filter values), each sorted by (fv, key)
        (np.array([9, 3, 12], np.uint64),
         np.array([0.1, base + step, base + 3 * step])),
        (np.array([7, 1, 5], np.uint64),
         np.array([0.05, base + 2 * step, 0.5])),
    ]
    files = []
    for n, (keys, fv) in enumerate(batches):
        db = PhyloKmerDB(2, 1.5, "nucl", "", [])
        offsets = np.arange(len(keys) + 1, dtype=np.int64)
        db.set_data(keys, fv.astype(np.float32), offsets,
                    np.full(len(keys), n, np.uint32),
                    np.full(len(keys), -0.5, np.float32))
        files.append(str(tmp_path / f"{n}.ipk"))
        serialize.save(db, files[-1], compressed=False)
    outs = []
    for name, merge, db_cls in (
            ("torch", _merge_on_disk, TorchPhyloKmerDB),
            ("jax", jax_builder._merge_on_disk, PhyloKmerDB)):
        outs.append(str(tmp_path / f"merged_{name}.ipk"))
        merge(db_cls(2, 1.5, "nucl", "(a,b)r;", []), files, outs[-1],
              uncompressed=False, block_rows=2)
    assert payload(outs[0]) == payload(outs[1])
    merged = serialize.load(outs[0])
    # in-RAM (float64) order would be 7, 9, 3, 1, 12, 5
    assert merged.keys.tolist() == [7, 9, 1, 3, 12, 5]


def test_write_sections_holds_few_chunks(tmp_path, monkeypatch):
    """The .ipk writer reads its section files a chunk at a time as its
    pool takes them: on 24 MiB of sections, 1 MiB chunks and one thread,
    the allocations it holds at once stay under 8 MiB, and the file
    decompresses to the header and the sections in the table's order."""
    import tracemalloc
    from ipk_tpu_torch import serialize
    monkeypatch.setenv("IPK_TPU_ZLIB_THREADS", "1")
    rng = np.random.default_rng(5)
    header = serialize._MAGIC + b"header fields"
    sections = {
        "keys": np.arange(1 << 20, dtype="<u8").tobytes(),
        "scores": rng.uniform(-3.4, 0, 1 << 22).astype("<f4").tobytes(),
        "branches": rng.integers(0, 510, 1 << 20, dtype="<u4").tobytes()}
    files = {}
    for name, data in sections.items():
        files[name] = str(tmp_path / f"{name}.bin")
        with open(files[name], "wb") as f:
            f.write(data)
    expected = header + b"".join(sections[name]
                                 for name, _, _ in serialize.COLUMNS
                                 if name in sections)
    del sections
    out = str(tmp_path / "DB.ipk")
    tracemalloc.start()
    try:
        serialize.write_ipk(out, header, files, chunk_bytes=1 << 20)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert len(expected) > 24 << 20 and peak < 8 << 20, peak
    with open(out, "rb") as f:
        assert zlib.decompress(f.read()) == expected


def test_in_ram_and_on_disk_files_are_byte_identical_past_32_mib(tmp_path):
    """Past 32 MiB a column the compressed save of a database and the
    on-disk merge of the same rows write one file, byte for byte, whose
    payload is ipk_tpu's: 2^20 keys of 9 entries each (the branches and
    scores sections 36 MiB each), merged from two key-disjoint parts."""
    from ipk_tpu import serialize as jserialize
    from ipk_tpu.db import PhyloKmerDB as JaxPhyloKmerDB
    from ipk_tpu_torch import serialize
    from ipk_tpu_torch.db import PhyloKmerDB
    from ipk_tpu_torch.host import _merge_on_disk
    rng = np.random.default_rng(17)
    n, per = 1 << 20, 9
    keys = rng.permutation(n).astype(np.uint64)
    fv = (rng.integers(0, 4096, n) / 4096).astype(np.float32)
    order = np.lexsort((keys, fv))          # (fv, key), ties in fv
    keys, fv = keys[order], fv[order]
    offsets = np.arange(n + 1, dtype=np.int64) * per
    branches = rng.integers(0, 510, n * per, dtype=np.uint32)
    scores = -rng.random(n * per, dtype=np.float32)
    head = (10, 1.5, "nucl", "(a,b)r;", [(1, 0.5), (1, 0.25), (3, 0.0)])
    db = PhyloKmerDB(*head)
    db.set_data(keys, fv, offsets, branches, scores)
    ram = str(tmp_path / "ram.ipk")
    serialize.save(db, ram)
    os.makedirs(tmp_path / "parts")
    parts = []
    for half in (0, 1):
        rows = (keys & np.uint64(1)) == half
        part = PhyloKmerDB(*head)
        part.set_data(keys[rows], fv[rows],
                      np.arange(rows.sum() + 1, dtype=np.int64) * per,
                      branches[np.repeat(rows, per)],
                      scores[np.repeat(rows, per)])
        parts.append(str(tmp_path / "parts" / f"{half}.ipk"))
        serialize.save(part, parts[-1], compressed=False)
    disk = str(tmp_path / "disk.ipk")
    _merge_on_disk(PhyloKmerDB(*head), parts, disk, uncompressed=False)
    with open(ram, "rb") as f, open(disk, "rb") as g:
        assert f.read() == g.read()
    jdb = JaxPhyloKmerDB(*head)
    jdb.set_data(keys, fv, offsets, branches, scores)
    jax_out = str(tmp_path / "jax.ipk")
    jserialize.save(jdb, jax_out)
    assert payload(ram) == payload(jax_out)


@pytest.mark.parametrize("to_null", [True, False])
def test_on_disk_build_writes_only_under_its_working_dir(
        dna_project, monkeypatch, tmp_path, to_null):
    """An --on-disk build spills its parts and the merge's column sections
    under <working_dir>/hashmaps/, never beside the output: a build whose
    output is the null device completes, every directory it makes lies
    under the working directory, the output's directory gains nothing but
    the output, and hashmaps/ is gone after."""
    tmp, states, k, omega, tree_file, fasta_file, ar_dir = dna_project
    wd = tmp_path / "wd"
    out = os.devnull if to_null else str(tmp_path / "out" / "DB.ipk")
    out_dir = os.path.dirname(out)
    os.makedirs(out_dir, exist_ok=True)
    before = set(os.listdir(out_dir))
    made = []
    real_makedirs = os.makedirs

    def makedirs(name, *a, **kw):
        made.append(os.path.abspath(name))
        return real_makedirs(name, *a, **kw)

    monkeypatch.setattr(os, "makedirs", makedirs)
    result = build_database(BuildParams(
        refalign=fasta_file, reftree=tree_file, states=states,
        working_dir=str(wd), ar_dir=ar_dir, kmer_size=k, omega=omega,
        output_filename=out, on_disk=True, verbosity=0, device="cpu"))
    monkeypatch.undo()
    assert result.timings["merge_rows"] > 0
    assert any(m.startswith(str(wd / "hashmaps")) for m in made)
    assert all(m.startswith(str(wd)) for m in made), made
    gained = set(os.listdir(out_dir)) - before
    assert gained == (set() if to_null else {"DB.ipk"}), gained
    assert not os.path.exists(out + ".merge")
    assert not os.path.exists(wd / "hashmaps")


def test_on_disk_rejects_positions(aa_project):
    tmp, states, k, omega, tree_file, fasta_file, ar_dir = aa_project
    with pytest.raises(RuntimeError, match="Positions are not supported"):
        build_database(BuildParams(
            refalign=fasta_file, reftree=tree_file, states=states,
            working_dir=str(tmp / "wd_disk_pos"), ar_dir=ar_dir,
            kmer_size=k, omega=omega, output_filename=str(tmp / "x.ipk"),
            keep_positions=True, on_disk=True, verbosity=0, device="cpu"))


def test_device_mi_one_device_notes_and_falls_back(dna_project, capsys):
    """--device-mi on one device: ipk_tpu's note, then the host f64 filter,
    so the database equals the plain build's."""
    tmp, states, k, omega, tree_file, fasta_file, ar_dir = dna_project
    outs = []
    for name, device_mi in (("mi_off", False), ("mi_on", True)):
        out = str(tmp / f"{name}.ipk")
        build_database(BuildParams(
            refalign=fasta_file, reftree=tree_file, states=states,
            working_dir=str(tmp / f"wd_{name}"), ar_dir=ar_dir, kmer_size=k,
            omega=omega, output_filename=out, device_mi=device_mi,
            verbosity=1, device="cpu"))
        outs.append(payload(out))
    assert outs[0] == outs[1]
    assert "falling back to the host f64 filter" in capsys.readouterr().out


@pytest.mark.parametrize("ar_binary", ["", "native"])
def test_ar_optimize_replays_ar_dir(dna_project, ar_binary):
    """--ar-optimize acts on the native route only: with --ar-dir the AR is
    replayed, whatever --ar says, as in ipk_tpu/pipeline.py."""
    tmp, states, k, omega, tree_file, fasta_file, ar_dir = dna_project
    outs = []
    for name, optimize in ((f"replay_{ar_binary}", False),
                           (f"replay_opt_{ar_binary}", True)):
        out = str(tmp / f"{name}.ipk")
        build_database(BuildParams(
            refalign=fasta_file, reftree=tree_file, states=states,
            working_dir=str(tmp / f"wd_{name}"), ar_dir=ar_dir,
            ar_binary=ar_binary, ar_optimize=optimize, kmer_size=k,
            omega=omega, output_filename=out, verbosity=0, device="cpu"))
        outs.append(payload(out))
    assert outs[0] == outs[1]


def test_choose_key_batches_positions_skip_split():
    """ipk_tpu splits big accumulators 4/2 ways for overlap, but not for
    --keep-positions builds (ipk_tpu/builder.py:774)."""
    from ipk_tpu_torch.host import pick_key_batches
    n_groups, nl, nr = 510, 256, 256
    assert pick_key_batches(n_groups, nl, nr) == 1
    assert torch_builder.choose_key_batches(n_groups, nl, nr) == 4
    assert torch_builder.choose_key_batches(n_groups, nl, nr,
                                            keep_positions=True) == 1
