"""ipk_tpu_torch's own host modules against the ipk_tpu modules they copy.

The port imports nothing of ipk_tpu: seq, tree, alignment, db, serialize,
tools, utils/*, core/filter, ar/{mapping,reader,bridge} and the host half of
placement are its own copies. Each copy is held to its original on the same
seeded inputs, and the two packages' objects meet only through files,
strings and numpy arrays. Tolerance: none; every comparison is exact (bytes,
strings, array bits).
"""

import ast
import glob
import io
import os
import pathlib

import numpy as np
import pytest

import ipk_tpu.alignment as jalignment
import ipk_tpu.ar.bridge as jbridge
import ipk_tpu.ar.mapping as jmapping
import ipk_tpu.ar.reader as jreader
import ipk_tpu.core.filter as jfilter
import ipk_tpu.db as jdb
import ipk_tpu.placement as jplacement
import ipk_tpu.seq as jseq
import ipk_tpu.serialize as jserialize
import ipk_tpu.tools as jtools
import ipk_tpu.tree as jtree
import ipk_tpu.utils.threads as jthreads
import ipk_tpu_torch.alignment as talignment
import ipk_tpu_torch.ar.bridge as tbridge
import ipk_tpu_torch.ar.mapping as tmapping
import ipk_tpu_torch.ar.reader as treader
import ipk_tpu_torch.core.filter as tfilter
import ipk_tpu_torch.db as tdb
import ipk_tpu_torch.placement as tplacement
import ipk_tpu_torch.seq as tseq
import ipk_tpu_torch.serialize as tserialize
import ipk_tpu_torch.tools as ttools
import ipk_tpu_torch.tree as ttree
import ipk_tpu_torch.utils.threads as tthreads

import chip_smoke
import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "ipk_tpu_torch", "**", "*.py"),
              recursive=True)) + ["chip_smoke.py", "kernel_ab.py"]


def _imported_modules(path):
    """Every absolute module name a file imports, at any depth of its AST
    (imports inside functions included)."""
    tree = ast.parse(open(os.path.join(REPO, path)).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            for alias in node.names:
                yield f"{node.module}.{alias.name}"


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_no_ipk_tpu_and_no_fixtures(path):
    bad = [m for m in _imported_modules(path)
           if m == "ipk_tpu" or m.startswith("ipk_tpu.")
           or m.split(".")[0] in ("fixtures", "tests", "conftest")]
    assert not bad, f"{path} imports {bad}"


# ---------------------------------------------------------------------------
# the copied modules on the same seeded inputs
# ---------------------------------------------------------------------------

def _db_pair(seed, positions):
    """The same random database as each package's PhyloKmerDB."""
    rng = np.random.default_rng(seed)
    n = 50
    keys = np.sort(rng.choice(4 ** 5, n, replace=False)).astype(np.uint64)
    counts = rng.integers(1, 4, n)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    m = int(offsets[-1])
    fv = rng.normal(size=n).astype(np.float32)
    branches = np.concatenate([rng.choice(9, c, replace=False)
                               for c in counts]).astype(np.uint32)
    scores = -rng.random(m).astype(np.float32)
    pos = rng.integers(0, 20, m).astype(np.uint32) if positions else None
    newick = fixtures.random_tree_newick(rng, 5)
    tree = jtree.parse_newick(newick)
    index = [(0, 1.0)] * 3
    out = []
    for mod in (jdb, tdb):
        db = mod.PhyloKmerDB(5, 1.5, "nucl", jtree.to_newick(tree), index)
        db.set_data(keys, fv, offsets, branches, scores, pos)
        out.append(db)
    return out


def _arrays(db):
    arrays = [db.keys, db.filter_values, db.offsets, db.branches, db.scores]
    if db.positions is not None:
        arrays.append(db.positions)
    return [np.asarray(a).tobytes() for a in arrays]


def case_ipk_bytes(tmp):
    for positions in (False, True):
        jd, td = _db_pair(3, positions)
        for compressed in (True, False):
            j_path = str(tmp / f"j_{positions}_{compressed}.ipk")
            t_path = str(tmp / f"t_{positions}_{compressed}.ipk")
            jserialize.save(jd, j_path, compressed=compressed)
            tserialize.save(td, t_path, compressed=compressed)
            assert open(j_path, "rb").read() == open(t_path, "rb").read()
            # each package reads the other's file
            assert _arrays(tserialize.load(j_path)) == _arrays(jd)
            assert _arrays(jserialize.load(t_path)) == _arrays(td)
            assert tserialize.load(j_path).tree == jd.tree
            if not compressed:
                # the port's mapped and streamed readers take both files
                for path in (j_path, t_path):
                    mapped = tserialize.load(path, mmap=True)
                    assert _arrays(mapped) == _arrays(td)
                    assert _streamed(path) == _arrays(td)


def _streamed(path):
    """_arrays of an uncompressed file read through one port BatchLoader
    block that covers the whole file."""
    loader = tserialize.BatchLoader(path)
    try:
        keys, fvs, counts, branches, scores, pos = loader.read_block(
            loader.get_num_kmers())
        assert loader.rows_left() == 0 and loader.read_block() is None
    finally:
        loader.close()
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    arrays = [keys, fvs, offsets, branches, scores]
    if pos is not None:
        arrays.append(pos)
    return [np.asarray(a).tobytes() for a in arrays]


def case_newick(tmp):
    rng = np.random.default_rng(5)
    for n in (4, 9, 17):
        newick = fixtures.random_tree_newick(rng, n)
        jt, tt = jtree.parse_newick(newick), ttree.parse_newick(newick)
        assert ttree.to_newick(tt) == jtree.to_newick(jt)
        assert ([(x.label, x.postorder_id) for x in ttree.postorder(tt.root)]
                == [(x.label, x.postorder_id)
                    for x in jtree.postorder(jt.root)])
        (je, jm), (te, tm) = jtree.extend_tree(jt), ttree.extend_tree(tt)
        assert ttree.to_newick(te) == jtree.to_newick(je) and tm == jm


def case_alignment(tmp):
    rng = np.random.default_rng(7)
    newick = fixtures.random_tree_newick(rng, 6)
    leaves = [x.label for x in jtree.postorder(jtree.parse_newick(newick).root)
              if x.is_leaf()]
    fasta = str(tmp / "gappy.fasta")
    jalignment.save_alignment(
        fixtures.random_alignment(rng, leaves, 40, gap_prob=0.3), fasta)
    ja, ta = jalignment.load_alignment(fasta), talignment.load_alignment(fasta)
    assert (ta.headers, ta.sequences) == (ja.headers, ja.sequences)
    np.testing.assert_array_equal(talignment.calculate_gap_ratio(ta),
                                  jalignment.calculate_gap_ratio(ja))
    jr = jalignment.reduce_alignment(ja, 0.2)
    tr = talignment.reduce_alignment(ta, 0.2)
    assert (tr.headers, tr.sequences) == (jr.headers, jr.sequences)
    je, _ = jtree.extend_tree(jtree.parse_newick(newick))
    te, _ = ttree.extend_tree(ttree.parse_newick(newick))
    jx, tx = (jalignment.extend_alignment(ja, je),
              talignment.extend_alignment(ta, te))
    for fmt in ("fasta", "phylip"):
        jalignment.save_alignment(jx, str(tmp / f"j.{fmt}"), fmt)
        talignment.save_alignment(tx, str(tmp / f"t.{fmt}"), fmt)
        assert (open(tmp / f"j.{fmt}", "rb").read()
                == open(tmp / f"t.{fmt}", "rb").read())


def _ar_reader(tmp, monkeypatch, native):
    if not native:
        monkeypatch.setenv("IPK_TPU_NO_NATIVE", "1")
    for traits, seed in ((jseq.DNA, 11), (jseq.AA, 12)):
        sub = tmp / f"{traits.name}_{native}"
        sub.mkdir()
        tree_file, _, ar_dir = fixtures.make_project(
            sub, num_leaves=5, width=17, seed=seed, traits=traits)
        probs = os.path.join(ar_dir, "align.raxml.ancestralProbs")
        j_rows, j_P = jreader.read_ancestral_probs(probs, traits)
        t_rows, t_P = treader.read_ancestral_probs(
            probs, tseq.get_traits(traits.name))
        assert t_rows == j_rows
        assert t_P.dtype == j_P.dtype and t_P.tobytes() == j_P.tobytes()
    assert (treader._load_native() is None) == (not native)


def case_ar_reader_native(tmp, monkeypatch):
    _ar_reader(tmp, monkeypatch, True)


def case_ar_reader_python(tmp, monkeypatch):
    _ar_reader(tmp, monkeypatch, False)


def case_mapping(tmp):
    tree_file, _, ar_dir = fixtures.make_project(tmp, num_leaves=7, width=9,
                                                 seed=13)
    newick = open(tree_file).read()
    ar_newick = open(os.path.join(ar_dir, "align.raxml.ancestralTree")).read()
    out = []
    for tree_mod, mapping in ((jtree, jmapping), (ttree, tmapping)):
        original = tree_mod.parse_newick(newick)
        extended, ghost_mapping = tree_mod.extend_tree(original)
        ar_map = mapping.map_nodes(extended, tree_mod.parse_newick(ar_newick))
        groups, ids = mapping.ghost_groups(extended, original, ghost_mapping)
        rows = {label: n for n, label in enumerate(sorted(set(
            ar_map.values())))}
        P = np.arange(len(rows) * 3 * 4, dtype=np.float32).reshape(-1, 3, 4)
        out.append((ar_map, groups, ids,
                    mapping.gather_ghost_tensor(groups, ar_map, rows,
                                                P).tobytes()))
    assert out[0] == out[1]


def _mif0(monkeypatch, native):
    if not native:
        monkeypatch.setenv("IPK_TPU_NO_NATIVE", "1")
    rng = np.random.default_rng(17)
    num_keys = 300
    counts = rng.integers(1, 6, num_keys)
    key_index = np.repeat(np.arange(num_keys), counts)
    scores = np.log10(rng.random(len(key_index)) * 0.9 + 0.05).astype(
        np.float32)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    thr = jfilter.score_threshold(1.5, 4, 5)
    assert tfilter.score_threshold(1.5, 4, 5) == thr
    for kw in ({}, {"offsets": offsets}):
        j = jfilter.mif0_filter_values_entries(scores, key_index, num_keys,
                                               23, thr, **kw)
        t = tfilter.mif0_filter_values_entries(scores, key_index, num_keys,
                                               23, thr, **kw)
        assert t.tobytes() == j.tobytes()
    assert (tfilter._load_native() is None) == (not native)
    js, ts = jfilter.RandomFilterStream(), tfilter.RandomFilterStream()
    for n in (5, 1000, 3):
        assert ts.take(n).tobytes() == js.take(n).tobytes()


def case_mif0_native(tmp, monkeypatch):
    _mif0(monkeypatch, True)


def case_mif0_python(tmp, monkeypatch):
    _mif0(monkeypatch, False)


def case_dump_diff(tmp, capsys):
    a, b = str(tmp / "a.ipk"), str(tmp / "b.ipk")
    jd, _ = _db_pair(19, False)
    jserialize.save(jd, a)
    other, _ = _db_pair(19, False)
    other.set_data(other.keys, other.filter_values, other.offsets,
                   other.branches, other.scores + np.float32(0.01))
    jserialize.save(other, b)
    texts = []
    for tools in (jtools, ttools):
        buf = io.StringIO()
        tools.dump_database(a, buf)
        capsys.readouterr()
        results = (tools.diff_databases(a, a, verbose=True),
                   tools.diff_databases(a, b, verbose=True),
                   tools.diff_plain_text(a, b, eps=1e-3),
                   tools.diff_plain_text(a, b, eps=0.1))
        texts.append((buf.getvalue(), results, capsys.readouterr().out))
    assert texts[0] == texts[1]
    assert texts[0][1] == (True, False, False, True)


def case_placement(tmp):
    jd, td = _db_pair(23, False)
    rng = np.random.default_rng(29)
    queries = [(f"q{n}", "".join(rng.choice(list("ACGTN"), 30)))
               for n in range(12)]
    ji, ti = jplacement.PlacementIndex(jd), tplacement.PlacementIndex(td)
    for _, seq in queries:
        for a, b in zip(ti.score_query(seq), ji.score_query(seq)):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    j_pl = jplacement.place_queries(jd, queries, top=4, engine="host")
    t_pl = tplacement.place_queries(td, queries, top=4, engine="host")
    assert t_pl == j_pl
    jplacement.write_jplace(jd, j_pl, str(tmp / "j.jplace"))
    tplacement.write_jplace(td, t_pl, str(tmp / "t.jplace"))
    assert open(tmp / "t.jplace").read() == open(tmp / "j.jplace").read()


def case_seq_bridge_threads(tmp):
    rng = np.random.default_rng(31)
    for name in ("nucl", "amino"):
        jt, tt = jseq.get_traits(name), tseq.get_traits(name)
        assert (tt.name, tt.alphabet_size, tt.bits_per_symbol,
                tt.max_kmer_length, tt.letters) == (
            jt.name, jt.alphabet_size, jt.bits_per_symbol,
            jt.max_kmer_length, jt.letters)
        np.testing.assert_array_equal(tt.codes_lut(), jt.codes_lut())
        k = 4
        idx = rng.integers(0, jt.alphabet_size ** k, 64)
        keys = jseq.dense_index_to_key(idx, k, jt)
        np.testing.assert_array_equal(tseq.dense_index_to_key(idx, k, tt),
                                      keys)
        for key in keys[:8]:
            kmer = jseq.decode_kmer(int(key), k, jt)
            assert tseq.decode_kmer(int(key), k, tt) == kmer
            assert tseq.encode_kmer(kmer, tt) == jseq.encode_kmer(kmer, jt)
    assert (tbridge.NUCL_MODELS, tbridge.AMINO_MODELS) == (
        jbridge.NUCL_MODELS, jbridge.AMINO_MODELS)
    kw = dict(binary_file="raxml-ng", alignment_file="a.phy",
              tree_file="t.newick", ar_dir=str(tmp), model="GTR",
              categories=4, alpha=1.0, num_threads=3)
    argv = [mod.RaxmlWrapper(mod.ArParameters(**kw)).make_args()
            for mod in (jbridge, tbridge)]
    assert argv[0] == argv[1]
    for n in (None, 2, 7):
        jthreads.set_host_threads(n)
        tthreads.set_host_threads(n)
        assert tthreads.host_threads() == jthreads.host_threads()
    jthreads.set_host_threads(None)
    tthreads.set_host_threads(None)


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_copied_module_matches_original(case, tmp_path, monkeypatch,
                                        capsys):
    fn = CASES[case]
    args = {"tmp": tmp_path, "monkeypatch": monkeypatch, "capsys": capsys}
    fn(**{name: args[name] for name in fn.__code__.co_varnames[
        :fn.__code__.co_argcount]})


@pytest.mark.parametrize("seed,traits", [(3, "nucl"), (8, "amino")])
def test_smoke_make_project_writes_the_fixture_files(tmp_path, seed, traits):
    """chip_smoke.make_project (on ipk_tpu_torch's modules) writes the same
    files, byte for byte, as tests/fixtures.py:make_project."""
    kw = dict(num_leaves=9, width=31, seed=seed)
    a, b = tmp_path / "smoke", tmp_path / "fixtures"
    a.mkdir()
    b.mkdir()
    got = chip_smoke.make_project(a, traits=tseq.get_traits(traits), **kw)
    want = fixtures.make_project(b, traits=jseq.get_traits(traits), **kw)
    for x, y in zip(got, want):
        assert os.path.relpath(x, a) == os.path.relpath(y, b)
        paths = (sorted(pathlib.Path(x).iterdir()) if os.path.isdir(x)
                 else [pathlib.Path(x)])
        assert paths
        for path in paths:
            other = pathlib.Path(y) / path.name if os.path.isdir(y) else y
            assert path.read_bytes() == pathlib.Path(other).read_bytes()
