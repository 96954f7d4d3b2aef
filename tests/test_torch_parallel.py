"""The port's multi-rank layer (ipk_tpu_torch/parallel/) on gloo ranks on
the CPU, against ipk_tpu's parallel/ over conftest's 8 virtual devices and
against numpy host references: the sharded build step at 1, 2 and 4 ranks
and on the 2x2 branch x key mesh, the key-batched step, padding, the key
merge (groups of 1 and 2 ghosts, 2 and 4 ranks, duplicates, overflow, the
AA code space, ±0.0 ties), the sharded sparse enumeration, and the check
that refuses two NCCL ranks on one GPU.

The ranks of each world size run all their jobs in one start (module
fixture ``worlds``); every rank's outputs are checked.

Tolerances: none for A, counts, merged streams and survivor lists. The f32
filter values of the collective mif0 within rtol 2e-4 / atol 1e-6 of the
host f64 filter (tests/test_sharded.py's), and within rtol 2e-5 / atol 1e-7
of ipk_tpu's own collective values.
"""

import jax
import numpy as np
import pytest

from ipk_tpu.core import dense as jdense
from ipk_tpu.core import sparse as jsparse
from ipk_tpu.core.filter import mif0_filter_values, score_threshold
from ipk_tpu.parallel.build_sharded import PAD_LOG_SCORE
from ipk_tpu.parallel.build_sharded import pad_ghosts as jax_pad_ghosts
from ipk_tpu.parallel.build_sharded import (sharded_batched_build_step,
                                            sharded_build_step)
from ipk_tpu.parallel.key_merge import device_key_merge
from ipk_tpu.parallel.mesh import make_mesh
from ipk_tpu_torch.parallel.build_sharded import pad_ghosts

from torch_ranks import load, run_ranks

WORLDS = (1, 2, 4)


def make_inputs(seed, G, S, sigma=4):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.ones(sigma) * 0.4, size=(G, S)).astype(np.float32)
    P = np.log10(np.maximum(p, 1e-30)).astype(np.float32)
    return P, jdense.best_score_prefix(P)


def random_lists(seed, G, W, C, nl, nr):
    rng = np.random.default_rng(seed)
    cl = rng.integers(0, nl, (G, W, C)).astype(np.uint32)
    cr = rng.integers(0, nr, (G, W, C)).astype(np.uint32)
    scores = rng.uniform(-9, 0, (G, W, C)).astype(np.float32)
    scores[rng.random((G, W, C)) < 0.3] = -np.inf
    return cl, cr, scores


def amino_lists(seed, G, W, C, bits=5, sigma=20):
    """Genuine AA packed half-codes: letters < 20 at 5-bit strides, so codes
    above sigma^hl exist (the key-range bound must be 2^(bits·hl))."""
    rng = np.random.default_rng(seed)

    def pack(shape):
        a = rng.integers(0, sigma, shape).astype(np.uint32)
        b = rng.integers(0, sigma, shape).astype(np.uint32)
        return (a << np.uint32(bits)) | b
    cl, cr = pack((G, W, C)), pack((G, W, C))
    scores = rng.uniform(-9, 0, (G, W, C)).astype(np.float32)
    scores[rng.random((G, W, C)) < 0.3] = -np.inf
    return cl, cr, scores


def signed_zero_lists(n):
    """Every (key, group) reached several times at a maximum of 0.0, as
    -0.0 in window 0 and +0.0 later (the reverse in odd groups of 2
    ghosts), beside negative scores: the kept bits must be those of the
    first tuple in row order, as merge_window_lists keeps them."""
    G, W, C = 2 * n, 3, 8
    cl = np.tile((np.arange(C, dtype=np.uint32) // 2) % 3, (G, W, 1))
    cr = np.tile(np.arange(C, dtype=np.uint32) % 2, (G, W, 1))
    scores = np.full((G, W, C), -1.5, np.float32)
    first = np.where((np.arange(G) // 2) % 2 == 0, -0.0, 0.0
                     ).astype(np.float32)
    scores[:, 0, 0::2] = first[:, None]
    scores[:, 1:, 0::2] = -first[:, None, None]
    return cl, cr, scores


def host_reference(cl, cr, scores, gpg, bits, k):
    """merge_window_lists per group, then the host lexsort by (key, group)
    (tests/test_key_merge.py's reference)."""
    shift = np.uint64(bits * (k - k // 2))
    codes = (cl.astype(np.uint64) << shift) | cr.astype(np.uint64)
    keys, borders, scs = [], [], []
    for g0 in range(0, cl.shape[0], gpg):
        c, s = jsparse.merge_window_lists(codes[g0:g0 + gpg],
                                          scores[g0:g0 + gpg])
        keys.append(c)
        scs.append(s)
        borders.append(np.full(len(c), g0 // gpg, dtype=np.int64))
    keys, borders, scs = (np.concatenate(x) for x in (keys, borders, scs))
    order = np.lexsort((borders, keys))
    return keys[order], borders[order], scs[order]


def jax_mesh(n):
    return make_mesh(n_branch=n, n_key=1, devices=jax.devices()[:n])


#: (name, ghosts per group, ranks, lists) of the key-merge cases
MERGES = [
    (f"km_g{gpg}_n{n}", gpg, n, random_lists(11 + n, n * gpg * 2, 6, 128,
                                             4 ** 4, 4 ** 4))
    for n in (2, 4) for gpg in (1, 2)]


def step_case(n):
    """The inputs of tests/test_sharded.py::test_sharded_various_mesh_sizes
    at n ranks."""
    k, sigma, omega = 3, 4, 1.0
    P, prefix = make_inputs(2, 2 * n * 2, 12)
    return dict(k=k, sigma=sigma, gpg=2, groups=2 * n + 1,
                threshold=score_threshold(omega, sigma, k),
                eps=np.float32(np.log10(score_threshold(omega, sigma, k))),
                P=P, prefix=prefix)


def two_d_case():
    k, sigma = 4, 4
    P, prefix = make_inputs(5, 16, 18)
    return dict(k=k, sigma=sigma, gpg=2, groups=9,
                threshold=score_threshold(1.5, sigma, k),
                eps=np.float32(np.log10(score_threshold(1.5, sigma, k))),
                P=P, prefix=prefix)


def sparse_case():
    k, sigma = 6, 4
    P, prefix = make_inputs(9, 7, 20)
    return dict(k=k, sigma=sigma, bits=2, cap=256,
                eps=np.float32(np.log10(score_threshold(1.5, sigma, k))),
                P=P, prefix=prefix)


def save(directory, name, **arrays):
    np.savez(directory / f"{name}.in.npz", **arrays)


def step_job(directory, name, case, kind="build_step", **extra):
    save(directory, name, P=case["P"], prefix=case["prefix"],
         eps=case["eps"])
    return dict(name=name, kind=kind, k=case["k"], sigma=case["sigma"],
                gpg=case["gpg"], groups=case["groups"],
                threshold=case["threshold"], **extra)


def merge_job(directory, name, lists, gpg, k=8, bits=2, nl=4 ** 4,
              bucket_cap=None):
    cl, cr, scores = lists
    save(directory, name, cl=cl, cr=cr, scores=scores)
    return dict(name=name, kind="key_merge", gpg=gpg, nl=nl, bits=bits, k=k,
                bucket_cap=bucket_cap)


def overflow_lists(n):
    cl, cr, scores = random_lists(3, n, 8, 256, 4 ** 4, 4 ** 4)
    cl[:] = 0                       # every tuple lands in range 0
    return cl, cr, scores


def duplicate_lists(n):
    """All keys in range 0, each (key, group) repeated at rising scores."""
    G, W, C = n, 3, 8
    cl = np.zeros((G, W, C), np.uint32)
    cr = np.tile(np.arange(C, dtype=np.uint32) % 4, (G, W, 1))
    scores = np.tile(np.linspace(-5, -1, C).astype(np.float32), (G, W, 1))
    return cl, cr, scores


def padded_case():
    """6 ghosts padded to 8 (tests/test_sharded.py's padding test), k=3."""
    P, prefix = make_inputs(1, 6, 15)
    eps = np.float32(np.log10(score_threshold(1.5, 4, 3)))
    return P, prefix, eps


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_parallel")
    jobs = {n: [step_job(d, f"step_n{n}", step_case(n))] for n in WORLDS}
    for name, gpg, n, lists in MERGES:
        jobs[n].append(merge_job(d, name, lists, gpg))
    jobs[4].append(step_job(d, "step_2x2", two_d_case(), n_key=2))
    jobs[2].append(step_job(d, "batched_n2", step_case(2),
                            kind="batched_step", key_batches=4))
    jobs[2].append(merge_job(d, "km_dup", duplicate_lists(2), 1, k=4,
                             nl=4))
    jobs[2].append(merge_job(d, "km_overflow", overflow_lists(2), 1,
                             bucket_cap=128))
    jobs[2].append(merge_job(d, "km_aa", amino_lists(23, 4, 5, 64), 2, k=4,
                             bits=5, nl=1 << 10))
    jobs[2].append(merge_job(d, "km_zero", signed_zero_lists(2), 2, k=4,
                             nl=16))
    P, prefix, eps = padded_case()
    save(d, "enum_pad", P=P, prefix=prefix, eps=eps)
    jobs[4].append(dict(name="enum_pad", kind="enumerate", k=3, sigma=4,
                        gpg=1))
    case = sparse_case()
    save(d, "sparse_many", P=case["P"], prefix=case["prefix"],
         eps=case["eps"])
    jobs[2].append(dict(name="sparse_many", kind="sparse_many", k=case["k"],
                        sigma=case["sigma"], bits=case["bits"],
                        cap=case["cap"]))
    jobs[2].append(dict(name="gpu_clash", kind="gpu_clash"))
    for n in WORLDS:
        run_ranks(n, jobs[n], d)
    return d


def rank_outputs(d, name, n):
    """Each rank's outputs; raises unless every rank holds the same."""
    outs = [load(d, name, r) for r in range(n)]
    for r in range(1, n):
        assert sorted(outs[r].files) == sorted(outs[0].files)
        for key in outs[0].files:
            np.testing.assert_array_equal(outs[r][key], outs[0][key],
                                          err_msg=f"{name}: rank {r}, {key}")
    return outs[0]


def single_device_A(case):
    A_ghost = jdense.accumulate_ghosts(case["P"], case["prefix"], case["eps"],
                                       k=case["k"], sigma=case["sigma"])
    return np.asarray(jdense.group_max(A_ghost, case["gpg"]))


def check_step(out, case, jax_mesh_):
    expected = single_device_A(case)
    np.testing.assert_array_equal(out["A"], expected)
    mask = np.isfinite(expected)
    present = mask.any(axis=0)
    fv_host = mif0_filter_values(expected, mask, case["groups"],
                                 case["threshold"])
    np.testing.assert_allclose(out["fv"][present], fv_host[present],
                               rtol=2e-4, atol=1e-6)
    step = sharded_build_step(jax_mesh_, k=case["k"], sigma=case["sigma"],
                              ghosts_per_group=case["gpg"],
                              total_num_groups=case["groups"],
                              threshold=case["threshold"])
    A_j, fv_j, counts_j = step(case["P"], case["prefix"], case["eps"])
    np.testing.assert_array_equal(out["A"], np.asarray(A_j))
    np.testing.assert_array_equal(out["counts"], np.asarray(counts_j))
    np.testing.assert_allclose(out["fv"][present],
                               np.asarray(fv_j)[present], rtol=2e-5,
                               atol=1e-7)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_step_matches_single_device(worlds, n):
    """tests/test_sharded.py's mesh sizes: A bit-equal to the one-device
    accumulator and to ipk_tpu's sharded step, counts equal, fv close to
    the host f64 filter and to ipk_tpu's f32 collective."""
    check_step(rank_outputs(worlds, f"step_n{n}", n), step_case(n),
               jax_mesh(n))


def test_2d_mesh_branch_key(worlds):
    """4 ranks as 2 branch x 2 key: the key ranks finish their halves of
    the filter values."""
    out = rank_outputs(worlds, "step_2x2", 4)
    case = two_d_case()
    assert out["fv"].shape == (case["sigma"] ** case["k"],)
    check_step(out, case, make_mesh(n_branch=2, n_key=2,
                                    devices=jax.devices()[:4]))


def test_batched_step_matches_ipk_tpu(worlds):
    """The key-batched device-MI step at 4 batches equals the unbatched
    accumulator and ipk_tpu's batched step."""
    out = rank_outputs(worlds, "batched_n2", 2)
    case = step_case(2)
    check_step(out, case, jax_mesh(2))
    halves_fn, batch_fn, step_l = sharded_batched_build_step(
        jax_mesh(2), k=case["k"], sigma=case["sigma"],
        ghosts_per_group=case["gpg"], total_num_groups=case["groups"],
        threshold=case["threshold"], key_batches=4)
    L, R = halves_fn(case["P"], case["prefix"], case["eps"])
    fv_j = np.concatenate([np.asarray(batch_fn(L, R, case["eps"],
                                               b * step_l)[1])
                           for b in range(4)])
    present = np.isfinite(out["A"]).any(axis=0)
    np.testing.assert_allclose(out["fv"][present], fv_j[present],
                               rtol=2e-5, atol=1e-7)


def test_padding_produces_no_survivors(worlds):
    """pad_ghosts is ipk_tpu's byte for byte; 6 ghosts over 4 ranks pad to
    8, and the padded ghosts leave no survivor in the combine."""
    P, prefix, eps = padded_case()
    got, want = pad_ghosts(P, prefix, 8), jax_pad_ghosts(P, prefix, 8)
    assert got[2] == want[2] == 6 and got[0].shape[0] == 8
    assert got[0].tobytes() == want[0].tobytes()
    assert got[1].tobytes() == want[1].tobytes()
    assert (got[0][6:] == PAD_LOG_SCORE).all()
    A = rank_outputs(worlds, "enum_pad", 4)["A"]
    A_pad = np.asarray(jdense.accumulate_ghosts(got[0], got[1], eps, k=3,
                                                sigma=4))
    np.testing.assert_array_equal(A, A_pad[:6])
    assert np.isfinite(A).any() and not np.isfinite(A_pad[6:]).any()


@pytest.mark.parametrize("name,gpg,n", [(m[0], m[1], m[2]) for m in MERGES])
def test_key_merge_matches_host_and_ipk_tpu(worlds, name, gpg, n):
    """tests/test_key_merge.py's random lists: the merged stream equals the
    host merge and ipk_tpu's device merge on the same inputs."""
    lists = next(m[3] for m in MERGES if m[0] == name)
    out = rank_outputs(worlds, name, n)
    for ref in (host_reference(*lists, gpg, 2, 8),
                device_key_merge(jax_mesh(n), *lists, ghosts_per_group=gpg,
                                 nl=4 ** 4, bits=2, k=8)):
        np.testing.assert_array_equal(out["keys"], ref[0])
        np.testing.assert_array_equal(out["border"], ref[1])
        assert out["scores"].tobytes() == ref[2].tobytes()


def test_key_merge_duplicate_max_and_empty_rank(worlds):
    """Duplicate (key, group) tuples keep the maximum; the rank whose key
    range is empty contributes nothing."""
    out = rank_outputs(worlds, "km_dup", 2)
    ref = host_reference(*duplicate_lists(2), 1, 2, 4)
    np.testing.assert_array_equal(out["keys"], ref[0])
    np.testing.assert_array_equal(out["border"], ref[1])
    assert out["scores"].tobytes() == ref[2].tobytes()


def test_key_merge_overflow_raises_on_every_rank(worlds):
    for r in range(2):
        assert int(load(worlds, "km_overflow", r)["overflow"]) == 1


def test_key_merge_amino_bitpacked_codes(worlds):
    """σ=20: cl codes above σ^hl land in their key range (2^(bits·hl))."""
    lists = amino_lists(23, 4, 5, 64)
    assert (lists[0] >= 20 ** 2).any()
    out = rank_outputs(worlds, "km_aa", 2)
    for ref in (host_reference(*lists, 2, 5, 4),
                device_key_merge(jax_mesh(2), *lists, ghosts_per_group=2,
                                 nl=1 << 10, bits=5, k=4)):
        np.testing.assert_array_equal(out["keys"], ref[0])
        np.testing.assert_array_equal(out["border"], ref[1])
        assert out["scores"].tobytes() == ref[2].tobytes()


def test_key_merge_signed_zero_tie(worlds):
    """A ±0.0 tie at the maximum keeps the first tuple's bits in row order,
    as merge_window_lists and ipk_tpu's merge do."""
    lists = signed_zero_lists(2)
    out = rank_outputs(worlds, "km_zero", 2)
    ref = host_reference(*lists, 2, 2, 4)
    assert out["scores"].tobytes() == ref[2].tobytes()
    signs = np.signbit(ref[2][ref[2] == 0])
    assert signs.any() and not signs.all()
    np.testing.assert_array_equal(out["keys"], ref[0])
    jax_ref = device_key_merge(jax_mesh(2), *lists, ghosts_per_group=2,
                               nl=16, bits=2, k=4)
    assert out["scores"].tobytes() == jax_ref[2].tobytes()


def test_sharded_sparse_enumeration(worlds):
    """enumerate_sparse_many over 2 ranks (7 ghosts, padded to 8): every
    rank holds the lists of all ghosts, equal to ipk_tpu's over its 2-device
    mesh."""
    out = rank_outputs(worlds, "sparse_many", 2)
    case = sparse_case()
    codes, scores, overflow = jsparse.enumerate_sparse_many(
        case["P"], case["prefix"], case["eps"], k=case["k"],
        sigma=case["sigma"], bits=case["bits"], cap=case["cap"],
        mesh=jax_mesh(2))
    np.testing.assert_array_equal(out["codes"], codes)
    assert out["scores"].tobytes() == np.asarray(scores).tobytes()
    np.testing.assert_array_equal(out["overflow"], overflow)


def test_nccl_check_refuses_two_ranks_on_one_gpu(worlds):
    for r in range(2):
        assert int(load(worlds, "gpu_clash", r)["raised"]) == 1
