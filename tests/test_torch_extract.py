"""Stage 2 of a dense key batch on the device: ``core.kernels.extract_columns``
(kernel ``core/csrc/extract_columns.cu``, plain version
``core.dense.extract_columns_ref``) and ``builder._finish_columns``.

On the CPU the plain version, finished by the builder, is held to the host
extraction (``host._extract_compact`` over the compacted survivors) on the
same accumulator: keys, counts, branches, scores and filter values
identical. The kernel runs only on a card, in the tests marked ``cuda``
(skipped where ``torch.cuda.is_available()`` is false): counts, branches and
scores bit-equal to the plain version, and the float64 mif0 values within
1e-12 of max(|fv|, the median |fv|) of the host's, since CUDA's exp10 and
log2 round differently from the host's libm while the sums keep its order.

This file imports no jax: the card's machine runs it with
``python -m pytest --noconftest -q -m cuda tests/test_torch_extract.py``.
"""

import numpy as np
import pytest
import torch

from ipk_tpu_torch import builder
from ipk_tpu_torch.core import kernels
from ipk_tpu_torch.core.filter import RandomFilterStream, score_threshold
from ipk_tpu_torch.host import _extract_compact
from ipk_tpu_torch.seq import AA, DNA
from ipk_tpu_torch.spans import Recorder

torch.set_num_threads(2)

#: the main path's key batch: 256 taxa (510 branches, 511 nodes), DNA k=8
#: in 4 key batches
SCALE_B, SCALE_CHUNK, SCALE_NODES = 510, 16_384, 511


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def accumulator(seed, B, chunk, *, eps, live=0.77, ties=False):
    """A seeded A [B, chunk]: scores in (eps, 0], -inf elsewhere; column 0
    dead, column 1 all live; with ``ties`` the scores take few values, so
    maxima tie across rows."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(eps, 0.0, size=(B, chunk)).astype(np.float32)
    if ties:
        A = (np.round(A * 2) / 2).astype(np.float32)
        A[A <= eps] = np.float32(0.0)
    A[rng.random(A.shape) >= live] = -np.inf
    A[:, 0] = -np.inf
    if chunk > 1:
        A[:, 1] = np.float32(eps / 2)
    return torch.from_numpy(A)


def group_ids(B, seed=3):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(4 * B + 8, size=B, replace=False)).astype(
        np.int64).tolist()


def threshold_and_eps(traits, k, omega):
    thr = score_threshold(omega, traits.alphabet_size, k)
    return thr, float(np.float32(np.log10(thr)))


def host_route(A, gids, lo, k, traits, filter_args):
    """The host extraction of A's finite cells, flat indices over the
    transposed A (key-major, groups ascending within a key)."""
    B, chunk = A.shape
    flat = A.t().reshape(-1)
    flat_idx = torch.nonzero(torch.isfinite(flat)).reshape(-1)
    return _extract_compact(flat_idx.to(torch.int32).numpy(),
                            flat[flat_idx].numpy(), B, chunk, lo, gids, k,
                            traits, *filter_args, recorder=Recorder())


def columns_route(A, gids, lo, k, traits, filter_args, recorder=None):
    """The device route's plain version, finished as the builder does."""
    total, thr, filter_type, _, merge = filter_args
    counts, fv, br, sc = kernels.extract_columns(
        A, torch.tensor(gids, dtype=torch.int32), total_num_groups=total,
        threshold=thr, mif0=filter_type == "mif0", merge_branches=merge,
        recorder=recorder)
    batch = ("columns", lo, counts.numpy(),
             None if fv is None else fv.numpy(), br.numpy().view(np.uint32),
             sc.numpy(), 0)
    return builder._finish_columns(batch, k, traits, filter_args)


def assert_same_columns(got, want):
    names = ("keys", "fv", "counts", "branches", "scores")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[5] is None and want[5] is None


@pytest.mark.parametrize("filter_type", ["mif0", "random"])
@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("traits,k,omega,B,chunk,lo,live,ties", [
    (DNA, 6, 1.5, 7, 1024, 2048, 0.77, False),
    (DNA, 5, 1.5, 13, 333, 512, 0.3, True),       # ragged B and chunk
    (DNA, 4, 1.5, 1, 97, 0, 0.5, False),          # one group row
    (AA, 3, 6.0, 9, 400, 3200, 0.6, True),
    (AA, 2, 6.0, 5, 37, 100, 1.0, False),         # every column live
    (DNA, 7, 1.5, 510, 64, 4096, 0.77, True),     # the main path's B
    (AA, 4, 6.0, 3, 160, 8000, 0.05, False),      # few survivors
])
def test_plain_version_equals_host_extraction(filter_type, merge, traits, k,
                                              omega, B, chunk, lo, live,
                                              ties):
    thr, eps = threshold_and_eps(traits, k, omega)
    A = accumulator(B * chunk + k, B, chunk, eps=eps, live=live, ties=ties)
    gids = group_ids(B)
    nodes = 2 * B + 3

    def args():
        rng = RandomFilterStream() if filter_type == "random" else None
        return (nodes, thr, filter_type, rng, merge)

    want = host_route(A, gids, lo, k, traits, args())
    before = kernels.extract_columns.launches
    got = columns_route(A, gids, lo, k, traits, args())
    assert kernels.extract_columns.launches == before
    assert_same_columns(got, want)
    assert len(got[0]) == int(torch.isfinite(A).any(dim=0).sum())


def test_plain_version_all_dead_batch():
    thr, eps = threshold_and_eps(DNA, 6, 1.5)
    A = torch.full((4, 256), float("-inf"))
    got = columns_route(A, group_ids(4), 0, 6, DNA,
                        (9, thr, "mif0", None, False))
    want = host_route(A, group_ids(4), 0, 6, DNA,
                      (9, thr, "mif0", None, False))
    assert len(got[0]) == 0 and len(got[3]) == 0
    assert_same_columns(got, want)


def test_plain_version_counts_and_mif0_span():
    thr, eps = threshold_and_eps(DNA, 6, 1.5)
    A = accumulator(5, 6, 512, eps=eps)
    rec = Recorder()
    counts, fv, br, sc = kernels.extract_columns(
        A, torch.tensor(group_ids(6), dtype=torch.int32),
        total_num_groups=15, threshold=thr, recorder=rec)
    assert counts.dtype == torch.int32 and fv.dtype == torch.float64
    assert br.dtype == torch.int32 and sc.dtype == torch.float32
    assert torch.equal(counts, torch.isfinite(A).sum(dim=0, dtype=torch.int32))
    assert int(counts.sum()) == len(br) == len(sc)
    assert fv[0] == 0 and (fv[counts > 0] != 0).all()
    assert [s.name for s in rec.spans] == ["mif0"]
    # the random filter computes no filter value and opens no span
    rec = Recorder()
    _, fv, _, _ = kernels.extract_columns(
        A, torch.tensor(group_ids(6), dtype=torch.int32),
        total_num_groups=15, threshold=thr, mif0=False, recorder=rec)
    assert fv is None and rec.spans == []


@pytest.mark.parametrize("bad", ["A_f64", "gid_i64", "A_1d", "gid_len",
                                 "A_i32", "gid_2d"])
def test_wrapper_rejects_bad_input(bad):
    A = torch.zeros((3, 8))
    gid = torch.zeros(3, dtype=torch.int32)
    if bad == "A_f64":
        A = A.double()
    elif bad == "gid_i64":
        gid = gid.long()
    elif bad == "A_1d":
        A = A.reshape(-1)
    elif bad == "A_i32":
        A = A.to(torch.int32)
    elif bad == "gid_2d":
        gid = gid.reshape(3, 1)
    else:
        gid = gid[:2]
    with pytest.raises((TypeError, ValueError)):
        kernels.extract_columns(A, gid, total_num_groups=7, threshold=0.01)


def test_plain_version_merge_keeps_the_lowest_tied_row():
    """With ``merge_branches`` a column whose maximum ties across rows
    keeps the lowest of them; mif0 then runs over that one entry."""
    thr, _ = threshold_and_eps(DNA, 4, 1.5)
    ninf = float("-inf")
    A = torch.tensor([[-0.5, ninf, -0.2],
                      [-0.1, -0.3, -0.2],
                      [-0.1, -0.3, -0.4]], dtype=torch.float32)
    gids = torch.tensor([4, 9, 12], dtype=torch.int32)
    counts, fv, br, sc = kernels.extract_columns(
        A, gids, total_num_groups=9, threshold=thr, merge_branches=True)
    assert counts.tolist() == [1, 1, 1]
    assert br.tolist() == [9, 9, 4]
    assert sc.tolist() == A[[1, 1, 0], [0, 1, 2]].tolist()
    single = kernels.extract_columns(A[1:2, :1], gids[1:2],
                                     total_num_groups=9, threshold=thr)
    assert fv[0] == single[1][0]


def test_finish_columns_rejects_an_unknown_filter():
    batch = ("columns", 0, np.array([1, 0], dtype=np.int32), None,
             np.zeros(1, dtype=np.uint32), np.zeros(1, dtype=np.float32), 0)
    with pytest.raises(RuntimeError, match="Unsupported filter type"):
        builder._finish_columns(batch, 1, DNA, (3, 0.5, "other", None,
                                                False))


def fv_scale(fv_host, live):
    mag = np.abs(fv_host[live])
    return np.maximum(mag, np.median(mag)) if len(mag) else mag


@pytest.mark.cuda
@pytest.mark.parametrize("B,chunk,merge,filter_type,live", [
    (SCALE_B, SCALE_CHUNK, False, "mif0", 0.77),    # the main path's batch
    (SCALE_B, SCALE_CHUNK, True, "mif0", 0.77),
    (SCALE_B, SCALE_CHUNK, False, "random", 0.77),
    (37, 1001, False, "mif0", 0.4),                  # ragged
    (129, 333, True, "mif0", 0.9),
    (1, 130, False, "mif0", 0.5),
])
def test_kernel_matches_plain_version(cuda_device, B, chunk, merge,
                                      filter_type, live):
    thr, eps = threshold_and_eps(DNA, 8, 1.5)
    A = accumulator(B + chunk, B, chunk, eps=eps, live=live, ties=merge)
    gids = torch.tensor(group_ids(B), dtype=torch.int32)
    nodes = SCALE_NODES if B == SCALE_B else 2 * B + 3
    opts = dict(total_num_groups=nodes, threshold=thr,
                mif0=filter_type == "mif0", merge_branches=merge)
    want = kernels.extract_columns(A, gids, **opts)
    before = kernels.extract_columns.launches
    got = kernels.extract_columns(A.to(cuda_device), gids.to(cuda_device),
                                  **opts)
    assert kernels.extract_columns.launches == before + 1
    counts, fv, br, sc = (None if t is None else t.cpu() for t in got)
    assert torch.equal(counts, want[0])
    assert torch.equal(br, want[2])
    assert torch.equal(sc.view(torch.int32), want[3].view(torch.int32))
    if filter_type != "mif0":
        assert fv is None and want[1] is None
        return
    live_cols = (want[0] > 0).numpy()
    fv_k, fv_h = fv.numpy(), want[1].numpy()
    assert (fv_k[~live_cols] == 0).all()
    gap = np.abs(fv_k[live_cols] - fv_h[live_cols])
    assert (gap <= 1e-12 * fv_scale(fv_h, live_cols)).all(), gap.max()


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous_or_wrong_dtype(cuda_device):
    A = torch.zeros((8, 3), device=cuda_device)
    gid = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.extract_columns(A.t(), gid, total_num_groups=7,
                                threshold=0.01)
    with pytest.raises(TypeError):
        kernels.extract_columns(A.t().contiguous().half(), gid,
                                total_num_groups=7, threshold=0.01)
    with pytest.raises(ValueError):
        kernels.extract_columns(A.t().contiguous(), gid.cpu(),
                                total_num_groups=7, threshold=0.01)
