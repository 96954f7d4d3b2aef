"""ipk_tpu_torch.core.kernels: the CUDA kernel wrappers (combine_max, its
positions mode, staircase_select).

On the CPU a wrapper takes its plain version and leaves its launch count
alone; the kernels themselves run only on a card, in the tests marked
``cuda`` (skipped where ``torch.cuda.is_available()`` is false). Tolerance:
none; the kernels' arithmetic is exactly rounded f32 add / max / compare,
and the staircase's sorts and slot order are deterministic.

This file imports no jax: it is the one the card's machine runs.
"""

import numpy as np
import pytest
import torch

from ipk_tpu_torch.core import dense, kernels, sparse

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def halves(seed, G=2, W=13, nl=12, nr=20, device="cpu"):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(G, W, nl)).astype(np.float32)
    R = rng.normal(size=(G, W, nr)).astype(np.float32)
    L[rng.random(L.shape) < 0.2] = -np.inf
    return (torch.from_numpy(L).to(device), torch.from_numpy(R).to(device),
            torch.tensor(np.float32(0.5), device=device))


def test_import_builds_nothing():
    """Importing the wrappers needs no nvcc and builds no library."""
    from ipk_tpu_torch.core import _build
    assert _build._lib is None
    assert _build.LIB_PATH.endswith("build/ipk_tpu_torch/libipk_kernels.so")


def test_cpu_tensor_takes_plain_version():
    L, R, eps = halves(1)
    before = kernels.combine_max.launches
    A, counts = kernels.combine_max(L, R, eps)
    A_ref, counts_ref = dense.combine_max_ref(L, R, eps)
    assert kernels.combine_max.launches == before
    assert torch.equal(A, A_ref) and torch.equal(counts, counts_ref)


@pytest.mark.parametrize("bad", ["L_f64", "R_f64", "eps_float", "eps_f64",
                                 "shape"])
def test_wrapper_rejects_bad_input(bad):
    L, R, eps = halves(2)
    if bad == "L_f64":
        L = L.double()
    elif bad == "R_f64":
        R = R.double()
    elif bad == "eps_float":
        eps = 0.5
    elif bad == "eps_f64":
        eps = eps.double()
    else:
        R = R[:, :-1]
    with pytest.raises((TypeError, ValueError)):
        kernels.combine_max(L, R, eps)


@pytest.mark.cuda
@pytest.mark.parametrize("G,W,nl,nr", [(2, 13, 12, 20), (3, 70, 33, 65),
                                       (2, 40, 400, 400), (1, 0, 8, 8)])
def test_kernel_matches_plain_on_card(cuda_device, G, W, nl, nr):
    L, R, eps = halves(3, G, W, nl, nr, device=cuda_device)
    before = kernels.combine_max.launches
    A, counts = kernels.combine_max(L, R, eps)
    torch.cuda.synchronize()
    assert kernels.combine_max.launches == before + 1
    A_ref, counts_ref = dense.combine_max_ref(L, R, eps)
    assert torch.equal(A, A_ref)
    assert torch.equal(counts, counts_ref)


def count_inputs(kind, G, W, nl, nr, sigma, seed):
    """Halves whose values are sums of sigma-ary log10 scores (few distinct
    values: many ties), with -inf rows, ±0.0, sums tied at eps, or eps
    above, below or at 0."""
    rng = np.random.default_rng(seed)
    grid = np.log10(rng.dirichlet(np.ones(sigma) * 0.5, size=3).ravel()
                    ).astype(np.float32)
    L = rng.choice(grid, size=(G, W, nl)).astype(np.float32)
    R = rng.choice(grid, size=(G, W, nr)).astype(np.float32)
    L[rng.random(L.shape) < 0.3] = -np.inf
    eps = np.float32(np.median(L[np.isfinite(L)]) + np.median(R))
    if kind == "neg_inf_rows":
        L[:, ::3] = -np.inf
        R[:, 1::4] = -np.inf
    elif kind == "signed_zeros":
        L[rng.random(L.shape) < 0.3] = -0.0
        L[rng.random(L.shape) < 0.2] = 0.0
        R[rng.random(R.shape) < 0.3] = -0.0
        R[rng.random(R.shape) < 0.2] = 0.0
        eps = np.float32(-0.25)
    elif kind == "ties_at_eps":
        eps = np.float32(L.flat[np.flatnonzero(np.isfinite(L))[0]]
                         + R.flat[0])
    elif kind == "eps_above_zero":
        L, R, eps = -L, -R, np.float32(0.25)
        L[np.isnan(L) | np.isposinf(L)] = -np.inf
    elif kind == "eps_below_zero":
        eps = np.float32(-0.5)
    elif kind == "eps_zero":
        L, R, eps = L + np.float32(0.75), R, np.float32(0.0)
    return (torch.from_numpy(np.ascontiguousarray(L)),
            torch.from_numpy(np.ascontiguousarray(R)), torch.tensor(eps))


@pytest.mark.parametrize("side", ["l", "r"])
@pytest.mark.parametrize("kind,G,W,nl,nr,sigma", [
    ("random", 2, 13, 16, 64, 4), ("random", 1, 9, 20, 400, 20),
    ("random", 3, 7, 33, 65, 4), ("random", 2, 5, 1, 3, 20),
    ("neg_inf_rows", 2, 12, 16, 64, 4), ("signed_zeros", 2, 11, 16, 64, 4),
    ("signed_zeros", 1, 6, 20, 400, 20), ("ties_at_eps", 2, 9, 16, 64, 4),
    ("eps_above_zero", 2, 8, 16, 64, 4), ("eps_below_zero", 2, 8, 20, 400, 20),
    ("eps_zero", 2, 8, 16, 64, 4), ("random", 1, 3, 64, 4096, 4),
    ("random", 1, 2, 400, 8000, 20)])
def test_sorted_search_count_equals_plain(kind, G, W, nl, nr, sigma, side):
    """The kernel's counting rule (sorted search, either half sorted) gives
    combine_max_ref's counts exactly."""
    L, R, eps = count_inputs(kind, G, W, nl, nr, sigma, seed=nl + nr + W)
    _, counts = dense.combine_max_ref(L, R, eps)
    got = dense.count_explored_sorted(L, R, eps, side=side)
    assert torch.equal(got, counts)
    if kind == "ties_at_eps":
        T = L[:, :, :, None] + R[:, :, None, :]
        assert bool((T == eps).any())      # a sum sits exactly at eps
    if kind == "signed_zeros":
        assert int(counts.sum()) > 0


def card_inputs(kind, G, W, nl, nr, device):
    """Random halves with 20% -inf in L, every value live, or 90% -inf (the
    short lists of a real build's masked halves)."""
    L, R, eps = halves(11 + nl + nr, G, W, nl, nr)
    if kind == "dense":
        L = torch.from_numpy(np.random.default_rng(nl).normal(
            size=(G, W, nl)).astype(np.float32))
    elif kind == "sparse":
        rng = np.random.default_rng(nr)
        L[torch.from_numpy(rng.random(L.shape) < 0.9)] = float("-inf")
        R[torch.from_numpy(rng.random(R.shape) < 0.9)] = float("-inf")
        eps = torch.tensor(np.float32(-1.0))
    return L.to(device), R.to(device), eps.to(device)


#: ragged tiles (nl, nr and W multiples of no tile, W not a multiple of 32),
#: 16-byte and 4-byte staging, the widest dense shapes (nr = 4096: DNA k=11;
#: nr = 8000: AA k=5)
CARD_SHAPES = [("random", 2, 45, 65, 129), ("dense", 1, 33, 64, 256),
               ("sparse", 2, 70, 100, 300), ("dense", 1, 31, 3, 5),
               ("random", 1, 19, 256, 4096), ("sparse", 1, 12, 1024, 4096),
               ("random", 1, 9, 400, 8000), ("dense", 1, 5, 20, 8000)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,G,W,nl,nr", CARD_SHAPES)
def test_kernel_bit_equal_at_redesign_shapes(cuda_device, kind, G, W, nl,
                                             nr):
    L, R, eps = card_inputs(kind, G, W, nl, nr, cuda_device)
    A, counts = kernels.combine_max(L, R, eps)
    torch.cuda.synchronize()
    A_ref, counts_ref = dense.combine_max_ref(L, R, eps)
    assert torch.equal(A.view(torch.int32), A_ref.view(torch.int32))
    assert torch.equal(counts, counts_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,G,W,nl,nr", CARD_SHAPES)
def test_positions_bit_equal_at_redesign_shapes(cuda_device, kind, G, W, nl,
                                                nr):
    L, R, eps = card_inputs(kind, G, W, nl, nr, cuda_device)
    A, pos, counts = kernels.combine_max_with_positions(L, R, eps)
    torch.cuda.synchronize()
    A_ref, pos_ref, counts_ref = dense.combine_max_with_positions_ref(
        L, R, eps)
    assert torch.equal(A.view(torch.int32), A_ref.view(torch.int32))
    assert torch.equal(pos, pos_ref)
    assert torch.equal(counts, counts_ref)


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous(cuda_device):
    L, R, eps = halves(4, nl=16, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.combine_max(L[:, :, :8], R, eps)


def test_positions_cpu_tensor_takes_plain_version():
    L, R, eps = halves(6)
    before = kernels.combine_max_with_positions.launches
    got = kernels.combine_max_with_positions(L, R, eps)
    ref = dense.combine_max_with_positions_ref(L, R, eps)
    assert kernels.combine_max_with_positions.launches == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["L_f64", "eps_float", "shape"])
def test_positions_wrapper_rejects_bad_input(bad):
    L, R, eps = halves(7)
    if bad == "L_f64":
        L = L.double()
    elif bad == "eps_float":
        eps = 0.5
    else:
        R = R[:, :-1]
    with pytest.raises((TypeError, ValueError)):
        kernels.combine_max_with_positions(L, R, eps)


def positions_inputs(kind, G, W, nl, nr, device):
    """Random halves, all-equal windows, or halves <= 0 full of -0.0 and
    +0.0 (zero maxima reached with both signs)."""
    if kind == "random":
        return halves(8, G, W, nl, nr, device=device)
    if kind == "constant":
        L = torch.full((G, W, nl), -0.75)
        R = torch.full((G, W, nr), -0.5)
        return L.to(device), R.to(device), torch.tensor(
            np.float32(-2.0), device=device)
    rng = np.random.default_rng(9)
    L = -np.abs(np.round(rng.normal(size=(G, W, nl)), 0)).astype(np.float32)
    R = -np.abs(np.round(rng.normal(size=(G, W, nr)), 0)).astype(np.float32)
    L[rng.random(L.shape) < 0.4] = -0.0
    R[rng.random(R.shape) < 0.3] = -0.0
    R[rng.random(R.shape) < 0.2] = 0.0
    return (torch.from_numpy(L).to(device), torch.from_numpy(R).to(device),
            torch.tensor(np.float32(-1.5), device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,G,W,nl,nr", [
    ("random", 2, 13, 12, 20), ("random", 3, 70, 33, 65),
    ("random", 2, 40, 400, 400), ("random", 1, 0, 8, 8),
    ("constant", 2, 37, 6, 9), ("signed_zeros", 2, 45, 12, 20),
    ("signed_zeros", 1, 100, 40, 70)])
def test_positions_kernel_matches_plain_on_card(cuda_device, kind, G, W, nl,
                                                nr):
    L, R, eps = positions_inputs(kind, G, W, nl, nr, cuda_device)
    before = kernels.combine_max_with_positions.launches
    A, pos, counts = kernels.combine_max_with_positions(L, R, eps)
    torch.cuda.synchronize()
    assert kernels.combine_max_with_positions.launches == before + 1
    A_ref, pos_ref, counts_ref = dense.combine_max_with_positions_ref(
        L, R, eps)
    assert torch.equal(A.view(torch.int32), A_ref.view(torch.int32))
    assert torch.equal(pos, pos_ref)
    assert torch.equal(counts, counts_ref)
    if kind == "constant":
        assert bool((pos == 0).all())


@pytest.mark.cuda
def test_positions_kernel_rejects_non_contiguous(cuda_device):
    L, R, eps = halves(4, nl=16, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.combine_max_with_positions(L[:, :, :8], R, eps)


def staircase_inputs(seed, G=2, W=5, CL=20, CR=33, device="cpu",
                     signed_zeros=False, sign_bit=False):
    """Seeded survivor lists: ties (rounded scores), pruned -inf entries,
    optionally ±0.0 scores and codes with bit 31 set."""
    rng = np.random.default_rng(seed)
    sL = np.round(rng.uniform(-3, 0, (G, W, CL)), 1).astype(np.float32)
    sR = np.round(rng.uniform(-3, 0, (G, W, CR)), 1).astype(np.float32)
    sL[rng.random(sL.shape) < 0.1] = -np.inf
    sR[rng.random(sR.shape) < 0.1] = -np.inf
    if signed_zeros:
        sL[..., ::5] = -0.0
        sR[..., 1::4] = -0.0
        sR[..., 2::4] = 0.0
    cL = rng.permutation(G * W * CL).astype(np.int64).reshape(G, W, CL)
    cR = rng.permutation(G * W * CR).astype(np.int64).reshape(G, W, CR)
    if sign_bit:
        cL = cL * 0x20000001 % (1 << 32)
        cR = cR * 0x30000001 % (1 << 32)
    eps = rng.uniform(-3.5, -2.5, (G, W)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (sL, cL, sR, cR, eps))


def test_staircase_cpu_tensor_takes_plain_version():
    args = staircase_inputs(1)
    before = kernels.staircase_select.launches
    got = kernels.staircase_select(*args, cap=128, sort_l=False)
    ref = sparse.staircase_select_ref(*args, cap=128, sort_l=False)
    assert kernels.staircase_select.launches == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["sL_f64", "cL_i32", "cR_f32", "eps_f64",
                                 "eps_shape", "R_shape", "codes_shape",
                                 "pairs_2_31", "empty_cap"])
def test_staircase_rejects_bad_input(bad):
    sL, cL, sR, cR, eps = staircase_inputs(2)
    cap = 128
    if bad == "sL_f64":
        sL = sL.double()
    elif bad == "cL_i32":
        cL = cL.int()
    elif bad == "cR_f32":
        cR = cR.float()
    elif bad == "eps_f64":
        eps = eps.double()
    elif bad == "eps_shape":
        eps = eps[:, :-1]
    elif bad == "R_shape":
        sR, cR = sR[:, :-1], cR[:, :-1]
    elif bad == "codes_shape":
        cL = cL[:, :, :-1]
    elif bad == "pairs_2_31":
        # 46,341^2 >= 2^31: totals and row offsets would not fit int32
        width = 46_341
        sL = sR = torch.full((1, 1, width), -1.0)
        cL = cR = torch.zeros((1, 1, width), dtype=torch.int64)
        eps = eps[:1, :1]
    else:
        cap = 0
    with pytest.raises((TypeError, ValueError),
                       match="2\\^31" if bad == "pairs_2_31" else None):
        kernels.staircase_select(sL, cL, sR, cR, eps, cap=cap)


@pytest.mark.parametrize("CL,CR,cap", [(100, 100, 8320), (8200, 16, 256)],
                         ids=["wide_cap", "wide_list"])
def test_staircase_accepts_wide_shapes(CL, CR, cap):
    """Caps and lists above 8192, which the wrapper once refused, go to the
    plain version on the CPU (tests/test_torch_sparse.py holds them to
    ipk_tpu's route for such shapes and to a brute force)."""
    args = staircase_inputs(CL + cap, 1, 2, CL, CR)
    before = kernels.staircase_select.launches
    got = kernels.staircase_select(*args, cap=cap)
    assert kernels.staircase_select.launches == before
    for a, b in zip(got, sparse.staircase_select_ref(*args, cap=cap)):
        assert torch.equal(a, b)
    assert got[2].shape[2] == cap and int(got[3].min()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("sort_l", [True, False])
@pytest.mark.parametrize("G,W,CL,CR,cap,opts", [
    (1, 5, 20, 33, 128, {}),
    (2, 9, 130, 200, 256, {}),
    (1, 3, 300, 40, 384, {}),
    (2, 4, 64, 64, 200, {"signed_zeros": True, "sign_bit": True}),
    (1, 4, 40, 40, 100, {}),                 # cap not a multiple of 128
    (1, 2, 4096, 4096, 4096, {}),
    (1, 2, 8192, 8192, 8192, {}),
])
def test_staircase_kernel_matches_plain_on_card(cuda_device, G, W, CL, CR,
                                                cap, opts, sort_l):
    args = staircase_inputs(5 + CL, G, W, CL, CR, device=cuda_device, **opts)
    before = kernels.staircase_select.launches
    got = kernels.staircase_select(*args, cap=cap, sort_l=sort_l)
    torch.cuda.synchronize()
    assert kernels.staircase_select.launches == before + 1
    ref = sparse.staircase_select_ref(*args, cap=cap, sort_l=sort_l)
    for name, a, b in zip(("cl", "cr", "scores", "totals"), got, ref):
        if name == "scores":
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_staircase_kernel_overflow_totals(cuda_device):
    """Everything survives: totals past cap, every cap slot filled."""
    sL, cL, sR, cR, eps = staircase_inputs(3, 1, 4, 40, 40,
                                           device=cuda_device)
    sL, sR = sL.clamp(min=-1.0), sR.clamp(min=-1.0)
    eps = torch.full_like(eps, -100.0)
    _, _, s, tot = kernels.staircase_select(sL, cL, sR, cR, eps, cap=128)
    torch.cuda.synchronize()
    assert bool((tot == 1600).all()) and bool(torch.isfinite(s).all())


def live_lists(seed, G, W, CL, CR, nL, nR, prefix, device):
    """Survivor lists with exactly nL / nR live (> -inf) entries a window,
    as a compact prefix (a staircase output) or scattered among -inf (a
    complete product pruned in place); tied scores, unique codes."""
    rng = np.random.default_rng(seed)

    def side(C, n):
        s = np.full((G, W, C), -np.inf, np.float32)
        vals = np.round(rng.uniform(-3, 0, (G, W, n)), 1).astype(np.float32)
        if prefix:
            s[..., :n] = vals
        else:
            pos = np.argsort(rng.random((G, W, C)), axis=-1)[..., :n]
            np.put_along_axis(s, pos, vals, axis=-1)
        codes = rng.permutation(G * W * C).astype(np.int64).reshape(G, W, C)
        return s, codes

    sL, cL = side(CL, nL)
    sR, cR = side(CR, nR)
    eps = rng.uniform(-3.5, -2.5, (G, W)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (sL, cL, sR, cR, eps))


def assert_staircase_equal(got, ref):
    for name, a, b in zip(("cl", "cr", "scores", "totals"), got, ref):
        if name == "scores":
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name


#: the kernel's paths by live entries a list: a warp sorts 1 (no sort), 32
#: (one entry a lane), 33 (two), 256 (eight) in registers; 257 defers the
#: window to the block pass, staged in shared memory; 0 emits only dead
#: slots. 13 windows: a warp-pass block of 8 windows and a ragged one; cap
#: 1001 leaves unaligned dead tails.
LIVE_CASES = [(0, 0), (1, 1), (32, 32), (33, 33), (256, 256), (257, 257),
              (32, 257), (257, 1), (5, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("sort_l", [True, False])
@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "in_place"])
@pytest.mark.parametrize("nL,nR", LIVE_CASES)
def test_staircase_kernel_paths_on_card(cuda_device, nL, nR, prefix, sort_l):
    args = live_lists(nL * 1000 + nR, 1, 13, 320, 300, nL, nR, prefix,
                      cuda_device)
    before = kernels.staircase_select.launches
    got = kernels.staircase_select(*args, cap=1001, sort_l=sort_l)
    torch.cuda.synchronize()
    assert kernels.staircase_select.launches == before + 1
    assert_staircase_equal(got, sparse.staircase_select_ref(
        *args, cap=1001, sort_l=sort_l))


@pytest.mark.cuda
def test_staircase_kernel_deferred_queue_on_card(cuda_device):
    """More deferred windows (every one of 1200, 270 live entries a list)
    than the block pass has blocks, so its blocks stride over the queue."""
    args = live_lists(6, 2, 600, 300, 300, 270, 270, True, cuda_device)
    got = kernels.staircase_select(*args, cap=700)
    torch.cuda.synchronize()
    assert_staircase_equal(got, sparse.staircase_select_ref(*args, cap=700))


@pytest.mark.cuda
def test_staircase_kernel_oversize_on_card(cuda_device):
    """Lists too wide for shared memory: the wide path's global scratch."""
    args = staircase_inputs(12, 1, 1, 12_000, 12_000, device=cuda_device)
    got = kernels.staircase_select(*args, cap=16_384)
    torch.cuda.synchronize()
    ref = sparse.staircase_select_ref(*args, cap=16_384)
    assert_staircase_equal(got, ref)
    assert int(ref[3].min()) > 16_384          # every slot filled


@pytest.mark.cuda
def test_staircase_kernel_all_dead_window(cuda_device):
    sL, cL, sR, cR, eps = live_lists(3, 1, 3, 64, 64, 20, 20, False,
                                     cuda_device)
    sL[0, 1] = float("-inf")
    got = kernels.staircase_select(sL, cL, sR, cR, eps, cap=130)
    torch.cuda.synchronize()
    assert int(got[3][0, 1]) == 0 and int(got[3][0, 0]) > 0
    assert bool((got[0][0, 1] == 0).all() and (got[1][0, 1] == 0).all())
    assert bool(torch.isneginf(got[2][0, 1]).all())
    assert_staircase_equal(got, sparse.staircase_select_ref(
        sL, cL, sR, cR, eps, cap=130))
