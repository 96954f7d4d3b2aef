"""ipk_tpu_torch.core.dense against ipk_tpu.core.dense / pallas_kernels.

The same seeded numpy inputs go through the JAX function (Pallas in
interpret mode, as conftest.py sets) and its PyTorch counterpart on the CPU.
Tolerance: none. The arithmetic is f32 add / max / compare, each exactly
rounded, so arrays and counts must be bit-equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipk_tpu.core import dense as jdense
from ipk_tpu.core.pallas_kernels import combine_max as pallas_combine_max
from ipk_tpu_torch.core import dense as tdense

torch.set_num_threads(2)


def make_inputs(rng, G, S, sigma=4):
    p = rng.dirichlet(np.ones(sigma) * 0.4, size=(G, S)).astype(np.float32)
    P = np.log10(np.maximum(p, 1e-30)).astype(np.float32)
    return P, jdense.best_score_prefix(P)


def eps_for(omega, sigma, k):
    return np.float32(np.log10((omega / sigma) ** k))


def jax_halves(P, prefix, eps, k, sigma):
    fn = jax.vmap(functools.partial(jdense.masked_halves, k=k, sigma=sigma),
                  in_axes=(0, 0, None))
    L, R = fn(jnp.asarray(P), jnp.asarray(prefix), eps)
    return np.asarray(L), np.asarray(R)


def torch_halves(P, prefix, eps, k, sigma):
    L, R = tdense.masked_halves(torch.from_numpy(P), torch.from_numpy(prefix),
                                torch.tensor(eps), k=k, sigma=sigma)
    return L.numpy(), R.numpy()


def test_best_score_prefix_matches():
    P, _ = make_inputs(np.random.default_rng(0), 3, 17)
    np.testing.assert_array_equal(tdense.best_score_prefix(P),
                                  jdense.best_score_prefix(P))


@pytest.mark.parametrize("k", [1, 2, 3, 5, 6])
def test_split_tree_matches(k):
    assert tdense.split_tree(k) == jdense.split_tree(k)


@pytest.mark.parametrize("sigma,k,omega", [
    (4, 1, 1.5), (4, 4, 1.5), (4, 6, 1.5), (4, 7, 1.2), (4, 8, 1.5),
    (20, 3, 4.0), (20, 4, 6.0)])
def test_masked_halves_bitequal(sigma, k, omega):
    rng = np.random.default_rng(100 + 10 * sigma + k)
    P, prefix = make_inputs(rng, 3, k + 13, sigma)
    eps = eps_for(omega, sigma, k)
    L_j, R_j = jax_halves(P, prefix, eps, k, sigma)
    L_t, R_t = torch_halves(P, prefix, eps, k, sigma)
    assert L_t.dtype == np.float32 and R_t.dtype == np.float32
    np.testing.assert_array_equal(L_t, L_j)
    np.testing.assert_array_equal(R_t, R_j)
    assert np.isfinite(L_t).any()   # the case exercises live candidates


def _combine_both(L, R, eps, block_w):
    """(A, counts) from the Pallas kernel (interpret) and from
    combine_max_jnp, both int64 counts."""
    A_p, c_p = pallas_combine_max(jnp.asarray(L), jnp.asarray(R), eps,
                                  block_w=block_w, with_count=True,
                                  interpret=True)
    A_j, c_j = jdense.combine_max_jnp(jnp.asarray(L), jnp.asarray(R), eps,
                                      block_w=block_w, with_count=True)
    return ((np.asarray(A_p), np.asarray(c_p).astype(np.int64)),
            (np.asarray(A_j), np.asarray(c_j).astype(np.int64)))


def _assert_combine_equal(L, R, eps, block_w):
    A_t, c_t = tdense.combine_max_ref(torch.from_numpy(L),
                                      torch.from_numpy(R), torch.tensor(eps))
    assert A_t.dtype == torch.float32 and c_t.dtype == torch.int64
    for A_ref, c_ref in _combine_both(L, R, eps, block_w):
        np.testing.assert_array_equal(A_t.numpy(), A_ref)
        np.testing.assert_array_equal(c_t.numpy(), c_ref)
    return A_t.numpy(), c_t.numpy()


@pytest.mark.parametrize("sigma,k,omega,S,block_w", [
    (4, 5, 1.5, 18, 8),     # W = 14: not a multiple of the window block
    (4, 6, 1.5, 42, 16),    # W = 37
    (4, 3, 1.5, 20, 8),     # nl = 4: below the 8-sublane tile
    (20, 3, 4.0, 12, 8),    # amino: nl = 20, nr = 400
    (20, 4, 6.0, 11, 4),    # amino k=4: nl = nr = 400
])
def test_combine_max_ref_on_halves(sigma, k, omega, S, block_w):
    rng = np.random.default_rng(7 * k + sigma)
    P, prefix = make_inputs(rng, 3, S, sigma)
    eps = eps_for(omega, sigma, k)
    L, R = torch_halves(P, prefix, eps, k, sigma)
    A, counts = _assert_combine_equal(L, R, eps, block_w)
    assert counts.sum() > 0 and np.isfinite(A).any()


def test_combine_max_ref_ragged_random():
    """Ragged nl / nr / W with plain normal halves (every cell live)."""
    rng = np.random.default_rng(9)
    G, W, nl, nr = 2, 13, 12, 20
    L = rng.normal(size=(G, W, nl)).astype(np.float32)
    R = rng.normal(size=(G, W, nr)).astype(np.float32)
    eps = np.float32(0.25)
    A, counts = _assert_combine_equal(L, R, eps, 8)
    T = L[:, :, :, None] + R[:, :, None, :]
    np.testing.assert_array_equal(counts, (T > eps).sum(axis=(1, 2, 3)))


def test_combine_max_ref_nr_blocked():
    """nl * nr above the Pallas kernel's 1 MB tile budget, so the reference
    grids over nr (as test_pallas.py's nr-blocking case)."""
    rng = np.random.default_rng(3)
    k, sigma = 10, 4
    P, prefix = make_inputs(rng, 2, 24, sigma)
    eps = eps_for(1.2, sigma, k)
    L, R = torch_halves(P, prefix, eps, k, sigma)
    _assert_combine_equal(L, R, eps, 8)


def test_combine_max_ref_window_chunks():
    """The window-chunked loop gives the same result at any chunk size."""
    rng = np.random.default_rng(11)
    P, prefix = make_inputs(rng, 4, 30, 4)
    eps = eps_for(1.5, 4, 6)
    L, R = (torch.from_numpy(x) for x in torch_halves(P, prefix, eps, 6, 4))
    A0, c0 = tdense.combine_max_ref(L, R, torch.tensor(eps))
    A1, c1 = tdense.combine_max_ref(L, R, torch.tensor(eps),
                                    budget_bytes=4 * 64 * 64 * 4 * 3)
    assert torch.equal(A0, A1) and torch.equal(c0, c1)


def _dense_accumulator(seed, B=5, K=48, ghosts=2, live=0.3):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B * ghosts, K)).astype(np.float32)
    A[rng.random(A.shape) > live] = -np.inf
    return A


@pytest.mark.parametrize("ghosts", [1, 2])
def test_group_max_matches(ghosts):
    A = _dense_accumulator(1, ghosts=ghosts)
    np.testing.assert_array_equal(
        tdense.group_max(torch.from_numpy(A), ghosts).numpy(),
        np.asarray(jdense.group_max(jnp.asarray(A), ghosts)))


# ---------------------------------------------------------------------------
# positions (--keep-positions): the earliest window of each cell's maximum
# ---------------------------------------------------------------------------

def _assert_positions_equal(L, R, eps, block_w):
    """combine_max_with_positions_ref against ipk_tpu's jnp function at the
    same block_w: A (bit patterns), pos and int64 counts equal."""
    A_j, p_j, c_j = jdense.combine_max_with_positions(
        jnp.asarray(L), jnp.asarray(R), eps, block_w=block_w,
        with_count=True)
    A_t, p_t, c_t = tdense.combine_max_with_positions_ref(
        torch.from_numpy(L), torch.from_numpy(R), torch.tensor(eps),
        block_w=block_w)
    assert A_t.dtype == torch.float32 and p_t.dtype == torch.int32
    assert c_t.dtype == torch.int64
    np.testing.assert_array_equal(A_t.numpy().view(np.uint32),
                                  np.asarray(A_j).view(np.uint32))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(c_t.numpy(),
                                  np.asarray(c_j).astype(np.int64))
    return A_t.numpy(), p_t.numpy(), c_t.numpy()


@pytest.mark.parametrize("block_w", [4, 16, 32])
@pytest.mark.parametrize("sigma,k,omega,S", [
    (4, 5, 1.5, 42),     # W = 38: a multiple of none of the blocks
    (20, 3, 4.0, 23),    # amino: W = 21
])
def test_positions_ref_on_halves(block_w, sigma, k, omega, S):
    rng = np.random.default_rng(5 * k + sigma + block_w)
    P, prefix = make_inputs(rng, 3, S, sigma)
    eps = eps_for(omega, sigma, k)
    L, R = torch_halves(P, prefix, eps, k, sigma)
    A, pos, counts = _assert_positions_equal(L, R, eps, block_w)
    W = S - k + 1
    live = np.isfinite(A)
    assert counts.sum() > 0 and live.any()
    assert (pos[~live] == 0).all() and pos.max() < W


@pytest.mark.parametrize("block_w", [4, 16, 32])
def test_positions_ref_ties_and_signed_zeros(block_w):
    """Rounded halves tie across windows, and zeros of both signs meet at a
    zero maximum: the earliest window wins, and A keeps the bits ipk_tpu's
    block max gives (the last tied window of the block)."""
    rng = np.random.default_rng(block_w)
    G, W, nl, nr = 2, 45, 12, 20
    # values <= 0, so many cells peak at a zero reached as -0.0 and +0.0
    L = -np.abs(np.round(rng.normal(size=(G, W, nl)), 0)).astype(np.float32)
    R = -np.abs(np.round(rng.normal(size=(G, W, nr)), 0)).astype(np.float32)
    L[rng.random(L.shape) < 0.4] = -0.0
    R[rng.random(R.shape) < 0.3] = -0.0
    R[rng.random(R.shape) < 0.2] = 0.0
    L[rng.random(L.shape) < 0.1] = -np.inf
    A, pos, _ = _assert_positions_equal(L, R, np.float32(-1.5), block_w)
    zero = A == 0
    assert zero.any() and np.signbit(A[zero]).any() \
        and (~np.signbit(A[zero])).any()


@pytest.mark.parametrize("block_w", [4, 32])
def test_positions_ref_constant_matrix(block_w):
    """Every window equal: each live position is window 0."""
    L = np.full((2, 37, 6), -0.75, np.float32)
    R = np.full((2, 37, 9), -0.5, np.float32)
    A, pos, counts = _assert_positions_equal(L, R, np.float32(-2.0), block_w)
    assert np.isfinite(A).all() and (pos == 0).all()
    assert (counts == 37 * 6 * 9).all()


def test_positions_ref_ghost_chunks():
    """The ghost-chunked loop gives the same result at any chunk size."""
    rng = np.random.default_rng(13)
    L = rng.normal(size=(5, 40, 8)).astype(np.float32)
    R = rng.normal(size=(5, 40, 16)).astype(np.float32)
    L, R, eps = torch.from_numpy(L), torch.from_numpy(R), torch.tensor(
        np.float32(0.5))
    full = tdense.combine_max_with_positions_ref(L, R, eps)
    small = tdense.combine_max_with_positions_ref(L, R, eps,
                                                  budget_bytes=64)
    for a, b in zip(full, small):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ghosts", [1, 2, 3])
def test_group_max_with_positions_matches(ghosts):
    rng = np.random.default_rng(20 + ghosts)
    A = np.round(_dense_accumulator(4, ghosts=ghosts, live=0.5), 0)
    A = A.astype(np.float32)       # rounded: ties across ghosts
    pos = rng.integers(0, 50, A.shape).astype(np.int32)
    A_t, p_t = tdense.group_max_with_positions(torch.from_numpy(A),
                                               torch.from_numpy(pos), ghosts)
    A_j, p_j = jdense.group_max_with_positions(jnp.asarray(A),
                                               jnp.asarray(pos), ghosts)
    np.testing.assert_array_equal(A_t.numpy(), np.asarray(A_j))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
