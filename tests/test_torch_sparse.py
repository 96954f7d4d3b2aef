"""ipk_tpu_torch.core.sparse against ipk_tpu.core.sparse / pallas_kernels.

The same seeded numpy inputs go through the JAX function (its XLA route, or
the Pallas staircase kernel in interpret mode) and the PyTorch counterpart on
the CPU. Tolerance: none. The arithmetic is f32 add / subtract / compare,
each exactly rounded, so values, slot order, totals and overflow flags must
be bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipk_tpu.core import dense as jdense
from ipk_tpu.core import sparse as jsparse
from ipk_tpu.core.pallas_kernels import staircase_select_wide
from ipk_tpu_torch.core import sparse as tsparse

torch.set_num_threads(2)


def make_inputs(rng, G, S, sigma=4, alpha=0.4):
    p = rng.dirichlet(np.ones(sigma) * alpha, size=(G, S)).astype(np.float32)
    P = np.log10(np.maximum(p, 1e-30)).astype(np.float32)
    return P, jdense.best_score_prefix(P)


def eps_for(omega, sigma, k):
    return np.float32(np.log10((omega / sigma) ** k))


# ---------------------------------------------------------------------------
# the copied numpy helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,sigma,cap", [(2, 4, 128), (6, 4, 4096),
                                         (12, 4, 4096), (13, 4, 512),
                                         (6, 20, 4096), (8, 20, 1000)])
def test_cap_plans_match(k, sigma, cap):
    assert tsparse.COMPLETE_LIMIT == jsparse.COMPLETE_LIMIT
    assert tsparse._spans(k) == jsparse._spans(k)
    for (j, h) in tsparse._spans(k):
        assert (tsparse._natural_size(j, h, sigma, {})
                == jsparse._natural_size(j, h, sigma, {}))
    dc = tsparse.default_caps(k, sigma, cap)
    assert dc == jsparse.default_caps(k, sigma, cap)
    ragged = {span: 100 + 37 * i for i, span in enumerate(tsparse._spans(k))}
    nc = tsparse.normalize_caps(ragged, k, sigma, cap)
    assert nc == jsparse.normalize_caps(ragged, k, sigma, cap)
    assert tsparse._caps_key(nc) == jsparse._caps_key(nc)


@pytest.mark.parametrize("k,sigma,omega,cap", [(6, 4, 1.5, 4096),
                                               (12, 4, 2.0, 4096),
                                               (6, 20, 4.0, 4096),
                                               (4, 4, 1e-6, 16)])
def test_probe_caps_matches(k, sigma, omega, cap):
    P, prefix = make_inputs(np.random.default_rng(k * sigma), 5, k + 30,
                            sigma)
    eps = eps_for(omega, sigma, k)
    got = tsparse.probe_caps(P, prefix, eps, k=k, sigma=sigma, cap=cap)
    assert got == jsparse.probe_caps(P, prefix, eps, k=k, sigma=sigma,
                                     cap=cap)


def test_pack_host_and_merge_window_lists_match():
    rng = np.random.default_rng(3)
    cl = rng.integers(0, 1 << 32, size=(2, 5, 40), dtype=np.uint64)
    cr = rng.integers(0, 1 << 32, size=(2, 5, 40), dtype=np.uint64)
    packed = tsparse._pack_host(cl.astype(np.int64), cr.astype(np.int64),
                                k=12, bits=2)
    np.testing.assert_array_equal(
        packed, jsparse._pack_host(cl.astype(np.uint32),
                                   cr.astype(np.uint32), k=12, bits=2))
    # duplicate codes across windows with different scores, -inf slots
    codes = rng.integers(0, 60, size=(3, 7, 20)).astype(np.uint64)
    scores = rng.uniform(-5, 0, size=codes.shape).astype(np.float32)
    scores[rng.random(codes.shape) < 0.3] = -np.inf
    for a, b in zip(tsparse.merge_window_lists(codes, scores),
                    jsparse.merge_window_lists(codes, scores)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("CL,CR,cap", [(4, 400, 256), (400, 20, 512),
                                       (300, 256, 1024), (300, 256, 512),
                                       (100, 128, 384), (64, 64, 256),
                                       (129, 130, 4096)])
def test_policy_matches(CL, CR, cap):
    assert tsparse._policy(CL, CR, cap) == jsparse._policy(CL, CR, cap)


# ---------------------------------------------------------------------------
# span primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sigma", [4, 20])
@pytest.mark.parametrize("k", list(range(2, 14)))
def test_span_eps_bitequal(sigma, k):
    P, prefix = make_inputs(np.random.default_rng(k), 2, k + 9, sigma)
    W = P.shape[1] - k + 1
    eps = eps_for(2.0 if sigma == 4 else 4.0, sigma, k)
    got = tsparse._span_eps(torch.from_numpy(prefix), k, W,
                            torch.tensor(eps))
    ref = jsparse._span_eps(jnp.asarray(prefix), k, W, jnp.float32(eps))
    assert set(got) == set(ref)
    for span in ref:
        assert got[span].dtype == torch.float32
        np.testing.assert_array_equal(got[span].numpy(),
                                      np.asarray(ref[span]), err_msg=span)


def sort_case(seed):
    """Rows with ties, ±0.0, -inf and codes with the sign bit set."""
    rng = np.random.default_rng(seed)
    G, W, C = 2, 3, 40
    scores = np.round(rng.uniform(-3, 0, (G, W, C)), 1).astype(np.float32)
    scores[..., ::7] = 0.0
    scores[..., 3::7] = -0.0
    scores[..., 5::9] = -np.inf
    codes = (rng.permutation(G * W * C).astype(np.uint64)
             * np.uint64(0x0F0F0F1)).astype(np.uint32).reshape(G, W, C)
    codes[..., ::4] |= np.uint32(0x80000000)
    return codes, scores


@pytest.mark.parametrize("seed", [0, 1])
def test_sort_desc_bitequal(seed):
    codes, scores = sort_case(seed)
    c_t, s_t = tsparse._sort_desc(torch.from_numpy(codes.astype(np.int64)),
                                  torch.from_numpy(scores))
    c_j, s_j = jsparse._sort_desc(jnp.asarray(codes), jnp.asarray(scores))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j).astype(
        np.int64))
    # bit patterns, so -0.0 and +0.0 are told apart
    np.testing.assert_array_equal(s_t.numpy().view(np.uint32),
                                  np.asarray(s_j).view(np.uint32))


# ---------------------------------------------------------------------------
# the staircase: plain version vs the Pallas kernel and the brute force
# ---------------------------------------------------------------------------

def brute_force_sorted(sL, cL, sR, cR, eps, cap, sort_l=True):
    """tests/test_staircase_kernels.py's reference: two-key sort (score
    desc, unsigned code asc) of R always, of L with ``sort_l``; surviving
    pairs row-major, padded with (-inf, 0)."""
    G, W, CL = sL.shape
    clu = np.zeros((G, W, cap), np.uint32)
    cru = np.zeros((G, W, cap), np.uint32)
    s_out = np.full((G, W, cap), -np.inf, np.float32)
    tot = np.zeros((G, W), np.int32)
    for g in range(G):
        for w in range(W):
            ol = (np.lexsort((cL[g, w], -sL[g, w])) if sort_l
                  else np.arange(CL))
            orr = np.lexsort((cR[g, w], -sR[g, w]))
            T = sL[g, w][ol][:, None] + sR[g, w][orr][None, :]
            ii, jj = np.nonzero(T > eps[g, w])
            take = min(len(ii), cap)
            tot[g, w] = len(ii)
            s_out[g, w, :take] = T[ii[:take], jj[:take]]
            clu[g, w, :take] = cL[g, w, ol][ii[:take]]
            cru[g, w, :take] = cR[g, w, orr][jj[:take]]
    return clu, cru, s_out, tot


def staircase_case(G, W, CL, CR, seed):
    rng = np.random.default_rng(seed)
    sL = rng.uniform(-6, 0, (G, W, CL)).astype(np.float32)
    sR = rng.uniform(-6, 0, (G, W, CR)).astype(np.float32)
    sL[:, :, ::3] = np.round(sL[:, :, ::3], 1)     # ties: the code decides
    sR[:, :, ::2] = np.round(sR[:, :, ::2], 1)
    cL = rng.permutation(CL * W * G).astype(np.uint32).reshape(G, W, CL)
    cR = rng.permutation(CR * W * G).astype(np.uint32).reshape(G, W, CR)
    eps = rng.uniform(-4.5, -4.0, (G, W)).astype(np.float32)
    return sL, cL, sR, cR, eps


def torch_staircase(sL, cL, sR, cR, eps, cap, sort_l=True):
    out = tsparse.staircase_select_ref(
        torch.from_numpy(sL), torch.from_numpy(cL.astype(np.int64)),
        torch.from_numpy(sR), torch.from_numpy(cR.astype(np.int64)),
        torch.from_numpy(eps), cap=cap, sort_l=sort_l)
    cl, cr, s, tot = (t.numpy() for t in out)
    assert cl.dtype == np.int64 and s.dtype == np.float32
    assert tot.dtype == np.int32
    assert cl.min(initial=0) >= 0 and cl.max(initial=0) < (1 << 32)
    return cl.astype(np.uint32), cr.astype(np.uint32), s, tot


def assert_same(got, ref, bits=True):
    """Equal arrays; scores compared by bit pattern (``bits``) or by value.
    ipk_tpu's staircase emits a -0.0 sum as +0.0 (its extraction is a masked
    sum from +0.0) and the port does so too; the brute force keeps -0.0, so
    it is compared by value, where -0.0 == +0.0."""
    for name, a, b in zip(("cl", "cr", "scores", "totals"), got, ref):
        b = np.asarray(b)
        if name == "scores" and bits:
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("sort_l", [True, False])
@pytest.mark.parametrize("G,W,CL,CR,cap", [
    (1, 5, 20, 33, 128),      # tiny, unaligned widths
    (2, 9, 130, 200, 256),    # multi-tile L, cap < survivors possible
    (1, 3, 300, 40, 384),     # wide L, narrow R
])
def test_staircase_ref_matches_pallas_and_brute_force(G, W, CL, CR, cap,
                                                      sort_l):
    args = staircase_case(G, W, CL, CR, G * 100 + CL)
    got = torch_staircase(*args, cap, sort_l=sort_l)
    assert_same(got, brute_force_sorted(*args, cap, sort_l=sort_l),
                bits=False)
    sL, cL, sR, cR, eps = args
    assert_same(got, staircase_select_wide(
        jnp.asarray(sL), jnp.asarray(cL), jnp.asarray(sR), jnp.asarray(cR),
        jnp.asarray(eps), cap=cap, sort_l=sort_l, interpret=True))


def test_staircase_ref_sign_bit_codes_and_signed_zeros():
    """All-tied scores, half of them -0.0: the order is decided by the codes
    alone, compared as unsigned 32-bit."""
    G, W, CL, CR, cap = 1, 2, 8, 8, 128
    rng = np.random.default_rng(0)
    sL = np.zeros((G, W, CL), np.float32)
    sR = np.zeros((G, W, CR), np.float32)
    sL[..., ::2] = -0.0
    sR[..., 1::2] = -0.0
    cL = (rng.permutation(CL).astype(np.uint32) * np.uint32(0x20000001)
          ).reshape(G, 1, CL).repeat(W, axis=1)
    cR = (rng.permutation(CR).astype(np.uint32) * np.uint32(0x30000001)
          ).reshape(G, 1, CR).repeat(W, axis=1)
    eps = np.full((G, W), -1.0, np.float32)
    got = torch_staircase(sL, cL, sR, cR, eps, cap)
    assert_same(got, staircase_select_wide(
        jnp.asarray(sL), jnp.asarray(cL), jnp.asarray(sR), jnp.asarray(cR),
        jnp.asarray(eps), cap=cap, interpret=True))
    assert_same(got, brute_force_sorted(sL, cL, sR, cR, eps, cap),
                bits=False)


def test_staircase_ref_overflow_totals():
    """totals report the true survivor count past cap; the cap slots fill."""
    G, W, CL, CR, cap = 1, 4, 40, 40, 128
    rng = np.random.default_rng(3)
    sL = rng.uniform(-1, 0, (G, W, CL)).astype(np.float32)
    sR = rng.uniform(-1, 0, (G, W, CR)).astype(np.float32)
    cL = np.arange(G * W * CL, dtype=np.uint32).reshape(G, W, CL)
    cR = np.arange(G * W * CR, dtype=np.uint32).reshape(G, W, CR)
    eps = np.full((G, W), -100.0, np.float32)   # everything survives
    got = torch_staircase(sL, cL, sR, cR, eps, cap)
    assert (got[3] == CL * CR).all() and np.isfinite(got[2]).all()
    assert_same(got, brute_force_sorted(sL, cL, sR, cR, eps, cap),
                bits=False)


def test_staircase_ref_chunked_loops():
    """The plain version's chunked count and emission loops give the same
    result at any chunk size."""
    args = staircase_case(2, 9, 130, 200, 7)
    ref = torch_staircase(*args, 300)
    old = tsparse._CHUNK_ELEMS
    try:
        tsparse._CHUNK_ELEMS = 500
        assert_same(torch_staircase(*args, 300), ref)
    finally:
        tsparse._CHUNK_ELEMS = old


@pytest.mark.parametrize("CL,CR,cap", [(100, 100, 8320), (8200, 16, 256)],
                         ids=["wide_cap", "wide_list"])
def test_staircase_wide_matches_ipk_tpu_xla(CL, CR, cap):
    """A cap or a list above 8192: the wrapper (the plain version on the CPU)
    returns the lists of the route ipk_tpu takes for such shapes,
    ``_sort_desc`` + ``_staircase_xla``, and of the brute force."""
    from ipk_tpu_torch.core import kernels
    sL, cL, sR, cR, eps = staircase_case(1, 2, CL, CR, CL + cap)
    out = kernels.staircase_select(
        torch.from_numpy(sL), torch.from_numpy(cL.astype(np.int64)),
        torch.from_numpy(sR), torch.from_numpy(cR.astype(np.int64)),
        torch.from_numpy(eps), cap=cap)
    got = tuple(t.numpy() for t in out)
    got = (got[0].astype(np.uint32), got[1].astype(np.uint32)) + got[2:]
    a_c, a_s = jsparse._sort_desc(jnp.asarray(cL), jnp.asarray(sL))
    b_c, b_s = jsparse._sort_desc(jnp.asarray(cR), jnp.asarray(sR))
    (ag, bg), s, tot = jsparse._staircase_xla(
        a_c, a_s, b_c, b_s, jnp.asarray(eps), cap=cap, shift=None)
    assert s.shape[2] == min(cap, CL * CR) == cap
    assert_same(got, (ag, bg, s, tot))
    assert_same(got, brute_force_sorted(sL, cL, sR, cR, eps, cap),
                bits=False)
    assert got[3].min() > 0


# ---------------------------------------------------------------------------
# the whole enumeration against ipk_tpu's XLA route
# ---------------------------------------------------------------------------

def assert_enumeration_equal(P, prefix, eps, **kw):
    c_j, s_j, o_j = jsparse.enumerate_sparse_many(P, prefix, eps,
                                                  use_kernel=False, **kw)
    stats = {}
    c_t, s_t, o_t = tsparse.enumerate_sparse_many(P, prefix, eps,
                                                  device="cpu", stats=stats,
                                                  **kw)
    assert c_t.dtype == np.uint64 and s_t.dtype == np.float32
    np.testing.assert_array_equal(c_t, c_j)
    np.testing.assert_array_equal(s_t.view(np.uint32), s_j.view(np.uint32))
    np.testing.assert_array_equal(o_t, o_j)
    return c_t, s_t, o_t, stats


@pytest.mark.parametrize("k,sigma,bits,cap,omega", [
    (6, 4, 2, 512, 1.5),
    (7, 4, 2, 4096, 1.5),
    (6, 20, 5, 4096, 4.0),
])
def test_enumerate_sparse_many_bitequal(k, sigma, bits, cap, omega):
    P, prefix = make_inputs(np.random.default_rng(k + sigma), 3, 26, sigma)
    _, s, o, stats = assert_enumeration_equal(
        P, prefix, eps_for(omega, sigma, k), k=k, sigma=sigma, bits=bits,
        cap=cap)
    assert np.isfinite(s).sum() > 0 and not o.any()
    assert stats["final_caps"] == tsparse.normalize_caps(
        stats["final_caps"], k, sigma, cap)


def test_enumerate_sparse_many_chunked_default_caps():
    """Several ghost chunks from default caps: each chunk's first run uses
    the starting caps and re-runs use the grown ones, as in ipk_tpu, so the
    padded widths agree too."""
    k, sigma, bits, cap = 6, 4, 2, 4096
    P, prefix = make_inputs(np.random.default_rng(2), 5, 30, sigma)
    assert_enumeration_equal(P, prefix, eps_for(1.2, sigma, k), k=k,
                             sigma=sigma, bits=bits, cap=cap, probe=False,
                             combine_budget_bytes=25 * 256 * 48 * 2)


def test_enumerate_sparse_many_probe_miss_redispatch():
    """tests/test_sparse.py's hot window the probe never samples: the caps
    double, the chunk re-runs, and the result still matches."""
    k, sigma, bits, cap = 6, 4, 2, 4096
    G, S = 4, 200
    P = np.full((G, S, sigma), np.log10(0.01), np.float32)
    P[:, :, 0] = np.log10(np.float32(0.97))
    P[3, 40:48, :] = np.log10(np.float32(0.005))
    P[3, 40:48, :3] = np.log10(np.float32(0.33))
    prefix = jdense.best_score_prefix(P)
    eps = np.float32(np.log10((1.0 / sigma) ** k))
    caps = jsparse.probe_caps(P, prefix, eps, k=k, sigma=sigma, cap=cap)
    _, s, o, stats = assert_enumeration_equal(P, prefix, eps, k=k,
                                              sigma=sigma, bits=bits,
                                              cap=cap, caps=caps)
    assert not o.any() and np.isfinite(s).sum(axis=2)[3].max() >= 729
    assert stats["redispatches"] >= 1


def test_enumerate_sparse_many_ceiling_overflow():
    """Everything survives and the ceiling is too small: the overflow flags
    come back set, as in ipk_tpu."""
    P, prefix = make_inputs(np.random.default_rng(0), 2, 16)
    _, _, o, _ = assert_enumeration_equal(
        P, prefix, eps_for(1e-6, 4, 4), k=4, sigma=4, bits=2, cap=16)
    assert o.all()


def test_enumerate_sparse_rejects_over_wide_half_windows():
    P = np.zeros((1, 20, 20), np.float32)
    with pytest.raises(ValueError, match="half-window code budget"):
        tsparse.enumerate_sparse_many(P, jdense.best_score_prefix(P),
                                      np.float32(-1), k=13, sigma=20, bits=5,
                                      cap=128, device="cpu")


def test_enumerate_sparse_single_ghost():
    P, prefix = make_inputs(np.random.default_rng(4), 1, 24)
    eps = eps_for(1.5, 4, 6)
    got = tsparse.enumerate_sparse(P[0], prefix[0], eps, k=6, sigma=4,
                                   bits=2, cap=4096, device="cpu")
    ref = jsparse.enumerate_sparse(P[0], prefix[0], eps, k=6, sigma=4,
                                   bits=2, cap=4096, use_kernel=False)
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(a, b)
    assert got[2] == ref[2]


def test_enumerate_sparse_many_top_cap_above_8192():
    """DNA k=12 with the top span's cap forced to 9216 under a ceiling of
    16384 (its natural size with (0,6) = (6,6) = 128): bit-equal to
    ipk_tpu, whose XLA route takes such caps."""
    k, sigma, bits, cap = 12, 4, 2, 16384
    P, prefix = make_inputs(np.random.default_rng(12), 2, k + 3, sigma)
    caps = tsparse.normalize_caps({(0, 6): 128, (6, 6): 128, (0, 12): 9216},
                                  k, sigma, cap)
    assert caps == jsparse.normalize_caps(caps, k, sigma, cap)
    _, s, o, stats = assert_enumeration_equal(
        P, prefix, eps_for(2.0, sigma, k), k=k, sigma=sigma, bits=bits,
        cap=cap, caps=caps)
    assert stats["final_caps"][(0, 12)] > 8192 and s.shape[2] > 8192
    assert np.isfinite(s).sum() > 0 and not o.any()
