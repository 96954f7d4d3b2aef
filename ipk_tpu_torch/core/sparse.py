"""Capacity-bounded sparse enumeration for large k, in PyTorch: the
counterpart of ``ipk_tpu/core/sparse.py``.

Where σ^k is too large to score every candidate (DNA k ≥ 12, AA k ≥ 6), each
span of the DCLA split tree keeps a survivor list of at most ``caps[span]``
entries per window. A host probe (:func:`probe_caps`) sizes the caps from a
few sampled windows; a span that overflows its cap on the device is doubled
and the chunk re-run, up to the user ceiling ``cap``, where the build fails
loudly instead of dropping k-mers.

Per span the children combine as a *staircase*: with the right operand
sorted by (score desc, unsigned code asc) the surviving j of each row i are
a prefix, so per-row counts describe the survivors completely. The combine
and select is the ``staircase_select`` CUDA kernel on the GPU
(``core.kernels``) and :func:`staircase_select_ref` on the CPU; both emit the
same values, slot order and totals as ``ipk_tpu``'s Pallas kernel and XLA
route.

What must stay exactly as in ``ipk_tpu`` for bit-equal results:

* the f32 eps chain ``eps_child = parent - range_max`` with eps an f32
  tensor, the summation tree, strict ``>``;
* ``_policy`` (which operand is sorted, whether L is sorted too): it decides
  the slot order of every list;
* the cap schedule: the probe, ``normalize_caps`` and the doubling rule.

Codes are int64 on the device (each half-window code needs at most 32 bits,
and torch has no shift or compare on uint32); the host packs the final
(prefix, suffix) pairs into uint64 keys (:func:`_pack_host`).

With a mesh (``parallel.mesh``), the ghost rows of a dispatch are padded to
the branch axis and each rank enumerates its contiguous slice; the overflow
flags are OR-ed over the ranks, so every rank grows the same caps, and the
settled lists are gathered onto every rank (:func:`resolve_overflow`), or
stay where they are for the device key merge (``parallel.key_merge``).

Not ported: the TPU-tuned ``GROUP_SPANS`` and ``SORT_WINDOWS`` knobs and the
``IPK_TPU_SPARSE_KERNEL`` override.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as device_mod
from ..spans import Recorder
from .dense import NEG_INF, split_tree

__all__ = ["enumerate_sparse", "enumerate_sparse_many", "merge_window_lists",
           "enumerate_pairs_deferred", "resolve_overflow", "probe_caps",
           "default_caps", "normalize_caps", "staircase_select_ref",
           "COMPLETE_LIMIT"]

#: spans with σ^h at or below this stay complete (no selection, no overflow)
COMPLETE_LIMIT = 256

#: elements of one temporary in the plain staircase (chunked above this)
_CHUNK_ELEMS = 1 << 26


# ---------------------------------------------------------------------------
# capacity plans (numpy, as in ipk_tpu)
# ---------------------------------------------------------------------------

def _spans(k: int) -> List[Tuple[int, int]]:
    """Non-leaf spans of the split tree, children before parents (top last)."""
    return [(j, h) for (j, h) in split_tree(k) if h > 1]


def _natural_size(j: int, h: int, sigma: int,
                  caps: Dict[Tuple[int, int], int]) -> int:
    """List size of span (j, h) given the caps of its children."""
    if h == 1:
        return sigma
    hl = h // 2
    cl = caps.get((j, hl), _natural_size(j, hl, sigma, caps))
    cr = caps.get((j + hl, h - hl),
                  _natural_size(j + hl, h - hl, sigma, caps))
    return cl * cr


def default_caps(k: int, sigma: int, cap: int,
                 initial: int = 256) -> Dict[Tuple[int, int], int]:
    """Conservative starting capacities: complete below COMPLETE_LIMIT,
    ``initial`` (≤ cap) elsewhere."""
    caps: Dict[Tuple[int, int], int] = {}
    for (j, h) in _spans(k):
        size = _natural_size(j, h, sigma, caps)
        caps[(j, h)] = size if size <= COMPLETE_LIMIT else min(cap, max(
            128, initial))
    return caps


def normalize_caps(caps: Dict[Tuple[int, int], int], k: int, sigma: int,
                   cap: int) -> Dict[Tuple[int, int], int]:
    """Clamp caps to natural sizes / ceiling and snap to 128 multiples."""
    out: Dict[Tuple[int, int], int] = {}
    for (j, h) in _spans(k):
        natural = _natural_size(j, h, sigma, out)
        c = caps.get((j, h), natural)
        if natural <= COMPLETE_LIMIT and natural <= cap:
            out[(j, h)] = natural
        else:
            c = min(max(c, 128), cap, natural)
            out[(j, h)] = min(natural, cap, -(-c // 128) * 128)
    return out


def _caps_key(caps: Dict[Tuple[int, int], int]) -> tuple:
    return tuple(sorted(caps.items()))


def probe_caps(P_all: np.ndarray, prefix_all: np.ndarray, log_threshold,
               *, k: int, sigma: int, cap: int, max_ghosts: int = 4,
               max_windows: int = 12, margin: float = 2.0,
               ) -> Dict[Tuple[int, int], int]:
    """Sample a few (ghost, window) pairs, run the exact survivor recursion
    on variable-length numpy lists, and derive per-span capacities (max
    observed count × margin, snapped up to a multiple of 128).

    The probe is exact on the sampled windows (same f32 eps chains and
    summation tree as the device code); unsampled windows may still overflow,
    which the device path detects per span and repairs by doubling.
    """
    P_all = np.asarray(P_all, dtype=np.float32)
    prefix_all = np.asarray(prefix_all, dtype=np.float32)
    G, S = P_all.shape[0], P_all.shape[1]
    W = S - k + 1
    maxima: Dict[Tuple[int, int], int] = {}
    if W <= 0 or G == 0:
        return normalize_caps(maxima, k, sigma, cap)
    g_idx = np.unique(np.linspace(0, G - 1, min(G, max_ghosts)).astype(int))
    w_idx = np.unique(np.linspace(0, W - 1, min(W, max_windows)).astype(int))

    for g in g_idx:
        P = P_all[g]
        prefix = prefix_all[g]
        for w in w_idx:
            def rng_max(s: int, l: int) -> np.float32:
                return np.float32(prefix[w + s + l] - prefix[w + s])

            def lists(j: int, h: int, eps: np.float32) -> np.ndarray:
                if h == 1:
                    col = P[w + j]
                    return col[col > eps]
                hl = h // 2
                hr = h - hl
                eps_l = np.float32(eps - rng_max(j + hl, hr))
                eps_r = np.float32(eps - rng_max(j, hl))
                a = lists(j, hl, eps_l)
                b = lists(j + hl, hr, eps_r)
                if a.size * b.size > (1 << 24):
                    # pathological window: record the ceiling and truncate
                    maxima[(j, h)] = max(maxima.get((j, h), 0), cap)
                    a = np.sort(a)[::-1][:4096]
                    b = np.sort(b)[::-1][:4096]
                s = (a[:, None] + b[None, :]).ravel()
                s = s[s > eps]
                maxima[(j, h)] = max(maxima.get((j, h), 0), s.size)
                return s

            lists(0, k, np.float32(log_threshold))

    caps = {span: max(128, int(-(-int(n * margin) // 128) * 128))
            for span, n in maxima.items()}
    return normalize_caps(caps, k, sigma, cap)


# ---------------------------------------------------------------------------
# span primitives (batched over [G, W, ...])
# ---------------------------------------------------------------------------

def _span_eps(prefix_all: torch.Tensor, k: int, W: int,
              log_threshold: torch.Tensor
              ) -> Dict[Tuple[int, int], torch.Tensor]:
    """Per-span per-window pruning thresholds [G, W] f32, by the reference's
    exact f32 subtraction chain (``pk_compute.cpp:54-55``). log_threshold is
    a 0-d f32 tensor."""
    G = prefix_all.shape[0]
    eps: Dict[Tuple[int, int], torch.Tensor] = {
        (0, k): log_threshold.to(torch.float32).expand(G, W)}

    def range_max(s: int, l: int) -> torch.Tensor:
        return prefix_all[:, s + l:s + l + W] - prefix_all[:, s:s + W]

    def descend(j: int, h: int) -> None:
        if h <= 1:
            return
        hl = h // 2
        hr = h - hl
        parent = eps[(j, h)]
        eps[(j, hl)] = parent - range_max(j + hl, hr)
        eps[(j + hl, hr)] = parent - range_max(j, hl)
        descend(j, hl)
        descend(j + hl, hr)

    descend(0, k)
    return eps


def _sort_desc(codes: torch.Tensor, scores: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort each row's (code, score) pairs by (score desc, code asc), codes
    compared as unsigned 32-bit (they are int64 in [0, 2^32)); pruned -inf
    slots sink to the end. Values are untouched.

    One int64 key per pair: the score mapped to an order-preserving 32-bit
    integer (negated for descending) above the code. ``+ 0.0`` turns -0.0
    into +0.0 in the key only, so ±0.0 tie and the code decides, as
    ``jax.lax.sort`` orders them."""
    v = (scores + 0.0).view(torch.int32).to(torch.int64)
    # ascending in the float: negatives flip, non-negatives move above them
    asc = torch.where(v < 0, -1 - v, v + (1 << 31))
    desc = ((1 << 32) - 1) - asc
    key = (desc - (1 << 31)) * (1 << 32) + codes      # fits int64 exactly
    order = torch.argsort(key, dim=-1, stable=True)
    return (torch.gather(codes, -1, order), torch.gather(scores, -1, order))


def _complete_product(cl, sl, cr, sr, eps, shift):
    """Materialize the full child product (CL·CR ≤ cap): no selection."""
    G, W, CL = sl.shape
    CR = sr.shape[2]
    scores = (sl[:, :, :, None] + sr[:, :, None, :]).reshape(G, W, CL * CR)
    scores = torch.where(scores > eps[:, :, None], scores, NEG_INF)
    if shift is None:
        clg = cl[:, :, :, None].expand(G, W, CL, CR).reshape(G, W, -1)
        crg = cr[:, :, None, :].expand(G, W, CL, CR).reshape(G, W, -1)
        return (clg, crg), scores
    codes = ((cl[:, :, :, None] << shift) | cr[:, :, None, :]
             ).reshape(G, W, CL * CR)
    return codes, scores


def staircase_select_ref(sL: torch.Tensor, cL: torch.Tensor,
                         sR: torch.Tensor, cR: torch.Tensor,
                         eps: torch.Tensor, *, cap: int, sort_l: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Plain version of the ``staircase_select`` kernel (the counterpart of
    ``pallas_kernels.staircase_select_wide`` and of ``_sort_desc`` +
    ``_staircase_xla`` in ``ipk_tpu``).

    sL/cL: [G, W, CL] f32 scores / int64 codes, sR/cR: [G, W, CR] likewise,
    in any order; eps: [G, W] f32. Sorts R (and L with ``sort_l``) by
    (score desc, unsigned code asc), counts per row
    ``#{j : fl(sL[i] + sR[j]) > eps}`` (a prefix of sorted R), and emits the
    survivors row-major (i asc, j asc) into ``cap`` slots, each score
    ``fl(fl(sL[i] + sR[j]) + 0.0)`` (a -0.0 sum is emitted as +0.0, as
    ``ipk_tpu``'s extraction by masked sums does). Returns
    (code_l, code_r [G, W, cap] int64, scores [G, W, cap] f32,
    totals [G, W] int32); slots at or beyond a window's total are
    (-inf, 0, 0), and totals above ``cap`` mean the window overflowed.
    """
    G, W, CL = sL.shape
    CR = sR.shape[2]
    N = G * W
    if sort_l:
        cL, sL = _sort_desc(cL, sL)
    cR, sR = _sort_desc(cR, sR)
    sL, cL = sL.reshape(N, CL), cL.reshape(N, CL)
    sR, cR = sR.reshape(N, CR), cR.reshape(N, CR)
    epsf = eps.reshape(N).to(torch.float32)
    dev = sL.device

    # exact per-row survivor counts, summed over every j
    cnt = torch.empty((N, CL), dtype=torch.int32, device=dev)
    nb = max(1, min(N, _CHUNK_ELEMS // max(1, CL * CR)))
    cb = max(1, min(CL, _CHUNK_ELEMS // max(1, nb * CR)))
    for n0 in range(0, N, nb):
        for c0 in range(0, CL, cb):
            part = (sL[n0:n0 + nb, c0:c0 + cb, None]
                    + sR[n0:n0 + nb, None, :]) > epsf[n0:n0 + nb, None, None]
            cnt[n0:n0 + nb, c0:c0 + cb] = part.sum(dim=2, dtype=torch.int32)
    incl = torch.cumsum(cnt, dim=1, dtype=torch.int32)          # [N, CL]
    excl = incl - cnt
    total = (incl[:, -1] if CL else
             torch.zeros(N, dtype=torch.int32, device=dev))

    out_cl = torch.empty((N, cap), dtype=torch.int64, device=dev)
    out_cr = torch.empty((N, cap), dtype=torch.int64, device=dev)
    out_s = torch.empty((N, cap), dtype=torch.float32, device=dev)
    tb = max(1, min(N, _CHUNK_ELEMS // max(1, cap)))
    t = torch.arange(cap, dtype=torch.int32, device=dev)
    for n0 in range(0, N, tb):
        n1 = min(N, n0 + tb)
        tt = t.expand(n1 - n0, cap).contiguous()
        # slot t lies in the first row whose inclusive offset exceeds t
        i = torch.searchsorted(incl[n0:n1], tt, right=True)
        valid = tt < total[n0:n1, None]
        i = i.clamp_(max=max(CL - 1, 0))
        j = (tt - torch.gather(excl[n0:n1], 1, i)).to(torch.int64)
        j = j.clamp_(0, max(CR - 1, 0))
        # + 0.0: a -0.0 sum leaves as +0.0, as ipk_tpu's masked-sum
        # extraction emits it; every other value is unchanged
        s = (torch.gather(sL[n0:n1], 1, i) + torch.gather(sR[n0:n1], 1, j)
             ) + 0.0
        out_s[n0:n1] = torch.where(valid, s, NEG_INF)
        out_cl[n0:n1] = torch.where(valid, torch.gather(cL[n0:n1], 1, i), 0)
        out_cr[n0:n1] = torch.where(valid, torch.gather(cR[n0:n1], 1, j), 0)
    return (out_cl.reshape(G, W, cap), out_cr.reshape(G, W, cap),
            out_s.reshape(G, W, cap), total.reshape(G, W))


def _policy(CL: int, CR: int, cap: int) -> Tuple[bool, bool]:
    """(swap, sort_l) for a staircase of child widths (CL, CR) and output
    capacity cap, exactly as ``ipk_tpu`` chooses them (tuned there on a TPU):
    ``swap`` exchanges the operands (L := right child, sorted operand := left
    child); ``sort_l`` sorts the L operand too. Both decide the slot order,
    so they stay as they are for bit-equal lists."""
    big, small = max(CL, CR), min(CL, CR)
    if small * 4 <= big:
        return CL > CR, True
    swap = CR > CL
    sort_l = cap > 512 or big <= 128
    return swap, sort_l


def _combine_group(lists, span, eps, *, bits: int,
                   caps: Dict[Tuple[int, int], int], use_kernel: bool,
                   k: int):
    """Build one span's survivor list from its children. Returns
    (codes-or-pair, scores, overflow [G])."""
    j, h = span
    hl = h // 2
    hr = h - hl
    (cl, sl, ovl), (cr, sr, ovr) = lists[(j, hl)], lists[(j + hl, hr)]
    CL, CR = sl.shape[2], sr.shape[2]
    out_cap = caps[span]
    child_ovf = ovl | ovr

    if CL * CR <= out_cap:
        shift = None if span == (0, k) else bits * hr
        codes, scores = _complete_product(cl, sl, cr, sr, eps[span], shift)
        return codes, scores, child_ovf

    swap, sort_l = _policy(CL, CR, out_cap)
    a_c, a_s, b_c, b_s = (cr, sr, cl, sl) if swap else (cl, sl, cr, sr)
    if use_kernel:
        from .kernels import staircase_select as select
    else:
        select = staircase_select_ref
    ag, bg, scores, totals = select(
        a_s.contiguous(), a_c.contiguous(), b_s.contiguous(),
        b_c.contiguous(), eps[span].contiguous(), cap=out_cap,
        sort_l=sort_l)
    ovf = (totals > out_cap).any(dim=1)
    clg, crg = (bg, ag) if swap else (ag, bg)
    if span == (0, k):
        codes = (clg, crg)
    else:
        codes = (clg << (bits * hr)) | crg
    return codes, scores, child_ovf | ovf


def _span_levels(k: int) -> Dict[int, List[Tuple[int, int]]]:
    """Non-leaf spans by their height in the split tree (leaves are 0), each
    level in ``_spans`` order."""
    levels: Dict[Tuple[int, int], int] = {}

    def level(j: int, h: int) -> int:
        if (j, h) not in levels:
            hl = h // 2
            levels[(j, h)] = (0 if h == 1 else
                              1 + max(level(j, hl), level(j + hl, h - hl)))
        return levels[(j, h)]

    level(0, k)
    by_level: Dict[int, List[Tuple[int, int]]] = {}
    for span in _spans(k):
        by_level.setdefault(levels[span], []).append(span)
    return by_level


def _pairs_device(P_all: torch.Tensor, prefix_all: torch.Tensor,
                  log_threshold: torch.Tensor, *, k: int, sigma: int,
                  bits: int, caps: Dict[Tuple[int, int], int],
                  use_kernel: bool):
    """Whole-batch device enumeration for one caps plan.

    P_all: [G, S, sigma] f32, prefix_all: [G, S+1] f32, log_threshold: 0-d
    f32, all on one device. Returns (cl_sel, cr_sel [G, W, C] int64,
    scores [G, W, C] f32, ovf_spans [n_spans] bool in ``_spans(k)`` order,
    ovf_ghosts [G] bool) where a survivor's packed key is
    ``cl << (bits·(k - k//2)) | cr`` (``pk_compute.cpp:96-105``). Spans are
    combined level by level up the split tree.
    """
    G, S = P_all.shape[0], P_all.shape[1]
    W = S - k + 1
    dev = P_all.device
    eps = _span_eps(prefix_all, k, W, log_threshold)
    leaf_codes = torch.arange(sigma, dtype=torch.int64, device=dev).expand(
        G, W, sigma)
    no_ovf = torch.zeros((G,), dtype=torch.bool, device=dev)

    def leaf(j: int):
        T = P_all[:, j:j + W, :]
        return torch.where(T > eps[(j, 1)][:, :, None], T, NEG_INF)

    if k == 1:
        return (torch.zeros_like(leaf_codes), leaf_codes, leaf(0),
                torch.zeros((1,), dtype=torch.bool, device=dev), no_ovf)

    lists: Dict[Tuple[int, int], tuple] = {
        (j, h): (leaf_codes, leaf(j), no_ovf)
        for (j, h) in split_tree(k) if h == 1}
    overflow: Dict[Tuple[int, int], torch.Tensor] = {}
    for _, spans in sorted(_span_levels(k).items()):
        for span in spans:
            codes, scores, ovf = _combine_group(
                lists, span, eps, bits=bits, caps=caps,
                use_kernel=use_kernel, k=k)
            overflow[span] = ovf
            if span == (0, k):
                cl_sel, cr_sel = codes
                ovf_spans = torch.stack(
                    [overflow[s].any() for s in _spans(k)])
                ovf_ghosts = torch.stack(list(overflow.values())).any(dim=0)
                return cl_sel, cr_sel, scores, ovf_spans, ovf_ghosts
            # per-span flags live in `overflow` only; descendants must not
            # leak into an ancestor's flag (caps double per flagged span)
            lists[span] = (codes, scores, no_ovf)
    raise AssertionError("unreachable")  # pragma: no cover


def enumerate_pairs_deferred(P_all, prefix_all, log_threshold, *, k: int,
                             sigma: int, bits: int, caps: Dict,
                             use_kernel: Optional[bool] = None, mesh=None,
                             device: device_mod.DeviceLike = "cuda"):
    """Dispatch one whole-batch enumeration of the ghost rows (numpy P_all
    [G, S, σ], prefix_all [G, S+1]) without reading its overflow flags
    (``ipk_tpu``'s ``enumerate_pairs_deferred``). With ``mesh`` the rows are
    padded to a multiple of its branch axis and this rank enumerates its
    contiguous slice on ``mesh.device``. Returns the pending handle
    (G, this rank's ``_pairs_device`` output) for :func:`resolve_overflow`.
    """
    G0 = P_all.shape[0]
    if mesh is not None:
        from ..parallel.build_sharded import pad_ghosts
        P_all, prefix_all, _ = pad_ghosts(
            np.asarray(P_all, np.float32), np.asarray(prefix_all, np.float32),
            mesh.size("branch"))
        P_all, prefix_all = mesh.local_rows(P_all), mesh.local_rows(prefix_all)
        dev = mesh.device
    else:
        dev = device_mod.resolve(device)
    P = torch.from_numpy(np.ascontiguousarray(P_all, np.float32)).to(dev)
    prefix = torch.from_numpy(
        np.ascontiguousarray(prefix_all, np.float32)).to(dev)
    thr = torch.tensor(np.float32(log_threshold), dtype=torch.float32,
                       device=dev)
    return G0, _pairs_device(P, prefix, thr, k=k, sigma=sigma, bits=bits,
                             caps=caps, use_kernel=use_kernel is None
                             or bool(use_kernel))


def resolve_overflow(pend, *, k: int, sigma: int, cap: int, caps: Dict,
                     mesh=None, gather: bool = True):
    """Settle one enumeration (``ipk_tpu``'s ``resolve_deferred``): one small
    host read of the per-span overflow vector; overflowing spans grow their
    caps and ask for a re-run. With ``mesh`` the vector is OR-ed over its
    branch axis first, and the settled lists of every rank are gathered
    (``gather=False`` keeps this rank's rows of the padded ghost axis, for a
    caller that goes on across the ranks, as the device key merge does).

    ``pend`` is :func:`enumerate_pairs_deferred`'s handle. Returns (done,
    result, caps): done=True with result = (cl, cr, scores, overflow [G]
    np.bool_) over all G rows when the chunk is complete (the flags are set
    only at the cap ceiling); done=False with result=None when the caller
    must re-run with the returned (grown) caps.
    """
    spans_order = _spans(k) if k > 1 else [(0, 1)]
    G, (cl, cr, scores, ovf_spans, ovf_ghosts) = pend
    if mesh is not None:
        ovf_spans = mesh.all_reduce(ovf_spans.to(torch.int32), "branch",
                                    op="max")

    def gathered(x):
        if mesh is not None:
            x = mesh.all_gather(x, "branch")
        return x[:G]

    def lists():
        if mesh is not None and not gather:
            return cl, cr, scores
        return gathered(cl), gathered(cr), gathered(scores)

    vec = ovf_spans.cpu().numpy()
    flagged = [s for s, f in zip(spans_order, vec) if f]
    if not flagged:
        return True, (*lists(), np.zeros((G,), bool)), caps
    grew = False
    new_caps = dict(caps)
    for span in flagged:
        j, h = span
        natural = _natural_size(j, h, sigma, caps)
        cur = caps[span]
        if cur < min(cap, natural):
            new_caps[span] = min(cap, natural, cur * 2)
            grew = True
    if not grew:
        # ceiling reached: report which ghosts overflowed
        return True, (*lists(),
                      gathered(ovf_ghosts.to(torch.int32)).cpu().numpy()
                      .astype(bool)), caps
    return False, None, normalize_caps(new_caps, k, sigma, cap)


def _pack_host(cl: np.ndarray, cr: np.ndarray, *, k: int, bits: int
               ) -> np.ndarray:
    shift = np.uint64(bits * (k - k // 2))
    return ((np.asarray(cl, dtype=np.uint64) << shift)
            | np.asarray(cr, dtype=np.uint64))


def enumerate_sparse_many(P_all, prefix_all, log_threshold, *, k: int,
                          sigma: int, bits: int, cap: int = 4096,
                          caps: Optional[Dict] = None,
                          use_kernel: Optional[bool] = None,
                          probe: bool = True,
                          combine_budget_bytes: int = 4 << 30,
                          stats: Optional[Dict] = None,
                          device: device_mod.DeviceLike = "cuda",
                          mesh=None, recorder: Optional[Recorder] = None):
    """Ghost-batched sparse enumeration (host-facing).

    P_all: [G, S, sigma], prefix_all: [G, S+1] (numpy). Returns
    (codes [G, W, C] uint64, scores [G, W, C] f32, overflow [G] bool), as
    ``ipk_tpu``'s ``enumerate_sparse_many`` does.

    The ghosts run in chunks whose device working set stays within
    ``combine_budget_bytes``. Every chunk first runs with the caps the call
    started from; a chunk that overflows re-runs with the caps grown so far,
    doubled on its flagged spans — ``ipk_tpu``'s dispatch-all-then-settle
    schedule, run one chunk at a time, so the output widths agree too. With
    ``mesh`` each chunk's rows are shared out over its branch axis (on
    ``mesh.device``) and every rank returns all of them.

    ``use_kernel`` None or True takes ``kernels.staircase_select`` (the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors); False takes
    :func:`staircase_select_ref` on any device.

    ``stats`` (optional dict) gains "redispatches" (chunks re-run because a
    span cap doubled: probe misses) and "final_caps" (the settled per-span
    caps). ``recorder`` (optional ``spans.Recorder``) gains
    "device_compute" (the device's time for each chunk's enumeration, a
    ``stage1.batch`` span ended by a synchronize), "transfer" (the device's
    time for the device→host copies of the lists), "transfer_bytes" and
    "pack" (host key packing).
    """
    if bits * (k - k // 2) > 32:
        # mid-span codes must fit 32 bits; AA k=13 would need 35 (and 65-bit
        # keys, beyond the reference's own uint64)
        raise ValueError(
            f"k={k} at {bits} bits/symbol exceeds the 32-bit half-window "
            f"code budget (max k: {2 * (32 // bits)} for this alphabet)")
    P_all = np.asarray(P_all, dtype=np.float32)
    prefix_all = np.asarray(prefix_all, dtype=np.float32)
    G, S = P_all.shape[0], P_all.shape[1]
    W = S - k + 1
    if W <= 0 or G == 0:
        return (np.zeros((G, 0, 1), np.uint64),
                np.zeros((G, 0, 1), np.float32), np.zeros((G,), bool))
    if caps is None:
        caps = (probe_caps(P_all, prefix_all, log_threshold, k=k,
                           sigma=sigma, cap=cap)
                if probe else default_caps(k, sigma, cap))
    dev = mesh.device if mesh is not None else device_mod.resolve(device)
    # working set per ghost: outputs (3 x [W, top_cap]) plus per-span
    # survivor lists — dominated by the top span
    top_cap = min(cap, max(list(caps.values()) + [128]))
    per_ghost = W * top_cap * 48
    ghost_chunk = max(1, min(G, combine_budget_bytes // max(1, per_ghost)))
    start_caps = caps
    rec = recorder if recorder is not None else Recorder()

    def run(g0: int, g1: int, caps_: Dict):
        with rec.span("stage1.batch", key="device_compute", device=dev):
            pend = enumerate_pairs_deferred(
                P_all[g0:g1], prefix_all[g0:g1], log_threshold, k=k,
                sigma=sigma, bits=bits, caps=caps_, use_kernel=use_kernel,
                mesh=mesh, device=dev)
            device_mod.synchronize(dev)
        return pend

    out_c, out_s = [], []
    overflow = np.zeros((G,), bool)
    for g0 in range(0, G, ghost_chunk):
        g1 = min(G, g0 + ghost_chunk)
        pend = run(g0, g1, start_caps)
        while True:
            done, result, caps = resolve_overflow(pend, k=k, sigma=sigma,
                                                  cap=cap, caps=caps,
                                                  mesh=mesh)
            if done:
                break
            if stats is not None:
                stats["redispatches"] = stats.get("redispatches", 0) + 1
            pend = run(g0, g1, caps)
        cl, cr, scores, ovf = result
        with rec.span("transfer", device=dev):
            cl, cr, scores = (t.cpu().numpy() for t in (cl, cr, scores))
        rec.add("transfer_bytes", cl.nbytes + cr.nbytes + scores.nbytes)
        del pend, result
        with rec.span("pack"):
            out_c.append(_pack_host(cl, cr, k=k, bits=bits))
            out_s.append(np.asarray(scores, dtype=np.float32))
        overflow[g0:g1] = ovf
    if stats is not None:
        stats["final_caps"] = dict(caps)
    if len(out_c) > 1:
        # chunks may have adapted to different capacities: pad to the widest
        Cmax = max(c.shape[2] for c in out_c)
        out_c = [np.pad(c, ((0, 0), (0, 0), (0, Cmax - c.shape[2])))
                 for c in out_c]
        out_s = [np.pad(s, ((0, 0), (0, 0), (0, Cmax - s.shape[2])),
                        constant_values=NEG_INF) for s in out_s]
    return np.concatenate(out_c), np.concatenate(out_s), overflow


def enumerate_sparse(P, prefix, log_threshold, *, k: int, sigma: int,
                     bits: int, cap: int = 4096,
                     caps: Optional[Dict] = None,
                     use_kernel: Optional[bool] = None,
                     combine_budget_bytes: int = 1 << 28,
                     device: device_mod.DeviceLike = "cuda"):
    """Full-window survivor lists for one ghost matrix.

    Returns (codes [W, C] uint64, scores [W, C] f32, overflow bool).
    """
    codes, scores, overflow = enumerate_sparse_many(
        np.asarray(P, dtype=np.float32)[None],
        np.asarray(prefix, dtype=np.float32)[None],
        log_threshold, k=k, sigma=sigma, bits=bits, cap=cap, caps=caps,
        use_kernel=use_kernel, combine_budget_bytes=combine_budget_bytes,
        device=device)
    return codes[0], scores[0], bool(overflow[0])


def merge_window_lists(codes: np.ndarray, scores: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side insert-or-max merge over windows (and ghosts, if their lists
    are concatenated along the window axis) — the hash-map ``put`` analog
    (``branch_group.cpp:88-102``) on compacted lists.

    codes/scores: [..., C] flattened; invalid slots (score -inf) are dropped.
    Returns (unique sorted codes, per-code max score).
    """
    codes = np.asarray(codes, dtype=np.uint64).ravel()
    scores = np.asarray(scores, dtype=np.float32).ravel()
    valid = np.isfinite(scores)
    codes, scores = codes[valid], scores[valid]
    if codes.size == 0:
        return codes, scores
    order = np.lexsort((-scores, codes))
    codes, scores = codes[order], scores[order]
    first = np.ones(len(codes), dtype=bool)
    first[1:] = codes[1:] != codes[:-1]
    # sorted by (code asc, score desc): the first row of each code group is
    # its maximum
    return codes[first], scores[first]
