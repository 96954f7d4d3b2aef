"""Dense phylo-k-mer enumeration in PyTorch: the counterpart of
``ipk_tpu/core/dense.py`` for the dense build path.

Every window of every ghost matrix scores all σ^k candidates through the
reference's split tree ``(h//2, h - h//2)`` with per-level pruning
thresholds; the top level factorises into two masked half tensors
``L[G, W, σ^(k//2)]`` and ``R[G, W, σ^(k-k//2)]`` whose outer sum, max-reduced
over windows, is the per-ghost accumulator (``combine_max_ref`` here, the CUDA
kernel ``core.kernels.combine_max`` on the GPU; with the best window of each
cell, ``combine_max_with_positions_ref`` and its kernel mode).
``extract_columns_ref`` is the plain version of the ``extract_columns``
kernel, which turns a key batch's accumulator into database columns.

What must stay exactly as in the reference for bit-equal results:

* the split tree and the f32 eps chain ``eps_child = parent - range_max``;
* the outer sum flattened left-half-major
  (``(Tl[..., :, None] + Tr[..., None, :]).reshape(..., -1)``);
* every threshold comparison against f32 tensors (eps is a 0-d float32
  tensor, never a Python float), strict ``>``.

JAX's ``vmap`` over ghosts is the leading dimension G written out.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from .filter import mif0_filter_values_entries

__all__ = ["split_tree", "best_score_prefix", "masked_span_scores",
           "masked_halves", "combine_max_ref", "count_explored_sorted",
           "combine_max_with_positions_ref", "group_max",
           "group_max_with_positions", "extract_columns_ref"]

NEG_INF = float("-inf")


def split_tree(k: int) -> List[Tuple[int, int]]:
    """Sub-window spans (j, h) of the DCLA recursion, children before parents
    (``DC(j, h) -> DC(j, h/2), DC(j + h/2, h - h/2)``, ``pk_compute.cpp:54-58``).
    """
    order: List[Tuple[int, int]] = []

    def build(j: int, h: int) -> None:
        if h > 1:
            hl = h // 2
            build(j, hl)
            build(j + hl, h - hl)
        order.append((j, h))

    build(0, k)
    return order


def best_score_prefix(P: np.ndarray) -> np.ndarray:
    """Sequential f32 prefix sums of per-column max log-scores: the bound
    oracle ``range_max_sum(start, len) = prefix[start+len] - prefix[start]``
    (``window.cpp:16-27,69-72``). numpy's sequential cumsum keeps the
    reference's left-to-right f32 order.

    P: [..., S, sigma] log10 scores. Returns [..., S+1] f32.
    """
    P = np.asarray(P, dtype=np.float32)
    best = P.max(axis=-1)
    prefix = np.zeros(P.shape[:-2] + (P.shape[-2] + 1,), dtype=np.float32)
    np.cumsum(best, axis=-1, dtype=np.float32, out=prefix[..., 1:])
    return prefix


def _range_max(prefix: torch.Tensor, start: int, length: int,
               W: int) -> torch.Tensor:
    """[G, W] bound-oracle sums over [w + start, w + start + length)."""
    return (prefix[:, start + length:start + length + W]
            - prefix[:, start:start + W])


def masked_span_scores(P: torch.Tensor, prefix: torch.Tensor, j: int, h: int,
                       eps: torch.Tensor, *, k: int,
                       sigma: int) -> torch.Tensor:
    """Masked sub-window scores of span (j, h) at every window offset.

    P: [G, S, sigma] f32; prefix: [G, S+1] f32; eps: [G, W] f32 per-window
    thresholds of this span. Returns [G, W, sigma^h] f32, pruned = -inf.
    """
    G, S, _ = P.shape
    W = S - k + 1
    if h == 1:
        T = P[:, j:j + W, :]
    else:
        hl = h // 2
        hr = h - hl
        eps_l = eps - _range_max(prefix, j + hl, hr, W)
        eps_r = eps - _range_max(prefix, j, hl, W)
        Tl = masked_span_scores(P, prefix, j, hl, eps_l, k=k, sigma=sigma)
        Tr = masked_span_scores(P, prefix, j + hl, hr, eps_r, k=k,
                                sigma=sigma)
        T = (Tl[:, :, :, None] + Tr[:, :, None, :]).reshape(G, W, -1)
    return torch.where(T > eps[:, :, None], T, NEG_INF)


def masked_halves(P: torch.Tensor, prefix: torch.Tensor, eps: torch.Tensor,
                  *, k: int, sigma: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked half-window scores ``L[G, W, sigma^(k//2)]``,
    ``R[G, W, sigma^(k-k//2)]`` for all ghosts.

    The top-level combine ``L ⊕ R`` against the constant ``eps`` (0-d f32)
    yields every window's full candidate scores; per-window thresholds exist
    only below the halves.
    """
    G, S, _ = P.shape
    W = S - k + 1
    eps_top = eps.to(torch.float32).expand(G, W)
    if k == 1:
        L = masked_span_scores(P, prefix, 0, 1, eps_top, k=k, sigma=sigma)
        return L, torch.zeros((G, W, 1), dtype=torch.float32,
                              device=P.device)
    hl = k // 2
    hr = k - hl
    eps_l = eps_top - _range_max(prefix, hl, hr, W)
    eps_r = eps_top - _range_max(prefix, 0, hl, W)
    L = masked_span_scores(P, prefix, 0, hl, eps_l, k=k, sigma=sigma)
    R = masked_span_scores(P, prefix, hl, hr, eps_r, k=k, sigma=sigma)
    return L, R


def combine_max_ref(L: torch.Tensor, R: torch.Tensor, eps: torch.Tensor,
                    *, budget_bytes: int = 1 << 28
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ``combine_max`` kernel.

    ``A[g, i, j] = max_w (L[g, w, i] + R[g, w, j])``, then ``-inf`` where
    ``<= eps`` (the mask is monotone, so it commutes with the max), and
    ``counts[g] = #{(w, i, j): L + R > eps}`` as int64, every window counted
    exactly once. L: [G, W, nl], R: [G, W, nr] f32; eps: 0-d f32.
    Windows are taken in chunks so the [G, chunk, nl, nr] temporary stays
    within ``budget_bytes``.
    """
    G, W, nl = L.shape
    nr = R.shape[2]
    eps = eps.to(torch.float32)
    A = torch.full((G, nl, nr), NEG_INF, dtype=torch.float32,
                   device=L.device)
    counts = torch.zeros(G, dtype=torch.int64, device=L.device)
    bw = max(1, budget_bytes // max(1, G * nl * nr * 4))
    for w0 in range(0, W, bw):
        T = L[:, w0:w0 + bw, :, None] + R[:, w0:w0 + bw, None, :]
        torch.maximum(A, T.amax(dim=1), out=A)
        counts += (T > eps).sum(dim=(1, 2, 3))
    A = torch.where(A > eps, A, NEG_INF)
    return A, counts


def count_explored_sorted(L: torch.Tensor, R: torch.Tensor,
                          eps: torch.Tensor, *, side: str = "r"
                          ) -> torch.Tensor:
    """The explored count of :func:`combine_max_ref` by sorted search: the
    counting rule of the ``combine_max`` kernel, in plain torch.

    For a fixed a, ``fl(a + b)`` is non-decreasing in b (round-to-nearest
    is monotone; the halves hold finite values and -inf), so the b with
    ``fl(a + b) > eps`` are a suffix of the other half's values sorted
    ascending. ``side`` names the half that is sorted, per window and padded
    at the front with -inf to a power of two P; each value of the other half
    binary-searches it with the exact predicate, and adds P minus the first
    index that passes. Addition commutes exactly, so either side gives the
    same count. Returns counts [G] int64, equal to ``combine_max_ref``'s.
    """
    if side not in ("l", "r"):
        raise ValueError(f"side must be 'l' or 'r', got {side!r}")
    S, O = (L, R) if side == "l" else (R, L)
    G, W, ns = S.shape
    eps = eps.to(torch.float32)
    P = 1 << max(0, (ns - 1).bit_length())
    srt = torch.sort(S, dim=2).values
    srt = torch.cat([torch.full((G, W, P - ns), NEG_INF, dtype=S.dtype,
                                device=S.device), srt], dim=2)
    first = torch.zeros(O.shape, dtype=torch.int64, device=O.device)
    step = P // 2
    while step:
        probe = torch.gather(srt, 2, first + (step - 1))
        first += step * (~(probe + O > eps)).to(torch.int64)
        step //= 2
    passes = srt[:, :, P - 1:] + O > eps
    return torch.where(passes, P - first, 0).sum(dim=(1, 2))


def combine_max_with_positions_ref(L: torch.Tensor, R: torch.Tensor,
                                   eps: torch.Tensor, *, block_w: int = 32,
                                   budget_bytes: Optional[int] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Plain version of the positions mode of the ``combine_max`` kernel:
    :func:`combine_max_ref` plus the window of each cell's best score (the
    aa-pos variant, ``ipk_tpu/core/dense.py:combine_max_with_positions``).

    Windows run in ascending order and only a strictly greater score
    replaces, so ``pos`` is the earliest window of the maximum
    (``branch_group.cpp:73-86``); counts take every window once, as int64.
    Dead cells are (-inf, 0). One seam follows ``ipk_tpu``'s blocks of
    ``block_w`` windows (the last clamped to end at W): its block max comes
    out of XLA on the CPU with the bits of the LAST window of the block
    tied at the maximum, which differs from the earliest window's bits only
    where the maximum is a zero reached as both -0.0 and +0.0. Such cells
    take the bits of the last zero in their block, as the kernel does.

    Returns (A [G, nl, nr] float32, pos [G, nl, nr] int32, counts [G]
    int64). Ghosts are taken in chunks of ``budget_bytes`` of A (default:
    1 MB on the CPU, which keeps a chunk in cache across the windows,
    256 MB elsewhere); the result does not depend on the chunk.
    """
    G, W, nl = L.shape
    nr = R.shape[2]
    eps = eps.to(torch.float32)
    dev = L.device
    A = torch.full((G, nl, nr), NEG_INF, dtype=torch.float32, device=dev)
    pos = torch.zeros((G, nl, nr), dtype=torch.int32, device=dev)
    counts = torch.zeros(G, dtype=torch.int64, device=dev)
    if budget_bytes is None:
        budget_bytes = 1 << 20 if dev.type == "cpu" else 1 << 28
    gc = max(1, budget_bytes // max(1, nl * nr * 4))
    for g0 in range(0, G, gc):
        g1 = min(G, g0 + gc)
        Ag, Pg = A[g0:g1], pos[g0:g1]
        for w in range(W):
            T = L[g0:g1, w, :, None] + R[g0:g1, w, None, :]
            counts[g0:g1] += (T > eps).sum(dim=(1, 2))
            better = T > Ag
            torch.where(better, T, Ag, out=Ag)
            Pg.masked_fill_(better, w)
    dead = ~(A > eps)
    A.masked_fill_(dead, NEG_INF)
    pos.masked_fill_(dead, 0)
    g, i, j = torch.nonzero(A == 0, as_tuple=True)
    if len(g):
        # the zero seam: the last zero of the earliest window's block
        bw = min(block_w, W)
        p = pos[g, i, j].to(torch.int64)
        block = torch.clamp(torch.div(p, bw, rounding_mode="floor"),
                            max=-(-W // bw) - 1)
        end = torch.clamp(block * bw, max=W - bw) + bw
        val = A[g, i, j]
        for w in range(W):
            t = L[g, w, i] + R[g, w, j]
            val = torch.where((w > p) & (w < end) & (t == 0), t, val)
        A[g, i, j] = val
    return A, pos, counts


def group_max(A_ghost: torch.Tensor, ghosts_per_group: int) -> torch.Tensor:
    """Merge the adjacent ghosts of each original branch by max:
    [G, K] → [G / ghosts_per_group, K] (``db_builder.cpp:641-665``)."""
    G, K = A_ghost.shape
    return A_ghost.reshape(G // ghosts_per_group, ghosts_per_group,
                           K).amax(dim=1)


def group_max_with_positions(A_ghost: torch.Tensor, pos_ghost: torch.Tensor,
                             ghosts_per_group: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`group_max` carrying positions: a strictly greater ghost
    replaces, so the first ghost in group order wins ties (X1 before X0,
    extended postorder). [G, K] twice → [G / ghosts_per_group, K] twice."""
    G, K = A_ghost.shape
    B = G // ghosts_per_group
    A = A_ghost.reshape(B, ghosts_per_group, K)
    pos = pos_ghost.reshape(B, ghosts_per_group, K)
    best_A, best_pos = A[:, 0], pos[:, 0]
    for g in range(1, ghosts_per_group):
        better = A[:, g] > best_A
        best_A = torch.where(better, A[:, g], best_A)
        best_pos = torch.where(better, pos[:, g], best_pos)
    return best_A, best_pos


def extract_columns_ref(A: torch.Tensor, group_ids: torch.Tensor, *,
                        total_num_groups: int, threshold: float,
                        mif0: bool = True, merge_branches: bool = False,
                        recorder=None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                   torch.Tensor, torch.Tensor]:
    """Plain version of the ``extract_columns`` kernel, on CPU tensors.

    A: [B, chunk] f32 (group rows, key columns, -inf where pruned);
    group_ids: [B] int32. Returns (counts [chunk] int32, fv [chunk] float64
    or None, branches [E] int32, scores [E] float32): each column's entry
    count and, with ``mif0``, its mif0 value (0 where dead), from the host
    filter the host extraction calls (``core.filter``'s
    ``mif0_filter_values_entries``, a ``mif0`` span of ``recorder``); the
    entries key-major, groups ascending within a key. ``merge_branches``
    keeps each column's first strict maximum (ties to the lowest row), as
    the host extraction's lexsort does.
    """
    mask = torch.isfinite(A)
    if merge_branches:
        top = A.amax(dim=0)
        first = (A == top).to(torch.uint8).argmax(dim=0)
        cols = torch.nonzero(mask.any(dim=0)).reshape(-1)
        mask = torch.zeros_like(mask)
        mask[first[cols], cols] = True
    counts = mask.sum(dim=0, dtype=torch.int32)
    col, row = torch.nonzero(mask.t(), as_tuple=True)
    branches, scores = group_ids[row], A[row, col]
    fv = None
    if mif0:
        span = (recorder.span("mif0") if recorder is not None
                else contextlib.nullcontext())
        with span:
            cnt = counts.numpy()
            live = cnt > 0
            offsets = np.zeros(int(live.sum()) + 1, dtype=np.int64)
            np.cumsum(cnt[live], out=offsets[1:])
            fv_np = np.zeros(len(cnt), dtype=np.float64)
            fv_np[live] = mif0_filter_values_entries(
                scores.numpy(), None, len(offsets) - 1, total_num_groups,
                threshold, offsets=offsets)
        fv = torch.from_numpy(fv_np)
    return counts, fv, branches, scores
