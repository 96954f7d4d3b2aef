"""Dense phylo-k-mer enumeration in PyTorch: the counterpart of
``ipk_tpu/core/dense.py`` for the dense build path.

Every window of every ghost matrix scores all σ^k candidates through the
reference's split tree ``(h//2, h - h//2)`` with per-level pruning
thresholds; the top level factorises into two masked half tensors
``L[G, W, σ^(k//2)]`` and ``R[G, W, σ^(k-k//2)]`` whose outer sum, max-reduced
over windows, is the per-ghost accumulator (``combine_max_ref`` here, the CUDA
kernel ``core.kernels.combine_max`` on the GPU).

What must stay exactly as in the reference for bit-equal results:

* the split tree and the f32 eps chain ``eps_child = parent - range_max``;
* the outer sum flattened left-half-major
  (``(Tl[..., :, None] + Tr[..., None, :]).reshape(..., -1)``);
* every threshold comparison against f32 tensors (eps is a 0-d float32
  tensor, never a Python float), strict ``>``.

JAX's ``vmap`` over ghosts is the leading dimension G written out.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

__all__ = ["split_tree", "best_score_prefix", "masked_span_scores",
           "masked_halves", "combine_max_ref", "group_max",
           "compact_survivors", "bitmask_survivors"]

NEG_INF = float("-inf")

#: flat survivor indices cross to the host as int32
_INDEX_LIMIT = 1 << 31


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


def group_max(A_ghost: torch.Tensor, ghosts_per_group: int) -> torch.Tensor:
    """Merge the adjacent ghosts of each original branch by max:
    [G, K] → [G / ghosts_per_group, K] (``db_builder.cpp:641-665``)."""
    G, K = A_ghost.shape
    return A_ghost.reshape(G // ghosts_per_group, ghosts_per_group,
                           K).amax(dim=1)


def _check_index_range(A: torch.Tensor, name: str) -> None:
    if A.numel() >= _INDEX_LIMIT:
        raise ValueError(
            f"{name}: accumulator batch of {A.numel()} elements exceeds the "
            "int32 index range; increase key_batches")


def compact_survivors(A: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Survivors of A in row-major order: (flat int32 indices, f32 scores,
    count), still on A's device."""
    _check_index_range(A, "compact_survivors")
    flat = A.reshape(-1)
    idx = torch.nonzero(torch.isfinite(flat)).reshape(-1)
    return idx.to(torch.int32), flat[idx], int(idx.numel())


def bitmask_survivors(A: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Survivors of A as (packed membership bitmask, f32 scores in flat
    order, count), still on A's device. The bitmask is one bit per cell,
    MSB-first, so ``np.unpackbits`` restores it."""
    _check_index_range(A, "bitmask_survivors")
    flat = A.reshape(-1)
    mask = torch.isfinite(flat)
    pad = (-flat.numel()) % 8
    bits = torch.cat([mask, mask.new_zeros(pad)]).reshape(-1, 8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                           device=A.device)
    packed = (bits.to(torch.uint8) * weights).sum(dim=1,
                                                  dtype=torch.uint8)
    idx = torch.nonzero(mask).reshape(-1)
    return packed, flat[idx], int(idx.numel())
