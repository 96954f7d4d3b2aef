"""The sharded build step on ``torch.distributed``: branch-parallel
enumeration and the distributed mutual-information reduction, the
counterpart of ``ipk_tpu/parallel/build_sharded.py``.

Every rank holds the whole input (the ghost posteriors and their prefix,
padded with :func:`pad_ghosts`) and enumerates its contiguous slice of the
ghost axis with the port's ``combine_max`` kernel (its plain version on the
CPU). The mif0 filter (``filter.cpp:60-119``) becomes three sum all-reduces
over the branch axis; each key rank then finishes its contiguous key range.
Where ``ipk_tpu`` returns arrays sharded over its mesh, these functions
return the gathered tensors, the same on every rank, on the rank's device.

Numerical note, as in ``ipk_tpu``: the distributed filter runs in f32, so
its values differ from the host f64 filter in the last bits (and with the
order of the reduction); the enumeration is bit-exact.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..core import dense
from ..core.kernels import combine_max
from .mesh import Mesh

__all__ = ["sharded_enumerate", "sharded_build_step",
           "sharded_batched_build_step", "pad_ghosts", "PAD_LOG_SCORE"]

#: Padding value for dummy ghost matrices (branch-axis padding): a large
#: negative *finite* log-score so eps-chain arithmetic stays NaN-free while
#: every padded candidate is pruned to -inf by the threshold masks.
PAD_LOG_SCORE = np.float32(-1e9)


def pad_ghosts(P_all: np.ndarray, prefix_all: np.ndarray, multiple: int):
    """Pad the ghost axis to a multiple (whole groups at a time)."""
    G = P_all.shape[0]
    target = -(-G // multiple) * multiple
    if target == G:
        return P_all, prefix_all, G
    pad = target - G
    P_pad = np.full((pad,) + P_all.shape[1:], PAD_LOG_SCORE, dtype=np.float32)
    pref_pad = dense.best_score_prefix(P_pad)
    return (np.concatenate([P_all, P_pad]),
            np.concatenate([prefix_all, pref_pad]), G)


def _f32(x, device: torch.device) -> torch.Tensor:
    """A numpy array, tensor or scalar as float32 on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def _shannon(x: torch.Tensor) -> torch.Tensor:
    return -x * torch.log2(x)


def _mi_reduce(A_loc: torch.Tensor, mesh: Mesh, *, total_num_groups: int,
               threshold: float) -> torch.Tensor:
    """Collective mif0 over this rank's branch slice A_loc [B_loc, K]
    (``filter.cpp:60-119`` as three sums over the branch axis). Exact per
    key, so valid on any contiguous key slice, which is what lets the
    key-batched step reduce batch by batch. Returns fv [K] f32, each key
    rank's range gathered over the key axis."""
    dev = A_loc.device
    mask = torch.isfinite(A_loc)
    lin = torch.where(mask, torch.clamp(torch.pow(10.0, A_loc), max=1.0),
                      0.0)
    cnt = mesh.all_reduce(mask.sum(dim=0).to(torch.float32), "branch")
    lin_sum = mesh.all_reduce(lin.sum(dim=0), "branch")

    N = torch.tensor(np.float32(total_num_groups), device=dev)
    thr = torch.tensor(np.float32(threshold), device=dev)
    score_sum = lin_sum + (N - cnt) * thr
    tv = torch.where(mask, _shannon(lin / score_sum[None, :]), 0.0)
    tv_sum = mesh.all_reduce(tv.sum(dim=0), "branch")

    # each key rank finishes its contiguous k-mer range (the analog of the
    # reference's k-mer-space batching, branch_group.cpp:104-107)
    chunk = score_sum.shape[0] // mesh.size("key")
    sl = slice(mesh.index("key") * chunk, (mesh.index("key") + 1) * chunk)
    ss, cnt_k, tv_k = score_sum[sl], cnt[sl], tv_sum[sl]
    tt = _shannon(thr / ss)
    HcBw1 = N * tt + (tv_k - cnt_k * tt)
    return mesh.all_gather(ss * (HcBw1 - torch.log2(N)), "key")


def _local_halves(mesh: Mesh, P_all, prefix_all, log_threshold, *, k: int,
                  sigma: int):
    """This rank's masked halves (L, R) and eps, on its device."""
    P = _f32(mesh.local_rows(P_all), mesh.device)
    prefix = _f32(mesh.local_rows(prefix_all), mesh.device)
    eps = _f32(log_threshold, mesh.device).reshape(())
    L, R = dense.masked_halves(P, prefix, eps, k=k, sigma=sigma)
    return L, R, eps


def _group_combine(L, R, eps, ghosts_per_group: int):
    A_g, counts = combine_max(L.contiguous(), R, eps)
    return dense.group_max(A_g.reshape(A_g.shape[0], -1),
                           ghosts_per_group), counts


def sharded_enumerate(mesh: Mesh, P_all: np.ndarray, prefix_all: np.ndarray,
                      log_threshold, *, k: int, sigma: int,
                      ghosts_per_group: int) -> np.ndarray:
    """Branch-parallel stage 1 only: A[B, σ^k] as numpy on every rank.

    Pads the ghost axis to the mesh (padded groups yield no survivors) and
    returns the unpadded accumulator, bit-identical to the single-device
    path (enumeration has no cross-branch arithmetic).
    """
    P_pad, prefix_pad, G = pad_ghosts(
        np.asarray(P_all, np.float32), np.asarray(prefix_all, np.float32),
        mesh.size("branch") * ghosts_per_group)
    L, R, eps = _local_halves(mesh, P_pad, prefix_pad, log_threshold, k=k,
                              sigma=sigma)
    A_loc, _ = _group_combine(L, R, eps, ghosts_per_group)
    return mesh.all_gather(A_loc, "branch")[:G // ghosts_per_group
                                            ].cpu().numpy()


def sharded_build_step(mesh: Mesh, *, k: int, sigma: int,
                       ghosts_per_group: int, total_num_groups: int,
                       threshold: float) -> Callable:
    """The sharded step: (P_all, prefix_all, log_threshold) → (A [B, σ^k],
    fv [σ^k] f32, counts [G] int64 explored tuples per ghost), gathered.

    P_all's ghost axis must be divisible by the branch size × group size
    (use :func:`pad_ghosts`); the key size must divide σ^k.
    """
    if (sigma ** k) % mesh.size("key") != 0:
        raise ValueError(f"key-axis size {mesh.size('key')} must divide "
                         f"sigma^k")

    def step(P_all, prefix_all, log_threshold):
        L, R, eps = _local_halves(mesh, P_all, prefix_all, log_threshold,
                                  k=k, sigma=sigma)
        A_loc, counts = _group_combine(L, R, eps, ghosts_per_group)
        fv = _mi_reduce(A_loc, mesh, total_num_groups=total_num_groups,
                        threshold=threshold)
        return (mesh.all_gather(A_loc, "branch"), fv,
                mesh.all_gather(counts, "branch"))

    return step


def sharded_batched_build_step(mesh: Mesh, *, k: int, sigma: int,
                               ghosts_per_group: int, total_num_groups: int,
                               threshold: float, key_batches: int
                               ) -> Tuple[Callable, Callable, int]:
    """The key-batched device-MI step: enumeration and the mutual-
    information reduction stay on the devices even where the dense
    accumulator does not fit in one piece.

    The key space is split along the LEFT half-window axis into
    ``key_batches`` contiguous slices; mif0 is per-key separable, so
    :func:`_mi_reduce` on each slice gives the values of the unbatched step.

    Returns ``(halves_fn, batch_fn, step_l)``:
      halves_fn(P_pad, prefix_pad, eps) -> (L, R, eps) this rank's halves
      batch_fn(L, R, eps, lo_l) -> (A_b [B, step_l·nr], fv_b, counts [G])
    with ``lo_l`` the left-index offset; A_b and counts are gathered.
    """
    hl = k // 2
    nl = sigma ** hl
    if nl % key_batches != 0:
        raise ValueError(f"key_batches {key_batches} must divide {nl}")
    step_l = nl // key_batches
    if (step_l * (sigma ** (k - hl))) % mesh.size("key") != 0:
        raise ValueError(f"key-axis size {mesh.size('key')} must divide the "
                         f"batch")

    def halves_fn(P_pad, prefix_pad, log_threshold):
        return _local_halves(mesh, P_pad, prefix_pad, log_threshold, k=k,
                             sigma=sigma)

    def batch_fn(L, R, eps, lo_l: int):
        A_loc, counts = _group_combine(L[:, :, lo_l:lo_l + step_l], R, eps,
                                       ghosts_per_group)
        fv = _mi_reduce(A_loc, mesh, total_num_groups=total_num_groups,
                        threshold=threshold)
        return (mesh.all_gather(A_loc, "branch"), fv,
                mesh.all_gather(counts, "branch"))

    return halves_fn, batch_fn, step_l
