"""The cross-rank key merge of survivor tuples on the devices: the
counterpart of ``ipk_tpu/parallel/key_merge.py``.

The reference aggregates stage-1 survivors through per-branch hash maps and
a ``key % 32`` spill/merge (``branch_group.cpp:88-107``, ``db_builder.cpp:
340-458``). Here each rank, on its slice of the ghost rows:

  1. sorts its (cl, cr, score) tuples by (cl, cr, group, -score), the score
     riding along untouched (its bits, -0.0 included, survive);
  2. keeps the first tuple of each (cl, cr, group) run: the insert-or-max
     ``put`` (``branch_group.cpp:88-102``) over windows and ghosts at once;
  3. compacts the kept tuples to the front, in order;
  4. bins them by contiguous key range, rank d taking
     cl in [ceil(d·nl/n), ceil((d+1)·nl/n)) with nl = 2^(bits·hl), the
     BIT-packed cl code space (σ^hl is wrong for alphabets whose size is
     not a power of two: their packed codes exceed it);
  5. exchanges the bins with ``all_to_all_single``: rank d receives every
     rank's tuples of key range d;
  6. sorts what it received by (cl, cr, group).

The ranks then gather the per-range streams, so each holds the whole
key-major, group-ascending entry stream, with the per-(key, group) maximum
scores: what the host merge gives (``merge_window_lists`` per branch and a
lexsort), byte for byte. Score ties keep the earlier tuple of the ghost rows
(a ±0.0 tie included), as ``merge_window_lists``'s stable sort does.

Codes are int64 on the devices (the tuple's invalid code is 2^32, above
every 32-bit half-window code, so it sorts last); keys are packed to uint64
on the host. Each (source, destination) bin has a fixed capacity, so every
exchange is even; a skewed key distribution overflows it and raises
:class:`KeyMergeOverflow` on every rank, and the caller falls back to the
host merge.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .mesh import Mesh

__all__ = ["device_key_merge", "KeyMergeOverflow"]

_INVALID_CODE = 1 << 32
#: the columns of a packed tuple row: cl, cr, group, score bits
_CL, _CR, _GROUP, _SCORE = range(4)


class KeyMergeOverflow(Exception):
    """A (source, destination) bin exceeded its capacity (skewed keys)."""


def _stable_order(keys) -> torch.Tensor:
    """The permutation that sorts by the given int64 keys, the first most
    significant, ties in their original order."""
    perm = None
    for key in reversed(keys):
        k = key if perm is None else key[perm]
        order = torch.sort(k, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def _desc_score_key(s: torch.Tensor) -> torch.Tensor:
    """An int64 key ascending as the float32 score descends; +0.0 and -0.0
    give one key (``+ 0.0`` maps -0.0 to +0.0 in the key only)."""
    v = (s + 0.0).view(torch.int32).to(torch.int64)
    asc = torch.where(v < 0, -1 - v, v + (1 << 31))
    return ((1 << 32) - 1) - asc


def _as_int64(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)


def _as_f32(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def _local_merge(cl, cr, s, b, *, nl: int, n_dev: int, bucket_cap: int):
    """Steps 1-4 on this rank's flat tuples. Returns (bins [n_dev,
    bucket_cap, 4] int64 packed rows, overflow bool)."""
    dev = cl.device
    valid = torch.isfinite(s)
    cl = torch.where(valid, cl, _INVALID_CODE)
    cr = torch.where(valid, cr, _INVALID_CODE)

    # (1) sort by (cl, cr, group, -s); b < 2^31 and the score key < 2^32
    perm = _stable_order([cl, cr, b * (1 << 32) + _desc_score_key(s)])
    cl, cr, b, s = cl[perm], cr[perm], b[perm], s[perm]

    # (2) insert-or-max: the first tuple of each (cl, cr, group) run
    keep = torch.isfinite(s)
    keep[1:] &= ~((cl[1:] == cl[:-1]) & (cr[1:] == cr[:-1])
                  & (b[1:] == b[:-1]))

    # (3) compact the kept tuples, in order, as packed rows plus one dead
    # row at the end that empty bin slots point to
    rows = torch.stack([cl, cr, b, s.view(torch.int32).to(torch.int64)],
                       dim=1)[keep]
    dead = torch.tensor([[_INVALID_CODE, _INVALID_CODE, 0,
                          int(np.float32(-np.inf).view(np.int32))]],
                        dtype=torch.int64, device=dev)
    n_valid = rows.shape[0]
    rows = torch.cat([rows, dead])

    # (4) contiguous key-range bins: cl is non-decreasing, so bin d is the
    # slice [starts[d], starts[d+1])
    bounds = torch.tensor([(d * nl + n_dev - 1) // n_dev
                           for d in range(n_dev + 1)], dtype=torch.int64,
                          device=dev)
    starts = torch.searchsorted(rows[:n_valid, _CL].contiguous(), bounds)
    counts = starts[1:] - starts[:-1]
    overflow = (counts > bucket_cap).any()
    lane = torch.arange(bucket_cap, dtype=torch.int64, device=dev)
    src = torch.where(lane[None, :] < counts[:, None],
                      starts[:-1, None] + lane[None, :], n_valid)
    return rows[src], overflow


def device_key_merge(mesh: Mesh, cl, cr, scores, *, ghosts_per_group: int,
                     nl: int, bits: int, k: int,
                     bucket_cap: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge the ranks' survivor tuples into one key-major entry stream.

    cl/cr: [G_loc, W, C] half-codes (int64 tensors or integer arrays),
    scores [G_loc, W, C] f32 (-inf = empty slot): this rank's contiguous
    slice of the ghost axis, the same number of whole groups on every rank
    (rank b holds rows [b·G_loc, (b+1)·G_loc); pad with inert ghosts), as
    the sharded enumeration leaves them. Returns host arrays (keys uint64,
    group index int64, scores f32), sorted by (key, group) with per-(key,
    group) maximum scores, the same on every rank: the stream the host merge
    builds with a lexsort. Raises :class:`KeyMergeOverflow` on every rank
    when a key-range bin exceeds ``bucket_cap``.
    """
    dev = mesh.device
    n_dev = mesh.size("branch")
    G_loc, W, C = cl.shape
    if G_loc % ghosts_per_group:
        raise ValueError(f"{G_loc} ghost rows a rank are not whole groups of "
                         f"{ghosts_per_group}")
    if bucket_cap is None:
        T_loc = G_loc * W * C
        bucket_cap = min(T_loc, 4 * (T_loc // max(1, n_dev)) + 1024)
    bucket_cap = int(-(-bucket_cap // 128) * 128)

    cl_l = _as_int64(cl, dev).reshape(-1)
    cr_l = _as_int64(cr, dev).reshape(-1)
    s_l = _as_f32(scores, dev).reshape(-1)
    # each tuple's GLOBAL group index
    row0 = mesh.index("branch") * G_loc
    b_l = ((torch.arange(G_loc, dtype=torch.int64, device=dev) + row0)
           // ghosts_per_group).repeat_interleave(W * C)

    bins, overflow = _local_merge(cl_l, cr_l, s_l, b_l, nl=int(nl),
                                  n_dev=n_dev, bucket_cap=bucket_cap)
    n_over = int(mesh.all_reduce(overflow.to(torch.int64), "branch"))
    if n_over:
        raise KeyMergeOverflow(
            f"device key merge bucket capacity {bucket_cap} exceeded on "
            f"{n_over} rank(s)")

    # (5) bin d goes to rank d; (6) order the received tuples
    got = mesh.all_to_all(bins.reshape(n_dev * bucket_cap, 4), "branch")
    got = got[torch.isfinite(got[:, _SCORE].to(torch.int32)
                             .view(torch.float32))]
    got = got[_stable_order([got[:, _CL], got[:, _CR], got[:, _GROUP]])]

    # every rank takes every key range's stream, in rank (= key) order
    n_out = mesh.all_gather(torch.tensor([got.shape[0]], dtype=torch.int64,
                                         device=dev), "branch").cpu()
    width = int(n_out.max())
    padded = torch.zeros((width, 4), dtype=torch.int64, device=dev)
    padded[:got.shape[0]] = got
    every = mesh.all_gather(padded, "branch").reshape(n_dev, width, 4)
    stream = torch.cat([every[d, :int(n_out[d])] for d in range(n_dev)]
                       ).cpu().numpy()
    shift = np.uint64(bits * (k - k // 2))
    keys = ((stream[:, _CL].astype(np.uint64) << shift)
            | stream[:, _CR].astype(np.uint64))
    scores_out = stream[:, _SCORE].astype(np.int32).view(np.float32)
    return keys, stream[:, _GROUP].copy(), scores_out
