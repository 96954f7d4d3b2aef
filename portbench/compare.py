"""The comparison that decides ``correct``: a database against the plain
reference (``reference.py``), key by key, over a set of keys.

Four numbers, each held to a limit of its own (the configuration's
``limits``):

* ``score_gap`` — the largest |score - reference score| over the entries
  (key, branch) that both hold, in log10 units.
* ``fv_gap`` — the largest |fv - reference fv| over the keys that both hold,
  each over its |reference fv|, or over the median |reference fv| of those
  keys where that is larger (a key whose fv is near 0 is near uniform over
  the branches, and its relative gap says nothing).
* ``entries_off`` — entries that one side holds and the other does not,
  leaving out those whose reference score lies within ``score_gap``'s limit
  of eps (there, rounding alone decides); an entry on a branch that is not a
  branch of the tree counts too.
* ``order_off`` — what breaks the file's order or form: rows whose filter
  value is below the row before, keys written twice, entries of a key out
  of group order or on one branch twice, counts that do not add up to the
  entries, a header whose k or omega is not the build's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench import reference as ref

NAMES = ("score_gap", "fv_gap", "entries_off", "order_off")


def reference_database(logp: torch.Tensor, lay: ref.Layout,
                       keys: np.ndarray, k: int, omega: float) -> ref.IpkFile:
    """The database the reference computes from ``logp`` over ``keys``: its
    rows sorted by (fv, key), entries in group order."""
    eps = ref.eps_f32(omega, k)
    scores = ref.branch_scores(logp, lay, keys, k).float()
    fv = ref.mif0(scores, eps, ref.threshold(omega, k),
                  lay.num_nodes).cpu().numpy()
    keep = (scores > eps).cpu().numpy()           # [B, K]
    s = scores.cpu().numpy()
    counts = keep.sum(axis=0)
    rows = np.flatnonzero(counts)
    order = rows[np.lexsort((keys[rows], fv[rows]))]
    kt = keep[:, order].T
    branches = np.broadcast_to(lay.branch_ids.astype(np.uint32),
                               kt.shape)[kt]
    return ref.IpkFile(k, float(np.float32(omega)), keys[order].astype(
        np.uint64), fv[order].astype(np.float32), counts[order].astype(
        np.uint64), branches, s[:, order].T[kt].astype(np.float32))


def compare(db: ref.IpkFile, logp: torch.Tensor, lay: ref.Layout,
            keys: np.ndarray, k: int, omega: float,
            limits: Dict[str, float]) -> Dict[str, float]:
    """The four numbers of ``db`` against the float32 reference over
    ``keys`` (sorted, unique uint64)."""
    eps = ref.eps_f32(omega, k)
    edge = limits["score_gap"]
    scores = ref.branch_scores(logp, lay, keys, k).float()
    fv_ref = ref.mif0(scores, eps, ref.threshold(omega, k),
                      lay.num_nodes).cpu().numpy()
    s_ref = scores.cpu().numpy().astype(np.float64)        # [B, K]
    del scores
    B, K = s_ref.shape

    order_off = int(db.kmer_size != k) + int(
        np.float32(db.omega) != np.float32(omega))
    order_off += int(np.count_nonzero(np.diff(db.fv) < 0))
    order_off += int(db.counts.sum() != len(db.branches))
    file_keys = np.sort(db.keys)
    order_off += int(np.count_nonzero(file_keys[1:] == file_keys[:-1]))

    offsets = np.zeros(len(db.keys) + 1, dtype=np.int64)
    np.cumsum(db.counts.astype(np.int64), out=offsets[1:])
    by_key = np.argsort(db.keys, kind="stable")
    at = np.minimum(np.searchsorted(db.keys[by_key], keys),
                    max(len(by_key) - 1, 0))
    found = (db.keys[by_key[at]] == keys if len(by_key)
             else np.zeros(K, dtype=bool))
    row = by_key[at[found]]
    col = np.flatnonzero(found)
    n = db.counts[row].astype(np.int64)
    e_col = np.repeat(col, n)
    first = np.repeat(offsets[row], n)
    e_idx = first + (np.arange(n.sum()) - np.repeat(
        np.cumsum(n) - n, n))
    rank_of = np.full(max(lay.num_nodes, int(db.branches.max(initial=0)) + 1),
                      -1, dtype=np.int64)
    rank_of[lay.branch_ids] = np.arange(B)
    rank = rank_of[db.branches[e_idx]]
    foreign = rank < 0
    same_key = e_col[1:] == e_col[:-1]
    order_off += int(np.count_nonzero(same_key & (rank[1:] <= rank[:-1])
                                      & ~foreign[1:] & ~foreign[:-1]))

    held = np.zeros((B, K), dtype=bool)
    s_db = np.full((B, K), np.nan)
    ok = ~foreign
    held[rank[ok], e_col[ok]] = True
    s_db[rank[ok], e_col[ok]] = db.scores[e_idx[ok]]
    kept = s_ref > eps
    both = held & kept
    score_gap = float(np.abs(s_db[both] - s_ref[both]).max(initial=0.0))
    one = (held ^ kept) & (np.abs(s_ref - eps) > edge)
    entries_off = int(np.count_nonzero(one)) + int(np.count_nonzero(foreign))

    common = found & kept.any(axis=0)
    fv_gap = 0.0
    if common.any():
        fv_db = np.zeros(K)
        fv_db[col] = db.fv[row]
        mag = np.abs(fv_ref[common])
        scale = np.maximum(mag, max(float(np.median(mag)),
                                    np.finfo(np.float64).tiny))
        fv_gap = float((np.abs(fv_db[common] - fv_ref[common]) / scale).max())
    return {"score_gap": score_gap, "fv_gap": fv_gap,
            "entries_off": entries_off, "order_off": order_off}


def sample_keys(k: int, count, seed: int) -> np.ndarray:
    """Sorted unique keys to compare: every key of the space when ``count``
    is "all", else ``count`` keys drawn from the seed."""
    space = ref.SIGMA ** k
    if count == "all" or int(count) >= space:
        return np.arange(space, dtype=np.uint64)
    rng = np.random.default_rng([seed % (1 << 63), 0xC0FFEE])
    return np.sort(rng.choice(space, size=int(count), replace=False)
                   ).astype(np.uint64)
