"""Placement of query sequences against a phylo-k-mer database on a torch
device: the counterpart of ``ipk_tpu/placement.py``'s device scorer.

:class:`TorchPlacementIndex` holds the database as a dense score matrix
``M[K+2, B]`` float32 on one device, as ``TpuPlacementIndex`` does: row r < K
holds the r-th key's per-branch log10 scores with the threshold imputed for
absent branches, row K is the all-threshold row of a k-mer absent from the
database, row K+1 is all zero (a window with an ambiguity or gap contributes
nothing). Window keys map to rows on the host (a dense lookup table where
σ^k ≤ 2^26, ``searchsorted`` otherwise); the device sums each query's rows
(``embedding_bag``) and ranks the branches, in fixed ``device_batch``
chunks, and ships only the top ``top`` columns back. This is not a kernel
in ``ipk_tpu`` either (a jitted gather and sum), so plain torch is the port.

The host scorer (:class:`PlacementIndex` and the "host" engine of
:func:`place_queries`), ``_rank`` and :func:`write_jplace` are copies of
``ipk_tpu/placement.py``'s, unchanged but for their imports.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from . import device as device_mod
from .core.filter import score_threshold
from .db import PhyloKmerDB
from .seq import get_traits

__all__ = ["PlacementIndex", "TorchPlacementIndex", "place_queries",
           "write_jplace"]

#: the largest key space that gets a dense key -> row lookup table
_ROW_LUT_SPACE = 1 << 26


class PlacementIndex:
    """Key-sorted view of a DB for vectorized batch lookups."""

    def __init__(self, db: PhyloKmerDB):
        self.db = db
        traits = get_traits(db.sequence_type)
        self.traits = traits
        self.k = db.kmer_size
        order = np.argsort(db.keys, kind="stable")
        self.sorted_keys = db.keys[order]
        # entries flattened in key-sorted order
        counts = np.diff(db.offsets)[order]
        self.entry_offsets = np.zeros(len(order) + 1, dtype=np.int64)
        np.cumsum(counts, out=self.entry_offsets[1:])
        gather = np.concatenate(
            [np.arange(db.offsets[i], db.offsets[i + 1]) for i in order]
        ) if len(order) else np.zeros(0, np.int64)
        self.entry_branches = db.branches[gather]
        self.entry_scores = db.scores[gather].astype(np.float64)
        # branch id -> dense column
        self.branch_ids = np.unique(db.branches)
        self.branch_col = {int(b): i for i, b in enumerate(self.branch_ids)}
        self._col_lut = np.zeros(int(self.branch_ids.max()) + 1
                                 if len(self.branch_ids) else 1,
                                 dtype=np.int64)
        self._col_lut[self.branch_ids] = np.arange(len(self.branch_ids))
        self._entry_cols = self._col_lut[self.entry_branches]
        self.log_threshold = np.log10(
            score_threshold(db.omega, traits.alphabet_size, db.kmer_size))

    def query_kmers(self, sequence: str) -> np.ndarray:
        """Packed keys of all clean k-length windows of the query."""
        lut = self.traits.codes_lut()
        codes = lut[np.frombuffer(sequence.encode("ascii"), np.uint8)]
        k = self.k
        if len(codes) < k:
            return np.zeros(0, dtype=np.uint64)
        win = np.lib.stride_tricks.sliding_window_view(codes, k)
        clean = (win >= 0).all(axis=1)
        win = win[clean].astype(np.uint64)
        bits = np.uint64(self.traits.bits_per_symbol)
        keys = np.zeros(len(win), dtype=np.uint64)
        for i in range(k):
            keys = (keys << bits) | win[:, i]
        return keys

    def score_query(self, sequence: str) -> Tuple[np.ndarray, np.ndarray, int]:
        """Per-branch total log10 score for one query.

        Returns (branch_ids, scores, num_query_kmers). Branches never seen in
        the DB keep the all-absent baseline.
        """
        keys = self.query_kmers(sequence)
        n_branch = len(self.branch_ids)
        total = np.full(n_branch, self.log_threshold * len(keys),
                        dtype=np.float64)
        if len(keys) == 0:
            return self.branch_ids, total, 0
        pos = np.searchsorted(self.sorted_keys, keys)
        pos = np.clip(pos, 0, len(self.sorted_keys) - 1)
        hit_pos = pos[self.sorted_keys[pos] == keys]
        if len(hit_pos):
            # expand [lo, hi) entry ranges of all hits without a Python loop
            lo = self.entry_offsets[hit_pos]
            lens = self.entry_offsets[hit_pos + 1] - lo
            starts = np.repeat(lo, lens)
            offs = (np.arange(lens.sum())
                    - np.repeat(np.cumsum(lens) - lens, lens))
            flat = starts + offs
            np.add.at(total, self._entry_cols[flat],
                      self.entry_scores[flat] - self.log_threshold)
        return self.branch_ids, total, len(keys)


class TorchPlacementIndex:
    """Device-resident placement index for batch scoring."""

    def __init__(self, db: PhyloKmerDB,
                 device: device_mod.DeviceLike = "cuda"):
        self.device = device_mod.resolve(device)
        self.host = PlacementIndex(db)
        h = self.host
        K = len(h.sorted_keys)
        B = len(h.branch_ids)
        M = np.full((K + 2, B), h.log_threshold, dtype=np.float32)
        rows = np.repeat(np.arange(K),
                         np.diff(h.entry_offsets).astype(np.int64))
        M[rows, h._entry_cols] = h.entry_scores.astype(np.float32)
        M[K + 1] = 0.0
        self.K = K
        self.M = torch.from_numpy(M).to(self.device)
        space = h.traits.alphabet_size ** h.k
        if space <= _ROW_LUT_SPACE:
            self._row_lut = np.full(space, K, dtype=np.int32)
            self._row_lut[h.sorted_keys.astype(np.int64)] = np.arange(
                K, dtype=np.int32)
        else:
            self._row_lut = None

    def _rows(self, keys_pad: np.ndarray, valid_pad: np.ndarray) -> np.ndarray:
        """Map packed window keys to M rows (K = miss, K+1 = invalid)."""
        h = self.host
        if self._row_lut is not None:
            found = self._row_lut[keys_pad.astype(np.int64)]
            return np.where(valid_pad, found,
                            np.int32(self.K + 1)).astype(np.int32)
        pos = np.searchsorted(h.sorted_keys, keys_pad).clip(0, self.K - 1)
        hit = (h.sorted_keys[pos] == keys_pad) & valid_pad
        return np.where(hit, pos,
                        np.where(valid_pad, self.K, self.K + 1)
                        ).astype(np.int32)

    def _window_keys(self, sequences: List[str]):
        """[Q, Wmax] packed window keys and their validity for a batch."""
        h = self.host
        k = h.k
        lut = h.traits.codes_lut()
        bits = np.uint64(h.traits.bits_per_symbol)
        Lmax = max((len(s) for s in sequences), default=k)
        Lmax = max(Lmax, k)
        if sequences and all(len(s) == Lmax for s in sequences):
            # uniform read length: one decode of the joined reads
            buf = np.frombuffer("".join(sequences).encode("ascii"),
                                np.uint8).reshape(len(sequences), Lmax)
        else:
            # ragged: pad to Lmax with an invalid byte
            buf = np.full((len(sequences), Lmax), ord("-"), dtype=np.uint8)
            for qi, s in enumerate(sequences):
                buf[qi, :len(s)] = np.frombuffer(s.encode("ascii"), np.uint8)
        codes = lut[buf]                                    # [Q, Lmax]
        Q, W = len(sequences), Lmax - k + 1
        # validity by a cumulative bad-symbol count
        bad_count = np.zeros((Q, Lmax + 1), dtype=np.int32)
        np.cumsum(codes < 0, axis=1, out=bad_count[:, 1:])
        valid = (bad_count[:, k:] - bad_count[:, :-k]) == 0  # [Q, W]
        # rolling MSB-first packing
        cu = np.where(codes < 0, 0, codes).astype(np.uint64)
        mask = np.uint64((1 << (int(bits) * k)) - 1)
        acc = np.zeros(Q, dtype=np.uint64)
        keys = np.empty((Q, W), dtype=np.uint64)
        for j in range(Lmax):
            acc = ((acc << bits) | cu[:, j]) & mask
            if j >= k - 1:
                keys[:, j - k + 1] = acc
        return keys, valid

    def _chunks(self, sequences: List[str], device_batch: int):
        """(start, rows [bq, W] int64 on the device) per fixed-size chunk,
        the last padded with the all-zero row, and the window validity."""
        keys_pad, valid_pad = self._window_keys(sequences)
        rows = self._rows(keys_pad, valid_pad)
        Q = len(sequences)
        bq = min(device_batch, max(Q, 1))
        chunks = []
        for start in range(0, Q, bq):
            chunk = rows[start:start + bq]
            if len(chunk) < bq:
                fill = np.full((bq - len(chunk), rows.shape[1]), self.K + 1,
                               dtype=np.int32)
                chunk = np.concatenate([chunk, fill])
            chunks.append((start, torch.from_numpy(
                chunk.astype(np.int64)).to(self.device)))
        return chunks, valid_pad

    def _totals(self, rows: torch.Tensor) -> torch.Tensor:
        """[bq, W] rows -> [bq, B] per-branch sums on the device."""
        return torch.nn.functional.embedding_bag(rows, self.M, mode="sum")

    def place_batch(self, sequences: List[str], device_batch: int = 2048):
        """Per-branch totals for a batch of query sequences.

        Returns (branch_ids [B], totals [Q, B] float32, k-mer counts [Q]).
        """
        h = self.host
        Q = len(sequences)
        chunks, valid_pad = self._chunks(sequences, device_batch)
        totals = np.empty((Q, len(h.branch_ids)), dtype=np.float32)
        outs = [(start, self._totals(rows)) for start, rows in chunks]
        for start, out in outs:
            n = min(len(out), Q - start)
            totals[start:start + n] = out[:n].cpu().numpy()
        return h.branch_ids, totals, valid_pad.sum(axis=1)

    def place_batch_topk(self, sequences: List[str], top: int = 7,
                         device_batch: int = 2048):
        """Device-ranked scoring: per query, the ``top`` best branches.

        Returns (branch_ids [Q, top], scores [Q, top] float32, k-mer counts
        [Q]). The order is ``jax.lax.top_k``'s: descending, the lower branch
        column first at an exact tie (a stable descending sort).
        """
        h = self.host
        Q = len(sequences)
        top = min(top, len(h.branch_ids))
        chunks, valid_pad = self._chunks(sequences, device_batch)
        scores = np.empty((Q, top), dtype=np.float32)
        cols = np.empty((Q, top), dtype=np.int64)
        outs = []
        for start, rows in chunks:
            vals, idx = torch.sort(self._totals(rows), dim=1,
                                   descending=True, stable=True)
            outs.append((start, vals[:, :top], idx[:, :top]))
        for start, vals, idx in outs:
            n = min(len(vals), Q - start)
            scores[start:start + n] = vals[:n].cpu().numpy()
            cols[start:start + n] = idx[:n].cpu().numpy()
        return h.branch_ids[cols], scores, valid_pad.sum(axis=1)


def _rank(name: str, branch_ids: np.ndarray, totals: np.ndarray,
          top: int) -> Dict:
    order = np.argsort(-totals.astype(np.float64), kind="stable")[:top]
    sel = totals[order].astype(np.float64)
    weights = np.power(10.0, sel - sel.max())
    weights /= weights.sum()
    return {"p": [[int(branch_ids[i]), float(totals[i]), float(w)]
                  for i, w in zip(order, weights)],
            "n": [name]}


def place_queries(db: PhyloKmerDB, queries: Iterable[Tuple[str, str]],
                  top: int = 7, engine: str = "auto",
                  batch_size: int = 4096,
                  device: device_mod.DeviceLike = "cuda") -> List[Dict]:
    """Rank branches for each (name, sequence) query. Returns jplace-style
    placement dicts, as ``ipk_tpu.placement.place_queries`` does.

    engine: "host" (per-query numpy, ``ipk_tpu``'s scorer), "device"
    (:class:`TorchPlacementIndex` on ``device``) or "auto" (the device from
    64 queries on).
    """
    queries = list(queries)
    if engine == "auto":
        engine = "device" if len(queries) >= 64 else "host"
    if engine == "host":
        index = PlacementIndex(db)
        placements = []
        for name, seq in queries:
            branch_ids, totals, _ = index.score_query(seq)
            if len(branch_ids) == 0:
                continue
            placements.append(_rank(name, branch_ids,
                                    totals.astype(np.float32), top))
        return placements
    if engine != "device":
        raise ValueError(f"unknown placement engine {engine!r}: use auto, "
                         "host or device")
    index = TorchPlacementIndex(db, device)
    placements = []
    for start in range(0, len(queries), batch_size):
        chunk = queries[start:start + batch_size]
        ids, scores, _ = index.place_batch_topk([s for _, s in chunk],
                                                top=top)
        if ids.shape[1] == 0:
            continue
        for qi, (name, _) in enumerate(chunk):
            sel = scores[qi].astype(np.float64)
            weights = np.power(10.0, sel - sel.max())
            weights /= weights.sum()
            placements.append(
                {"p": [[int(b), float(s), float(w)]
                       for b, s, w in zip(ids[qi], scores[qi], weights)],
                 "n": [name]})
    return placements


def write_jplace(db: PhyloKmerDB, placements: List[Dict], path: str) -> None:
    """jplace v3 container; edge numbers are original-tree postorder ids,
    annotated into the tree string as {N}."""
    from .tree import PhyloNode, parse_newick

    tree = parse_newick(db.tree)

    def annotate(node: PhyloNode) -> str:
        if node.children:
            inner = ",".join(annotate(c) for c in node.children)
            body = f"({inner}){node.label}"
        else:
            body = node.label
        if node.parent is not None:
            return f"{body}:{node.branch_length}{{{node.postorder_id}}}"
        return body

    doc = {
        "version": 3,
        "tree": annotate(tree.root) + ";",
        "placements": placements,
        "fields": ["edge_num", "likelihood", "like_weight_ratio"],
        "metadata": {"software": "ipk-tpu"},
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
