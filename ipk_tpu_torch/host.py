"""Host-side (numpy) stages of the build: key batching, progress, prefetch,
survivor extraction with the mif0/random filter, and the (fv, key) sort.

These are copies of the numpy helpers of ``ipk_tpu/builder.py``
(``log_threshold_f32``, ``pick_key_batches``, ``_Progress``,
``BuildResult``, ``_prefetch``, ``_extract_batch``, ``_extract_compact``,
``_extract_from_lists``, ``_extract_sorted_stream``, ``_sort_batch``,
``_apply_range_gather``, ``_range_gather``, and the ``--on-disk`` merge
``_MergeBuffer`` and ``_merge_on_disk``). They are copied because that
module imports jax at the top, and the port runs where jax is not
installed. They stay copies while ``ipk_tpu`` is the frozen reference, and
write the same bytes. Where they depart from it:

* the extractors and the merge record spans and counters on the build's
  ``spans.Recorder``;
* ``_merge_on_disk`` writes its column sections to ``merge/`` beside the
  sorted parts (``<working_dir>/hashmaps/merge`` in a build), where
  ``ipk_tpu`` writes them beside the output (``<output>.merge``), which
  lands in the null device's directory when the output is the null device
  and fails where the output's directory is read only.
* ``_merge_on_disk`` hands its header and sections to
  ``serialize.write_ipk``, the in-RAM ``save``'s writer, so both builds
  write one file for one database, where ``ipk_tpu`` deflates the merged
  file as one level-2 stream. The decompressed payload is unchanged.
"""

from __future__ import annotations

import ctypes
import os
import queue
import shutil
import sys
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from . import serialize
from .core.filter import (RandomFilterStream, _load_native,
                          mif0_filter_values_entries, score_threshold)
from .db import PhyloKmerDB
from .seq import SeqTraits, dense_index_to_key
from .spans import Recorder
from .utils.threads import host_threads

__all__ = ["log_threshold_f32", "pick_key_batches", "BuildResult"]


def log_threshold_f32(omega: float, sigma: int, k: int) -> np.float32:
    """log10((omega/sigma)^k) as f32 — the eps passed to the enumeration DP
    (``db_builder.cpp:640``)."""
    return np.float32(np.log10(score_threshold(omega, sigma, k)))


def pick_key_batches(B: int, nl: int, nr: int,
                     budget_bytes: int = 2 << 30,
                     vmem_tile_bytes: int = 4 << 20) -> int:
    """Number of prefix-axis batches so each A batch fits the host/device
    budget, each per-ghost accumulator tile [nl/batches, nr] stays within
    ``vmem_tile_bytes``, and each batch's flat indices fit int32. Equal
    slices, preferring a per-batch prefix count that is a multiple of 8."""
    total = B * nl * nr * 4
    batches = max(1, -(-total // budget_bytes),
                  -(-(nl * nr * 4) // vmem_tile_bytes),
                  -(-(B * nl * nr) // ((1 << 31) - 1)))
    for b in range(batches, nl + 1):
        if nl % b == 0 and (nl // b) % 8 == 0:
            return b
    while batches < nl and nl % batches != 0:
        batches += 1
    return min(batches, nl)


class _Progress:
    """Per-key-batch stage-1 progress at verbosity >= 1 (the reference's
    per-branch-group bar, ``db_builder.cpp:588-600``). In-place bar on a
    TTY, one line per update otherwise."""

    def __init__(self, label: str, total: int, enabled: bool):
        self.label, self.total = label, total
        self.enabled = enabled and total > 0
        self.tty = sys.stderr.isatty()
        self.done = 0
        if self.enabled:
            self._draw()

    def step(self, n: int = 1) -> None:
        if not self.enabled:
            return
        self.done += n
        self._draw()

    def _draw(self) -> None:
        frac = self.done / self.total
        if self.tty:
            width = 30
            fill = int(width * frac)
            sys.stderr.write(f"\r{self.label} [{'#' * fill}"
                             f"{'.' * (width - fill)}] "
                             f"{self.done}/{self.total}")
            if self.done >= self.total:
                sys.stderr.write("\n")
            sys.stderr.flush()
        else:
            print(f"{self.label}: {self.done}/{self.total}", flush=True)


class BuildResult:
    """The database, the explored-tuple count, the stage timings and the
    spans they were summed from (``spans.Recorder``'s ``timings`` and
    ``spans``) and, for a sparse build, its telemetry in ``stats``
    ("redispatches", "final_caps", and "merge": "device", "host" or "host,
    after a bin overflow")."""

    def __init__(self, db: PhyloKmerDB, num_explored: int,
                 timings: Dict[str, float], stats: Optional[Dict] = None,
                 spans: Optional[list] = None):
        self.db = db
        self.num_explored = num_explored
        self.timings = timings
        self.stats = stats if stats is not None else {}
        self.spans = spans if spans is not None else []


def _prefetch(gen: Iterator, recorder: Recorder,
              depth: int = 1) -> Iterator:
    """Run the batch generator one step ahead in a worker thread, so the next
    batch's device work and device→host copy overlap the main thread's
    extraction of the current one. The worker's spans name the consumer's
    span open at the call as their parent; each wait for the next batch is
    a ``wait_stage1`` span."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    parent = recorder.current()

    def worker():
        recorder.adopt(parent)
        try:
            for item in gen:
                q.put(item)
            q.put(sentinel)
        except BaseException as e:          # surfaced in the consumer
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        with recorder.span("wait_stage1"):
            item = q.get()
        if item is sentinel:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _filter_values(scores: np.ndarray, offsets: np.ndarray,
                   total_num_groups: int, threshold: float, filter_type: str,
                   rng_stream: Optional[RandomFilterStream],
                   recorder: Recorder) -> np.ndarray:
    """The f64 filter value of each key whose entries' scores lie at
    ``scores[offsets[i]:offsets[i+1]]``: mif0 (a ``mif0`` span) or random."""
    n = len(offsets) - 1
    if filter_type == "mif0":
        with recorder.span("mif0"):
            return mif0_filter_values_entries(scores, None, n,
                                              total_num_groups, threshold,
                                              offsets=offsets)
    if filter_type == "random":
        return rng_stream.take(n).astype(np.float64)
    raise RuntimeError("Error: Unsupported filter type.")


def _extract_batch(A: np.ndarray, lo: int, pos: Optional[np.ndarray],
                   group_ids: List[int], k: int, traits: SeqTraits,
                   total_num_groups: int, threshold: float,
                   filter_type: str, rng_stream: Optional[RandomFilterStream],
                   merge_branches: bool, *, recorder: Recorder,
                   fv_override=None):
    """Dense batch A[B, chunk] → (keys, fv, counts, branches, scores,
    positions). ``fv_override`` holds the distributed f32 filter values per
    dense key index (``--device-mi``)."""
    mask = np.isfinite(A)
    if merge_branches:
        best_b = A.argmax(axis=0)
        cols_any = mask.any(axis=0)
        best_mask = np.zeros_like(mask)
        best_mask[best_b[cols_any], np.flatnonzero(cols_any)] = True
        mask = best_mask

    present = mask.any(axis=0)
    cols = np.flatnonzero(present)
    keys = dense_index_to_key(cols.astype(np.uint64) + np.uint64(lo),
                              k, traits)

    MT = np.ascontiguousarray(mask[:, cols].T)   # [K', B]
    flat = MT.ravel()
    counts = MT.sum(axis=1)
    branches = np.broadcast_to(
        np.asarray(group_ids, dtype=np.uint32), MT.shape).ravel()[flat]
    scores = np.ascontiguousarray(A[:, cols].T).ravel()[flat]
    positions = (np.ascontiguousarray(pos[:, cols].T).ravel()[flat]
                 .astype(np.uint32) if pos is not None else None)

    if fv_override is not None:
        fv = fv_override[cols + lo].astype(np.float64)
    else:
        offsets = np.zeros(len(cols) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        fv = _filter_values(scores, offsets, total_num_groups, threshold,
                            filter_type, rng_stream, recorder)
    return keys, fv, counts, branches, scores, positions


def _extract_compact(flat_idx: np.ndarray, scores: np.ndarray, B: int,
                     chunk: int, lo: int, group_ids, k: int,
                     traits: SeqTraits, total_num_groups: int,
                     threshold: float, filter_type: str,
                     rng_stream: Optional[RandomFilterStream],
                     merge_branches: bool, *, recorder: Recorder):
    """Compacted batch → unsorted DB arrays (same contract as
    :func:`_extract_batch`). flat_idx is row-major over the TRANSPOSED
    accumulator [chunk, B]: ascending flat index is already key-major with
    groups ascending within a key (the DB's entry order)."""
    flat_idx = np.asarray(flat_idx)
    scores = np.asarray(scores, dtype=np.float32)
    key_local, b_rows = np.divmod(flat_idx, np.int32(B))
    if merge_branches:
        # best entry per key (ties -> lowest group row)
        sub = np.lexsort((b_rows, -scores.astype(np.float64), key_local))
        ks, ss, bs = key_local[sub], scores[sub], b_rows[sub]
        first = np.ones(len(ks), dtype=bool)
        first[1:] = ks[1:] != ks[:-1]
        key_local, scores, b_rows = ks[first], ss[first], bs[first]

    first = np.ones(len(key_local), dtype=bool)
    if len(key_local):
        first[1:] = key_local[1:] != key_local[:-1]
    bounds = np.flatnonzero(first)
    offsets = np.append(bounds, len(key_local)).astype(np.int64)
    uniq = key_local[bounds]
    keys = dense_index_to_key(uniq.astype(np.uint64) + np.uint64(lo), k,
                              traits)
    counts = np.diff(offsets)
    branches = np.asarray(group_ids, dtype=np.uint32)[b_rows]

    fv = _filter_values(scores, offsets, total_num_groups, threshold,
                        filter_type, rng_stream, recorder)
    return keys, fv, counts, branches, np.asarray(scores, np.float32), None


def _extract_from_lists(per_branch, group_ids, total_num_groups: int,
                        threshold: float, filter_type: str,
                        rng_stream: Optional[RandomFilterStream],
                        merge_branches: bool, *, recorder: Recorder):
    """Per-branch sparse lists → unsorted DB arrays (keys, fv, counts,
    branches, scores, positions=None). Entry order per key = group order."""
    if not per_branch:
        z = np.zeros(0)
        return (z.astype(np.uint64), z, z.astype(np.int64),
                z.astype(np.uint32), z.astype(np.float32), None)
    all_keys = np.concatenate([c for c, _ in per_branch])
    all_scores = np.concatenate([s for _, s in per_branch])
    all_border = np.concatenate(
        [np.full(len(c), bi, dtype=np.int64)
         for bi, (c, _) in enumerate(per_branch)])
    order = np.lexsort((all_border, all_keys))  # key-major, group order
    all_keys, all_scores, all_border = (all_keys[order], all_scores[order],
                                        all_border[order])
    return _extract_sorted_stream(all_keys, all_border, all_scores,
                                  group_ids, total_num_groups, threshold,
                                  filter_type, rng_stream, merge_branches,
                                  recorder=recorder)


def _extract_sorted_stream(all_keys, all_border, all_scores, group_ids,
                           total_num_groups: int, threshold: float,
                           filter_type: str,
                           rng_stream: Optional[RandomFilterStream],
                           merge_branches: bool, *, recorder: Recorder):
    """(key, group)-sorted entry stream (per-pair max scores) → unsorted DB
    arrays."""
    if merge_branches:
        # keep only the best-scoring entry per key (earliest group on ties)
        sub = np.lexsort((all_border, -all_scores.astype(np.float64),
                          all_keys))
        ks, ss, bs = all_keys[sub], all_scores[sub], all_border[sub]
        first = np.ones(len(ks), dtype=bool)
        first[1:] = ks[1:] != ks[:-1]
        all_keys, all_scores, all_border = ks[first], ss[first], bs[first]

    first = np.ones(len(all_keys), dtype=bool)
    first[1:] = all_keys[1:] != all_keys[:-1]
    bounds = np.flatnonzero(first)
    offsets = np.append(bounds, len(all_keys)).astype(np.int64)
    keys = all_keys[bounds]
    counts = np.diff(offsets)
    branches = np.asarray(group_ids, dtype=np.uint32)[all_border]

    fv = _filter_values(all_scores, offsets, total_num_groups, threshold,
                        filter_type, rng_stream, recorder)
    return keys, fv, counts, branches, np.asarray(all_scores, np.float32), None


def _sort_batch(keys, fv, counts, branches, scores, positions):
    """Reorder one batch's arrays ascending by (fv, key)."""
    order = np.lexsort((keys, fv))
    offsets = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    new_offsets, branches, scores, positions = _apply_range_gather(
        offsets, np.asarray(counts, dtype=np.int64), order, branches, scores,
        positions)
    return (keys[order], fv[order], new_offsets, branches, scores, positions)


def _apply_range_gather(offs, counts, order, branches, scores, positions):
    """Concatenate entry ranges [offs[i], offs[i]+counts[i]) for i in
    ``order``, applied to the entry columns: the entry permutation behind
    the global (fv, key) sort. Threaded native implementation
    (``native/mif0_filter.cpp::ipk_range_gather_apply``) with a numpy
    fallback."""
    new_offsets = np.zeros(len(order) + 1, dtype=np.int64)
    np.cumsum(counts[order], out=new_offsets[1:])
    lib = _load_native()
    if lib is not None and hasattr(lib, "ipk_range_gather_apply"):
        i64p = ctypes.POINTER(ctypes.c_int64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        f32p = ctypes.POINTER(ctypes.c_float)
        offs = np.ascontiguousarray(offs, np.int64)
        counts = np.ascontiguousarray(counts, np.int64)
        order = np.ascontiguousarray(order, np.int64)
        branches = np.ascontiguousarray(branches, np.uint32)
        scores = np.ascontiguousarray(scores, np.float32)
        br_out = np.empty_like(branches)
        sc_out = np.empty_like(scores)
        if positions is not None:
            positions = np.ascontiguousarray(positions, np.uint32)
            pos_out = np.empty_like(positions)
            pos_in_p = positions.ctypes.data_as(u32p)
            pos_out_p = pos_out.ctypes.data_as(u32p)
        else:
            pos_out, pos_in_p, pos_out_p = None, u32p(), u32p()
        nthreads = host_threads("IPK_TPU_FILTER_THREADS")
        lib.ipk_range_gather_apply(
            offs.ctypes.data_as(i64p), counts.ctypes.data_as(i64p),
            order.ctypes.data_as(i64p), new_offsets.ctypes.data_as(i64p),
            np.int64(len(order)), branches.ctypes.data_as(u32p),
            scores.ctypes.data_as(f32p), pos_in_p,
            br_out.ctypes.data_as(u32p), sc_out.ctypes.data_as(f32p),
            pos_out_p, np.int32(nthreads))
        return new_offsets, br_out, sc_out, pos_out
    gather = _range_gather(offs, counts, order)
    return (new_offsets, branches[gather], scores[gather],
            None if positions is None else positions[gather])


def _range_gather(offs: np.ndarray, counts: np.ndarray,
                  order: np.ndarray) -> np.ndarray:
    """Entry-gather permutation for reordering variable-length entry runs:
    concatenation of ranges [offs[i], offs[i]+counts[i]) for i in order."""
    reps = counts[order]
    total = int(reps.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = offs[order]
    out_offs = np.zeros(len(order) + 1, dtype=np.int64)
    np.cumsum(reps, out=out_offs[1:])
    idx = np.arange(total, dtype=np.int64)
    run = np.repeat(np.arange(len(order), dtype=np.int64), reps)
    return starts[run] + (idx - out_offs[run])


class _MergeBuffer:
    """One loader's resident rows during the out-of-core merge."""

    def __init__(self, loader: "serialize.BatchLoader", block_rows: int):
        self.loader = loader
        self.block_rows = block_rows
        self.cols: Optional[tuple] = None    # (keys, fvs, counts, br, sc, po)

    def fill(self) -> None:
        if self.cols is None:
            block = self.loader.read_block(self.block_rows)
            if block is not None:
                self.cols = block

    @property
    def rows(self) -> int:
        return 0 if self.cols is None else len(self.cols[0])

    def bound(self):
        """(fv, key) of the last resident row — rows still on disk all sort
        at or after it (the batch file is sorted ascending)."""
        keys, fvs = self.cols[0], self.cols[1]
        return (fvs[-1], keys[-1])

    def take_upto(self, cut) -> Optional[tuple]:
        """Split off the prefix with (fv, key) <= cut (None keeps all)."""
        keys, fvs, counts, br, sc, po = self.cols
        if cut is None:
            m = len(keys)
        else:
            cut_fv, cut_key = cut
            mask = (fvs < cut_fv) | ((fvs == cut_fv) & (keys <= cut_key))
            m = int(mask.sum())     # sorted buffer: the mask is a prefix
        if m == 0:
            return None
        ne = int(counts[:m].sum())
        taken = (keys[:m], fvs[:m], counts[:m], br[:ne], sc[:ne],
                 None if po is None else po[:ne])
        if m == len(keys):
            self.cols = None
        else:
            self.cols = (keys[m:], fvs[m:], counts[m:], br[ne:], sc[ne:],
                         None if po is None else po[ne:])
        return taken


def _merge_on_disk(db: PhyloKmerDB, temp_files: List[str],
                   output_filename: Optional[str], uncompressed: bool,
                   positions: bool = False,
                   block_rows: int = 1 << 16, *,
                   recorder: Optional[Recorder] = None) -> None:
    """Out-of-core merge of sorted batch DBs into the output archive
    (``merge_stage2``, ``db_builder.cpp:392-458``).

    Batches are key-disjoint and internally sorted ascending by (fv, key), so
    a streaming merge yields the global order. The reference advances one
    record at a time through a priority queue of lazy cursors; the vectorized
    equivalent advances one *block* at a time: refill every buffer, cut at
    the smallest last-resident (fv, key) among loaders that still have rows
    on disk (rows beyond a cut cannot interleave before it), lexsort the cut
    prefix, spill its columns to section files in ``merge/`` beside the
    parts, and finally hand the header and the section files to
    ``serialize.write_ipk``; the sections' directory is removed after. Peak
    memory is O(block_rows · num_batches), independent of database size.

    On ``recorder`` the block loop is the span ``merge.blocks`` and the
    write the span ``merge.write``; ``merge_blocks`` counts the rounds that
    took rows and ``merge_rows`` the rows merged, and a compressed write
    adds the writer's counts as ``merge_write_stored_bytes``,
    ``merge_write_deflated_bytes`` and ``merge_write_chunks``.
    """
    if not output_filename:
        raise RuntimeError("--on-disk requires an output filename")
    rec = recorder if recorder is not None else Recorder()
    loaders = [serialize.BatchLoader(f, block_rows=block_rows)
               for f in temp_files]
    total_kmers = sum(l.get_num_kmers() for l in loaders)
    total_entries = sum(l.header.num_entries for l in loaders)
    buffers = [_MergeBuffer(l, block_rows) for l in loaders]

    # the table's columns, in the order of a block's tuple
    columns = serialize.columns(positions)
    spill_dir = os.path.join(os.path.dirname(temp_files[0]), "merge")
    os.makedirs(spill_dir, exist_ok=True)
    paths = {name: os.path.join(spill_dir, name + ".bin")
             for name, _, _ in columns}
    spills = {name: open(path, "wb") for name, path in paths.items()}
    try:
        with rec.span("merge.blocks"):
            while True:
                for b in buffers:
                    b.fill()
                live = [b for b in buffers if b.rows]
                if not live:
                    break
                bounding = [b.bound() for b in live
                            if b.loader.rows_left() > 0]
                cut = min(bounding) if bounding else None
                taken = [t for b in live
                         if (t := b.take_upto(cut)) is not None]
                if not taken:       # all resident rows sort after the cut
                    continue
                rows = [np.concatenate([t[i] for t in taken])
                        for i in range(3)]         # keys, fvs, counts
                keys, fvs, counts = rows
                rec.add("merge_blocks", 1)
                rec.add("merge_rows", len(keys))
                order = np.lexsort((keys, fvs))
                offs = np.zeros(len(keys) + 1, dtype=np.int64)
                np.cumsum(counts, out=offs[1:])
                gather = _range_gather(offs, counts, order)
                for i, (name, dtype, per_kmer) in enumerate(columns):
                    col = (rows[i][order] if per_kmer else
                           np.concatenate([t[i] for t in taken])[gather])
                    spills[name].write(
                        np.ascontiguousarray(col, dtype).tobytes())
    finally:
        for f in spills.values():
            f.close()
        for l in loaders:
            l.close()

    with rec.span("merge.write"):
        written = serialize.write_ipk(
            output_filename,
            serialize._header_bytes(db, total_kmers, total_entries), paths,
            compressed=not uncompressed)
        for name, n in written.items():
            rec.add("merge_write_" + name, n)
    shutil.rmtree(spill_dir, ignore_errors=True)
