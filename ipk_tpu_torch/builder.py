"""Database build orchestrator on PyTorch: the counterpart of
``ipk_tpu/builder.py``, on one device or over the ranks of a
``torch.distributed`` world.

* stage 1, dense path (σ^k < 2^24): the ghost tensor P_all [G, S, σ], its
  bound-oracle prefix [G, S+1] and the f32 eps move to the device
  (:func:`stage1_state`); ``dense.masked_halves`` makes the half tensors
  once, and per key batch the ``combine_max`` kernel and ``dense.group_max``
  make the per-branch accumulator A[B, chunk], which the
  ``extract_columns`` kernel turns into the batch's database columns and
  their f64 mif0 values (stage 2 on the device), so only those cross to the
  host.
* stage 1, sparse path (σ^k ≥ 2^24: DNA k ≥ 12, AA k ≥ 6, or ``sparse=True``):
  a host probe sizes per-span survivor caps, ``sparse.enumerate_sparse_many``
  builds every window's survivor list on the device (the
  ``staircase_select`` kernel per span), 32 ghosts at a time, and the host
  merges each branch's windows by insert-or-max
  (:func:`_enumerate_sparse_branches`).
* ``keep_positions`` (dense path only): the positions mode of the kernel,
  ``combine_max_with_positions``, and ``dense.group_max_with_positions`` keep
  the earliest window of each score; the dense A and pos cross to the host.
* stage 2: extraction + mif0/random filter (``host``), except for the dense
  path without positions, which does it on the device; the random filter's
  values are always drawn on the host, in ascending key order.
* stage 3: global ascending (fv, key) sort and one streaming write; with
  ``on_disk``, each key batch (or the one sparse part) is sorted and saved
  under ``<working_dir>/hashmaps/``, then ``host._merge_on_disk`` merges them
  into the output and the directory is removed.

Over several ranks (a ``torch.distributed`` world of more than one rank,
unless ``IPK_TPU_NO_SHARD=1``) every path shards the branch axis as
``ipk_tpu`` shards it over its mesh (``parallel/``): every rank holds the
whole input, enumerates its slice of the ghosts (padded to whole groups) and
gathers the rest, so every rank writes the same database, equal to the
one-device build. The dense and positions paths gather A (and pos) per key
batch; the sparse path merges on the devices (``parallel.key_merge``, within
``_DEVICE_MERGE_BUDGET_BYTES``, else per 32-ghost chunk on the host);
``device_mi`` computes the mif0 filter as collectives in f32
(``parallel.build_sharded``). On one rank ``device_mi`` falls back to the
host f64 filter with ``ipk_tpu``'s note.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from . import device as device_mod
from . import serialize
from .ar.mapping import gather_ghost_tensor, ghost_groups
from .core import dense
from .core import sparse as sparse_mod
from .core.filter import RandomFilterStream, score_threshold
from .core.kernels import (combine_max, combine_max_with_positions,
                           extract_columns)
from .db import PhyloKmerDB
# _extract_compact stays a name of this module for portbench/harness.py,
# whose traced runs wrap it
from .host import (BuildResult, _extract_batch, _extract_compact,  # noqa: F401
                   _extract_from_lists, _extract_sorted_stream,
                   _merge_on_disk, _prefetch, _Progress, _sort_batch,
                   log_threshold_f32, pick_key_batches)
from .parallel import key_merge
from .parallel.build_sharded import pad_ghosts, sharded_batched_build_step
from .parallel.mesh import make_mesh, world_size
from .seq import SeqTraits, dense_index_to_key
from .spans import Recorder
from .tree import PhyloTree, to_newick
from .utils.malloc_tune import retain_heap

__all__ = ["build", "stage1_inputs", "stage1_state", "choose_key_batches",
           "Stage1Inputs", "BuildResult", "MAX_DENSE_KEYSPACE"]

#: candidate spaces at or above this size take the sparse path
MAX_DENSE_KEYSPACE = 1 << 24

#: working-set ceiling of the single-dispatch device key merge; above it the
#: chunked host merge takes over (the sparse chunker's budget)
_DEVICE_MERGE_BUDGET_BYTES = 4 << 30


class Stage1Inputs(NamedTuple):
    """The numpy inputs of stage 1, derived as ``ipk_tpu`` derives them."""
    P_all: np.ndarray        # [G, S, σ] f32 ghost posteriors
    prefix_all: np.ndarray   # [G, S+1] f32 bound-oracle prefix
    eps: np.float32          # log10 threshold
    ghosts_per_group: int    # ghost matrices per branch (G = groups x this)
    group_ids: List[int]     # original postorder id of each branch


def stage1_inputs(original_tree: PhyloTree, extended_tree: PhyloTree,
                  ghost_mapping: Dict[str, int], ar_mapping: Dict[str, str],
                  label_rows: Dict[str, int], P: np.ndarray, *, sigma: int,
                  kmer_size: int, omega: float,
                  ghost_strategy: str = "both") -> Stage1Inputs:
    """Gather the ghost posteriors of every branch and derive their prefix
    and eps (``ipk_tpu/builder.py`` stage-1 inputs)."""
    groups, group_ids = ghost_groups(extended_tree, original_tree,
                                     ghost_mapping, ghost_strategy)
    P_all = np.asarray(gather_ghost_tensor(groups, ar_mapping, label_rows, P),
                       dtype=np.float32)
    return Stage1Inputs(P_all, dense.best_score_prefix(P_all),
                        log_threshold_f32(omega, sigma, kmer_size),
                        len(groups[0]) if groups else 1, group_ids)


def choose_key_batches(n_groups: int, nl: int, nr: int,
                       keep_positions: bool = False) -> int:
    """The number of key batches a build splits its accumulator into."""
    key_batches = pick_key_batches(n_groups, nl, nr)
    # split big accumulators into a few batches even when memory alone would
    # not require it, so the next batch's device work and copy overlap the
    # main thread's work on the current batch; positions builds keep the
    # memory rule alone, as ipk_tpu's do
    if not keep_positions and n_groups * nl * nr * 4 > (16 << 20):
        for cand in (4, 2):
            if key_batches < cand and nl % cand == 0:
                return cand
    return key_batches


def stage1_state(P_all: np.ndarray, prefix_all: np.ndarray, eps,
                 device) -> tuple:
    """The build's state as the port's tensors on ``device``: the ghost
    posteriors P_all [G, S, σ] f32, their bound-oracle prefix [G, S+1] f32
    and eps as a 0-d f32 tensor. Takes the same numpy arrays ipk_tpu does."""
    dev = device_mod.resolve(device)
    P = torch.from_numpy(np.ascontiguousarray(P_all, np.float32)).to(dev)
    prefix = torch.from_numpy(
        np.ascontiguousarray(prefix_all, np.float32)).to(dev)
    eps_t = torch.tensor(np.float32(eps), dtype=torch.float32, device=dev)
    return P, prefix, eps_t


def _enumerate_batches(P_all: np.ndarray, prefix_all: np.ndarray, *,
                       k: int, sigma: int, eps: np.float32,
                       ghosts_per_group: int, key_batches: int,
                       device: torch.device,
                       recorder: Optional[Recorder] = None,
                       keep_positions: bool = False,
                       mesh=None, group_ids: Optional[List[int]] = None,
                       filter_args: Optional[tuple] = None
                       ) -> Iterator[tuple]:
    """Yield per key batch ("columns", lo, counts, fv, branches, scores,
    count); ``count`` is the batch's explored-tuple total
    (``db_builder.cpp:576-626``). Positions builds yield ("dense", lo, A,
    pos, count) with the dense A and pos [B, chunk] instead.

    A "columns" batch is stage 2 done on the device by ``extract_columns``
    from A, the ``group_ids`` and ``filter_args`` (the extractors'
    (total_num_groups, threshold, filter_type, rng_stream, merge_branches),
    which positions builds do not need):
    counts [chunk] int32 and, for mif0, fv [chunk] f64 per key column of the
    batch (else fv None), branches [E] uint32 and scores [E] f32 per entry
    in the DB's entry order. Each adds 1 to the ``card_extract_batches``
    counter.

    With ``mesh``, ghosts are padded to the branch axis in whole groups,
    each rank combines its slice, and every key batch's A (and pos) is
    gathered and trimmed and its count summed over the ranks, so every rank
    yields the one-device batches (enumeration has no cross-branch
    arithmetic).

    ``recorder`` gains ``device_compute`` (the device's time for the halves
    and each batch's work: the ``stage1.halves`` and ``stage1.batch``
    spans, each ended by a synchronize; the column pass of
    ``extract_columns`` is also its ``mif0`` span), ``transfer`` (the
    device's time for the device→host copies of the batch payloads, made
    here in the prefetch worker so batch N+1's copy overlaps the main
    thread's work on batch N) and ``transfer_bytes``.
    """
    rec = recorder if recorder is not None else Recorder()
    hl = k // 2
    nl, nr = sigma ** hl, sigma ** (k - hl)
    B0 = P_all.shape[0] // ghosts_per_group
    if mesh is not None:
        P_all, prefix_all, _ = pad_ghosts(
            P_all, prefix_all, mesh.size("branch") * ghosts_per_group)
        P_all = mesh.local_rows(P_all)
        prefix_all = mesh.local_rows(prefix_all)

    def gather(x):
        return x if mesh is None else mesh.all_gather(x, "branch")[:B0]

    def total(counts):
        s = counts.sum().reshape(1)
        return int(s if mesh is None else mesh.all_reduce(s, "branch"))

    if not keep_positions:
        gid_t = torch.tensor(group_ids, dtype=torch.int32, device=device)
        total_num_groups, threshold, filter_type, _, merge = filter_args

    with rec.span("stage1.halves", key="device_compute", device=device):
        P, prefix, eps_t = stage1_state(P_all, prefix_all, eps, device)
        L, R = dense.masked_halves(P, prefix, eps_t, k=k, sigma=sigma)
        del P, prefix
        device_mod.synchronize(device)

    step = nl // key_batches
    for b in range(key_batches):
        lo = b * step * nr
        with rec.span("stage1.batch", key="device_compute", device=device):
            Lb = L[:, :, b * step:(b + 1) * step].contiguous()
            if keep_positions:
                A_g, pos_g, cnt = combine_max_with_positions(Lb, R, eps_t)
                del Lb
                G = A_g.shape[0]
                A, pos = dense.group_max_with_positions(
                    A_g.reshape(G, -1), pos_g.reshape(G, -1),
                    ghosts_per_group)
                del A_g, pos_g
                payload = (gather(A), gather(pos))
                del pos
            else:
                A_g, cnt = combine_max(Lb, R, eps_t)
                del Lb
                A = gather(dense.group_max(A_g.reshape(A_g.shape[0], -1),
                                           ghosts_per_group))
                del A_g
                payload = extract_columns(
                    A, gid_t, total_num_groups=total_num_groups,
                    threshold=threshold, mif0=filter_type == "mif0",
                    merge_branches=merge, recorder=rec)
                rec.add("card_extract_batches", 1)
                del A
            count = total(cnt)
            device_mod.synchronize(device)
        with rec.span("transfer", device=device):
            arrays = [None if t is None else t.cpu().numpy()
                      for t in payload]
        rec.add("transfer_bytes",
                sum(a.nbytes for a in arrays if a is not None))
        del payload
        if keep_positions:
            yield ("dense", lo, arrays[0], arrays[1], count)
        else:
            counts, fv, branches, scores = arrays
            yield ("columns", lo, counts, fv, branches.view(np.uint32),
                   scores, count)


def _enumerate_sparse_branches(P_all: np.ndarray, prefix_all: np.ndarray, *,
                               k: int, sigma: int, bits: int, eps: np.float32,
                               ghosts_per_group: int, cap: int,
                               device: torch.device, recorder: Recorder,
                               stats: Dict, verbose: int = 0, mesh=None):
    """Large-k stage 1: per-branch merged survivor lists and the explored
    count (``ipk_tpu/builder.py:_enumerate_sparse_branches``); with
    ``mesh``, each chunk's ghosts are shared out over the ranks.

    Survivor-list capacities adapt per span of the split tree: a cheap host
    probe samples windows to size each span's list (``sparse.probe_caps``),
    overflowing spans are doubled inside ``sparse.enumerate_sparse_many``,
    and only the user ceiling ``cap`` fails loudly (silent truncation would
    drop valid k-mers). Ghosts run 32 at a time; the next chunk's device work
    and transfer overlap the host merge of the current one.

    ``recorder`` gains "probe", "device_compute", "transfer",
    "transfer_bytes", "pack" and "host_merge"; ``stats`` gains
    "redispatches" and "final_caps".
    """
    G = P_all.shape[0]
    per_branch = []
    explored = 0
    with recorder.span("probe"):
        caps = sparse_mod.probe_caps(P_all, prefix_all, eps, k=k,
                                     sigma=sigma, cap=cap)
    B = G // ghosts_per_group
    chunk_groups = max(1, 32 // ghosts_per_group)

    def chunks():
        for b0 in range(0, B, chunk_groups):
            nb = min(chunk_groups, B - b0)
            i0, i1 = b0 * ghosts_per_group, (b0 + nb) * ghosts_per_group
            codes, scores, overflow = sparse_mod.enumerate_sparse_many(
                P_all[i0:i1], prefix_all[i0:i1], eps, k=k, sigma=sigma,
                bits=bits, cap=cap, caps=caps, stats=stats, device=device,
                mesh=mesh, recorder=recorder)
            yield i0, i1, nb, codes, scores, overflow

    bar = _Progress("Computing phylo-k-mers", -(-B // chunk_groups),
                    verbose >= 1)
    for i0, i1, nb, codes, scores, overflow in _prefetch(chunks(), recorder):
        if overflow.any():
            raise RuntimeError(
                f"Survivor-list capacity {cap} exceeded (ghost rows "
                f"{i0}-{i1}). Increase --max-candidates or raise "
                "--omega.")
        with recorder.span("host_merge"):
            explored += int(np.isfinite(scores).sum())
            for b in range(nb):
                g0 = b * ghosts_per_group
                per_branch.append(sparse_mod.merge_window_lists(
                    codes[g0:g0 + ghosts_per_group],
                    scores[g0:g0 + ghosts_per_group]))
        bar.step()
    stats.setdefault("redispatches", 0)
    if verbose > 0:
        # probe-miss telemetry: how often a span cap doubled mid-build
        # (forcing a chunk re-run) and where the capacities settled
        caps_str = ", ".join(f"{s}:{c}" for s, c in
                             sorted(stats.get("final_caps", {}).items()))
        print(f"Sparse telemetry: {stats['redispatches']} chunk "
              f"re-dispatch(es) (probe misses); settled caps {{{caps_str}}}")
    return per_branch, explored


def _sparse_device_merge(P_all, prefix_all, *, k: int, sigma: int, bits: int,
                         eps, ghosts_per_group: int, cap: int, mesh,
                         verbose: int = 0):
    """Stage 1 and the stage-2 merge on the devices
    (``ipk_tpu/builder.py:_sparse_device_merge``): enumerate every ghost in
    one sharded dispatch, then merge across the ranks by key range
    (``parallel.key_merge``). Returns (("stream", (keys, group, scores)),
    explored) — a (key, group)-sorted entry stream — or, when a merge bin
    overflows, (("lists", per_branch), explored) from the host merge of the
    finished enumeration; or (None, reason) when the working set passes the
    single-dispatch budget (the caller takes the chunked host merge)."""
    caps = sparse_mod.probe_caps(P_all, prefix_all, eps, k=k, sigma=sigma,
                                 cap=cap)
    G0 = P_all.shape[0]
    # group-aligned padding: each rank must hold whole ghost groups for the
    # merge's group index (the enumeration alone pads to the ranks only)
    P_all, prefix_all, _ = pad_ghosts(
        np.asarray(P_all, np.float32), np.asarray(prefix_all, np.float32),
        mesh.size("branch") * ghosts_per_group)
    G, S = P_all.shape[0], P_all.shape[1]
    W = S - k + 1

    def over_budget(c):
        top_cap = min(cap, max(list(c.values()) + [128]))
        return G * W * top_cap * 48 > _DEVICE_MERGE_BUDGET_BYTES

    if over_budget(caps):
        return None, "working set exceeds the single-dispatch budget"
    while True:
        pend = sparse_mod.enumerate_pairs_deferred(
            P_all, prefix_all, eps, k=k, sigma=sigma, bits=bits, caps=caps,
            mesh=mesh)
        done, result, caps = sparse_mod.resolve_overflow(
            pend, k=k, sigma=sigma, cap=cap, caps=caps, mesh=mesh,
            gather=False)
        if done:
            break
        # cap doubling can take the working set past the budget the probe's
        # caps met: take the host merge then, not a device OOM
        if over_budget(caps):
            return None, ("working set exceeds the single-dispatch budget "
                          "after capacity adaptation")
    if result[3].any():
        raise RuntimeError(
            f"Survivor-list capacity {cap} exceeded. Increase "
            "--max-candidates or raise --omega.")
    # this rank's rows of the padded lists (padding ghosts are all -inf and
    # add no tuple): they stay on the rank's device for the merge
    cl, cr, scores = result[:3]
    explored = int(mesh.all_reduce(torch.isfinite(scores).sum().reshape(1),
                                   "branch"))
    try:
        # nl bounds the cl CODE space of the key-range bins: codes are
        # bit-packed, so it is 2^(bits·hl), not sigma^hl
        stream = key_merge.device_key_merge(
            mesh, cl, cr, scores, ghosts_per_group=ghosts_per_group,
            nl=1 << (bits * (k // 2)), bits=bits, k=k)
    except key_merge.KeyMergeOverflow as e:
        # stage 1 is done and right: gather its lists and merge them on the
        # host instead of running the enumeration again
        if verbose > 0:
            print(f"Note: device key merge fell back to the host merge "
                  f"({e}); reusing the completed enumeration.")
        cl, cr, scores = (mesh.all_gather(x, "branch").cpu().numpy()
                          for x in (cl, cr, scores))
        codes = sparse_mod._pack_host(cl, cr, k=k, bits=bits)
        per_branch = [sparse_mod.merge_window_lists(
            codes[i:i + ghosts_per_group], scores[i:i + ghosts_per_group])
            for i in range(0, G0, ghosts_per_group)]
        return ("lists", per_branch), explored
    if verbose > 0:
        print(f"Device key merge: {len(stream[0])} entries "
              f"({mesh.size('branch')} shards, all-to-all by key range)")
    return ("stream", stream), explored


def _device_mi_batches(P_all, prefix_all, eps, *, k: int, sigma: int,
                       ghosts_per_group: int, total_num_groups: int,
                       threshold: float, key_batches: int, mesh,
                       fv_override: np.ndarray, recorder: Recorder
                       ) -> Iterator[tuple]:
    """``--device-mi`` stage 1 (``ipk_tpu/builder.py:804-846``): per key
    batch, the sharded combine and the collective f32 mif0, yielding
    ("dense", lo, A, None, count) with the batch's filter values written into
    ``fv_override`` (per dense key index) first. ``recorder`` gains
    ``device_compute``, ``transfer`` and ``transfer_bytes`` as in
    :func:`_enumerate_batches`."""
    nr = sigma ** (k - k // 2)
    G0 = P_all.shape[0]
    B0 = G0 // ghosts_per_group
    P_pad, pre_pad, _ = pad_ghosts(P_all, prefix_all,
                                   mesh.size("branch") * ghosts_per_group)
    halves_fn, batch_fn, step_l = sharded_batched_build_step(
        mesh, k=k, sigma=sigma, ghosts_per_group=ghosts_per_group,
        total_num_groups=total_num_groups, threshold=threshold,
        key_batches=key_batches)
    dev = mesh.device
    with recorder.span("stage1.halves", key="device_compute", device=dev):
        L, R, eps_t = halves_fn(P_pad, pre_pad, eps)
        device_mod.synchronize(dev)
    for b in range(key_batches):
        with recorder.span("stage1.batch", key="device_compute", device=dev):
            A_b, fv_b, counts = batch_fn(L, R, eps_t, b * step_l)
            lo = b * step_l * nr
            count = int(counts[:G0].sum())
            device_mod.synchronize(dev)
        with recorder.span("transfer", device=dev):
            fv_np = fv_b.cpu().numpy()
            A_np = A_b[:B0].cpu().numpy()
        recorder.add("transfer_bytes", fv_np.nbytes + A_np.nbytes)
        fv_override[lo:lo + step_l * nr] = fv_np
        yield ("dense", lo, A_np, None, count)


def build(original_tree: PhyloTree,
          extended_tree: PhyloTree,
          ghost_mapping: Dict[str, int],
          ar_mapping: Dict[str, str],
          label_rows: Dict[str, int],
          P: np.ndarray,
          *,
          traits: SeqTraits,
          kmer_size: int,
          omega: float,
          filter_type: str = "mif0",
          ghost_strategy: str = "both",
          merge_branches: bool = False,
          keep_positions: bool = False,
          output_filename: Optional[str] = None,
          uncompressed: bool = False,
          on_disk: bool = False,
          working_dir: str = "",
          key_batches: Optional[int] = None,
          sparse: Optional[bool] = None,
          sparse_cap: int = 4096,
          device_mi: bool = False,
          device: device_mod.DeviceLike = "cuda",
          verbose: int = 1,
          recorder: Optional[Recorder] = None) -> BuildResult:
    """Run the stage-1..3 build (cf. ``db_builder::run``,
    ``db_builder.cpp:182-218``) on one torch device, or sharded over the
    ranks of a ``torch.distributed`` world (module docstring).

    ``sparse`` forces the sparse (True) or dense (False) stage 1; None takes
    the sparse path where σ^k ≥ ``MAX_DENSE_KEYSPACE``. ``sparse_cap`` is the
    per-window survivor-list ceiling there (``--max-candidates``).

    With ``on_disk`` the sorted parts go through ``<working_dir>/hashmaps/``
    into ``output_filename``, and the returned database holds no arrays (as
    in ``ipk_tpu``: load the output to read it).

    The build's spans and counters go to ``recorder`` (a new
    ``spans.Recorder`` when None), whose ``timings`` and ``spans`` the
    result carries: the ``build`` span and under it ``computation``
    (``stage1_inputs``, the prefetch worker's ``stage1.*`` and ``transfer``,
    with the device's ``mif0`` span and the ``card_extract_batches`` counter
    on the dense path without positions, ``wait_stage1``, ``host_extract``
    with ``extract``, and ``mif0`` under that, on the others) and
    ``filter_merge`` (``sort`` with ``concat``, ``serialize``)."""
    retain_heap()
    sigma = traits.alphabet_size
    if kmer_size > traits.max_kmer_length:
        raise RuntimeError(
            f"Maximum k-mer size allowed: {traits.max_kmer_length}")
    if on_disk and keep_positions:
        raise RuntimeError("Positions are not supported in this version")
    use_sparse = sparse if sparse is not None else (
        sigma ** kmer_size >= MAX_DENSE_KEYSPACE)
    if use_sparse and keep_positions:
        raise RuntimeError(
            "--keep-positions is not supported on the sparse (large-k) path")
    dev = device_mod.resolve(device)
    rec = recorder if recorder is not None else Recorder()

    if verbose > 0:
        print("Computation parameters:")
        print(f"\tsequence type: {traits.name}")
        print(f"\tk: {kmer_size}")
        print(f"\tomega: {omega}")
        print(f"\ton disk: {on_disk}")
        print(f"\tkeep positions: {keep_positions}")
        print(f"\tdevice: {dev}\n")

    db = PhyloKmerDB(kmer_size, omega, traits.name, to_newick(original_tree),
                     original_tree.tree_index())
    parts = []
    temp_files: List[str] = []
    hashmaps_dir = os.path.join(working_dir or ".", "hashmaps")

    def handle_part(part) -> None:
        if not on_disk:
            parts.append(part)
            return
        keys, fv, offsets, branches, scores, positions = _sort_batch(*part)
        temp_db = PhyloKmerDB(kmer_size, omega, traits.name, "", [])
        temp_db.set_data(keys, fv.astype(np.float32), offsets, branches,
                         scores, positions)
        name = os.path.join(hashmaps_dir, f"{len(temp_files)}.ipk")
        serialize.save(temp_db, name, compressed=False)
        temp_files.append(name)

    num_explored = 0
    stats: Dict = {}
    with rec.span("build", group=True):
        with rec.span("computation", group=True):
            # ---- stage 1 inputs -------------------------------------------
            with rec.span("stage1_inputs"):
                s1 = stage1_inputs(original_tree, extended_tree,
                                   ghost_mapping, ar_mapping, label_rows, P,
                                   sigma=sigma, kmer_size=kmer_size,
                                   omega=omega, ghost_strategy=ghost_strategy)
            group_ids = s1.group_ids
            threshold = score_threshold(omega, sigma, kmer_size)
            rng_stream = (RandomFilterStream() if filter_type == "random"
                          else None)
            total_num_groups = original_tree.get_node_count()
            filter_args = (total_num_groups, threshold, filter_type,
                           rng_stream, merge_branches)
            # every path shards the branch axis over the ranks of a world of
            # more than one (ipk_tpu/builder.py:789-795, with the world for
            # the devices)
            mesh = None
            if world_size() > 1 and os.environ.get("IPK_TPU_NO_SHARD") != "1":
                mesh = make_mesh(device=dev)
            use_device_mi = (device_mi and mesh is not None
                             and not use_sparse and not keep_positions
                             and filter_type == "mif0")
            if device_mi and not use_device_mi and verbose > 0:
                print("Note: --device-mi needs a multi-device mesh, the "
                      "dense path and the mif0 filter; falling back to the "
                      "host f64 filter.")
            if on_disk:
                os.makedirs(hashmaps_dir, exist_ok=True)

            if use_sparse:
                merged = None
                if mesh is not None and os.environ.get(
                        "IPK_TPU_NO_DEVICE_MERGE") != "1":
                    # the stage-2 merge on the devices, byte-equal to the
                    # host merge
                    merged, info = _sparse_device_merge(
                        s1.P_all, s1.prefix_all, k=kmer_size, sigma=sigma,
                        bits=traits.bits_per_symbol, eps=s1.eps,
                        ghosts_per_group=s1.ghosts_per_group, cap=sparse_cap,
                        mesh=mesh, verbose=verbose)
                    if merged is None and verbose > 0:
                        print(f"Note: device key merge fell back to the host "
                              f"merge ({info}).")
                if merged is None:
                    per_branch, num_explored = _enumerate_sparse_branches(
                        s1.P_all, s1.prefix_all, k=kmer_size, sigma=sigma,
                        bits=traits.bits_per_symbol, eps=s1.eps,
                        ghosts_per_group=s1.ghosts_per_group, cap=sparse_cap,
                        device=dev, recorder=rec, stats=stats,
                        verbose=verbose, mesh=mesh)
                    merged = ("lists", per_branch)
                    stats["merge"] = "host"
                else:
                    num_explored = info
                    stats["merge"] = ("device" if merged[0] == "stream"
                                      else "host, after a bin overflow")
                with rec.span("host_extract"):
                    if merged[0] == "stream":
                        handle_part(_extract_sorted_stream(
                            *merged[1], group_ids, *filter_args,
                            recorder=rec))
                    else:
                        handle_part(_extract_from_lists(
                            merged[1], group_ids, *filter_args,
                            recorder=rec))
            else:
                hl = kmer_size // 2
                nl, nr = sigma ** hl, sigma ** (kmer_size - hl)
                if key_batches is None:
                    key_batches = choose_key_batches(len(group_ids), nl, nr,
                                                     keep_positions)
                fv_override = None
                if use_device_mi:
                    # enumeration and the mif0 reduction stay on the devices
                    # (three sum all-reduces a key batch); fv comes back f32
                    fv_override = np.empty(nl * nr, dtype=np.float32)
                    batches = _device_mi_batches(
                        s1.P_all, s1.prefix_all, s1.eps, k=kmer_size,
                        sigma=sigma, ghosts_per_group=s1.ghosts_per_group,
                        total_num_groups=total_num_groups,
                        threshold=threshold, key_batches=key_batches,
                        mesh=mesh, fv_override=fv_override, recorder=rec)
                else:
                    batches = _enumerate_batches(
                        s1.P_all, s1.prefix_all, k=kmer_size, sigma=sigma,
                        eps=s1.eps, ghosts_per_group=s1.ghosts_per_group,
                        key_batches=key_batches, device=dev, recorder=rec,
                        keep_positions=keep_positions, mesh=mesh,
                        group_ids=group_ids, filter_args=filter_args)

                # ---- stages 2+3 -------------------------------------------
                bar = _Progress("Computing phylo-k-mers", key_batches,
                                verbose >= 1)
                for batch in _prefetch(batches, rec):
                    with rec.span("host_extract"):
                        num_explored += batch[-1]
                        handle_part(_extract_part(
                            batch, group_ids, kmer_size, traits, filter_args,
                            fv_override, rec))
                    bar.step()
        if verbose > 0:
            print(f"Computation time: "
                  f"{rec.timings['computation']*1e3:.0f} ms")

        with rec.span("filter_merge", group=True):
            if on_disk:
                # the result stays on disk, as in ipk_tpu
                # (db_builder.cpp:467-493)
                _merge_on_disk(db, temp_files, output_filename, uncompressed)
                shutil.rmtree(hashmaps_dir, ignore_errors=True)
            else:
                with rec.span("sort"):
                    with rec.span("concat"):
                        columns = _concatenate_parts(parts)
                    keys, fv, offsets, branches, scores, positions = (
                        _sort_batch(*columns))
                    del columns
                    db.set_data(keys, fv.astype(np.float32), offsets,
                                branches, scores, positions)
                if output_filename:
                    with rec.span("serialize"):
                        serialize.save(db, output_filename,
                                       compressed=not uncompressed)

        if verbose > 0:
            print(f"Filtering and merge time: "
                  f"{rec.timings['filter_merge']*1e3:.0f} ms")
            print("Building database: Done.")
            if output_filename:
                print(f"Output: {output_filename}")
    return BuildResult(db, num_explored, rec.timings, stats, rec.spans)


def _extract_part(batch: tuple, group_ids: List[int], k: int,
                  traits: SeqTraits, filter_args: tuple,
                  fv_override: Optional[np.ndarray],
                  recorder: Recorder) -> tuple:
    """Stage 2 of one dense-path batch: its unsorted DB arrays.
    ``filter_args`` are the extractors' (total_num_groups, threshold,
    filter_type, rng_stream, merge_branches). A "columns" batch only gets
    its keys and, under the random filter, its values; a "dense" batch
    (positions, ``--device-mi``) is extracted and filtered in an
    ``extract`` span."""
    if batch[0] == "columns":
        return _finish_columns(batch, k, traits, filter_args)
    _, lo, A, pos, _ = batch
    with recorder.span("extract"):
        return _extract_batch(A, lo, pos, group_ids, k, traits,
                              *filter_args, recorder=recorder,
                              fv_override=fv_override)


def _finish_columns(batch: tuple, k: int, traits: SeqTraits,
                    filter_args: tuple) -> tuple:
    """A "columns" batch's unsorted DB arrays (keys, fv, counts, branches,
    scores, None), the contract of the host extractors: the keys of its
    live columns, their counts and filter values (mif0 from the device,
    random drawn here in ascending key order), the entries as they came."""
    _, lo, counts, fv, branches, scores, _ = batch
    _, _, filter_type, rng_stream, _ = filter_args
    cols = np.flatnonzero(counts)
    keys = dense_index_to_key(cols.astype(np.uint64) + np.uint64(lo), k,
                              traits)
    if fv is not None:
        fv = fv[cols]
    elif filter_type == "random":
        fv = rng_stream.take(len(cols)).astype(np.float64)
    else:
        raise RuntimeError("Error: Unsupported filter type.")
    return keys, fv, counts[cols].astype(np.int64), branches, scores, None


def _concatenate_parts(parts: list) -> tuple:
    """The batches' unsorted DB arrays joined column by column: (keys, fv,
    counts, branches, scores, positions)."""
    if not parts:
        return (np.zeros(0, np.uint64), np.zeros(0), np.zeros(0, np.int64),
                np.zeros(0, np.uint32), np.zeros(0, np.float32), None)
    return tuple(None if parts[0][i] is None
                 else np.concatenate([p[i] for p in parts])
                 for i in range(6))
