#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, nvcc and
nvidia-smi. Imports nothing of JAX. Every phase raises on failure:

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile the kernels of ipk_tpu_torch/core/csrc with nvcc, one
             process per source, all started together.
3. kernel  — each kernel on the card against its plain PyTorch version on
             the same inputs, bit-equal (tolerance: none, the arithmetic is
             exactly rounded f32 and the sorts are total orders); kernel and
             plain times, and each launch's bound (the larger of its bytes
             over 3.35 TB/s and its operations over 67 TFLOP/s):
             * combine_max against combine_max_ref (A bits and counts) at
               ragged random halves, AA k=4 halves (nl = nr = 400) and every
               key batch the phase-5 build launches on its real halves; at
               each of those main-path launches a "[main path]" line with
               the kernel's time, its time without the explored count (the
               count's share), the bound, and the card;
             * extract_columns against extract_columns_ref at each of those
               key batches' accumulators A [510, 16384] (combine_max and
               group_max on the card): counts, branches and score bits
               equal, float64 filter values within 1e-12 of max(|fv|, the
               median |fv|) (CUDA's exp10 and log2 against the host's
               libm); a "[main path]" line with both passes' time, the
               column pass's, the bound and the plain version's time;
             * staircase_select against staircase_select_ref at the shapes
               of tests/test_staircase_kernels.py with sort_l on and off,
               sign-bit codes with ±0.0 and tied scores, an overflowing
               window, the kernel's paths (compact prefixes and -inf in
               place with 10-30% live, live counts of 0, 1, 32, 33, 256
               and 257 a list, sort_l off with dead rows interleaved),
               CL = CR = 4096 (cap 4096), 8192 (cap 8192) and 12,000 (cap
               16,384: global staging); then the first 32-ghost chunk of
               the phase-7 build through sparse.enumerate_sparse_many with
               the kernel and with use_kernel=False, bit-equal lists and
               overflow, each of its kernel launches again against the
               plain version with a "[main path]" line (time, bound,
               card), and 4 ghosts with the top span's cap forced above
               8192 under a ceiling of 16,384, kernel route against
               use_kernel=False.
4. goldens — tests/data/golden D-dna (k=7) and D-aa (k=4) built on the card,
             payload-equal to the committed databases; a small amino build
             payload-equal between the card and the CPU.
5. scale   — a 256-taxon x 1500-site DNA project at k=8 (510 branches, 1020
             ghost matrices, W=1493) built in process and again through
             ``python -m ipk_tpu_torch build``; byte-identical files; timings,
             explored tuples, stage-1 tuples/s and peak device memory.
6. sparse goldens — D-dna and D-aa rebuilt on the card through the sparse
             path (``build(..., sparse=True)``), payload-equal to the
             goldens; a 12-taxon x 60-site amino project at k=6, omega 4.0
             (sparse by sigma^k) built on the card through ``python -m
             ipk_tpu_torch build`` and on the CPU, payload-equal, non-empty.
7. sparse scale — the phase-5 project at DNA k=12, omega 2.0 (sparse by
             sigma^k): timings, explored tuples, k-mers, entries, settled
             caps, re-dispatches, peak device memory, staircase launches;
             and a 64-taxon x 600-site DNA k=10 project built dense and
             forced sparse, byte-identical.
8. positions — the positions mode of combine_max against
             combine_max_with_positions_ref, bit-equal A, pos and counts, at
             ragged random halves, a constant matrix (every pos 0), halves
             full of -0.0 and +0.0, and each key-batch launch of the next
             build; the phase-5 project built with --keep-positions in
             process (keys, branches and scores byte-equal to phase 5's
             file; wall, transfer bytes, peak memory); the phase-4 amino
             project with --keep-positions through ``python -m
             ipk_tpu_torch build`` on the card, payload-equal to the CPU
             (the CLI refuses --keep-positions for DNA, as ipk_tpu's does);
             the phase-7 64-taxon project at DNA k=8 with --keep-positions
             --merge-branches, card payload-equal to CPU.
9. on-disk — the phase-5 build with --on-disk: the same rows as phase 5's
             file, sorted by (float32 filter value, key), which is the
             in-RAM order but among keys whose float32 filter values tie
             while their float64 values differ (ipk_tpu's on-disk merge
             orders them so); the 64-taxon project at DNA k=8 with
             --on-disk, card payload-equal to CPU, and once more with its
             output on the null device (nothing left beside it, nothing
             but the build's own files under the working directory); the
             64-taxon project at DNA k=10 forced sparse with --on-disk,
             the same rows as its in-RAM sparse build in that order (the
             merge re-sorts even one part); hashmaps/ removed.
10. place  — 100,000 reads of 150 sites cut from the scale alignment's
             leaves with 5% substitutions placed against phase 5's database
             through ``python -m ipk_tpu_torch place`` (reads/s, peak
             memory); the first 2,000 against the host f64 scorer: totals
             within rtol 1e-4 / atol 5e-3, top-1 equal wherever the host's
             top-2 gap exceeds 5e-3.
11. native AR — the phase-5 project through --ar native on the card and
             on the CPU (posteriors within atol 1e-5; the two k=8 databases
             built from them on the card equal under ``diff-text --eps
             1e-3``), then --ar native --ar-optimize on the card (the log
             likelihood must rise; time and steps/s).
12. profile — the phase-5 build with --profile: a torch.profiler Chrome
             trace (its size, operators and kernels on the card) beside a
             database payload-equal to phase 5's.
13. multi-rank A — a torch.distributed world of one rank over NCCL, in
             process, through ipk_tpu_torch.parallel directly (the builder
             shards only above one rank): device_key_merge on the first
             32-ghost chunk of the phase-7 build (enumerated through the
             mesh) byte-equal to merge_window_lists plus the host lexsort;
             sharded_batched_build_step at the phase-5 scale, each key
             batch's A and counts bit-equal to the plain combine's and its
             f32 filter values within rtol 2e-5 / atol 1e-7 of the host f64
             mif0; pad_ghosts' rows through both kernels leave no survivor
             and no NaN.
14. multi-rank B — two ranks over gloo sharing the card, each a process of
             this script (``--rank SPEC R``; NCCL refuses two ranks on one
             GPU), build and each write: the phase-5 project (byte-equal
             payload to phase 5's), the phase-7 64-taxon project forced
             sparse through the device key merge (payload-equal to phase
             7's one-rank build; the route must be "device"), the phase-5
             project with --keep-positions (payload-equal to phase 8's) and
             with --device-mi (phase 5's rows, filter values within rtol
             2e-5 / atol 1e-7), and the 64-taxon project through the CLI
             with --coordinator/--num-hosts 2/--host-id (byte-equal to phase
             7's dense file). Two ranks on one card check correctness; they
             measure no scaling.

The synthetic projects are written by this script's own make_project,
with ipk_tpu_torch's modules (the same files as the repository's test
fixtures write). Kernel launch counts are reset just before each main path
and read just after it: phases 4-5 (the dense path: combine_max and
extract_columns, which phases 9 and 12 must launch too), 6-7
(the sparse path: staircase_select), 8 (positions:
combine_max_with_positions), 9 (on-disk: combine_max and
staircase_select), 11 (builds from native-AR posteriors: combine_max), 12
(combine_max) and 13 (combine_max and staircase_select); each rank of
phase 14 counts its own, printed on the "[multi-rank]" line with each
phase's wall, the card's name and its power limit. Two lines before the
last is a JSON object of the kernels (name, route, source, replaces,
launches, max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms), then
the card's name and power limit as nvidia-smi prints them; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, printing no result, when CUDA is unavailable or the
repository is not beside this script.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))
SCALE = dict(num_leaves=256, width=1500, seed=9, k=8, omega=1.5)
#: the phase-7 sparse build: the phase-5 project at DNA k=12
SPARSE_SCALE = dict(k=12, omega=2.0, cap=4096)
#: the dense-vs-sparse anchor at a middle size
MID = dict(num_leaves=64, width=600, seed=13, k=10, omega=2.0)
#: the phase-8 card-vs-CPU positions build: the MID project at DNA k=8
POS_MID = dict(k=8, omega=1.5)
#: the phase-10 reads against the phase-5 database
READS = dict(n=100_000, length=150, subst=0.05, seed=21, check=2000)
#: the phase-11 optimizer steps of --ar native --ar-optimize
AR_OPT_STEPS = 30
KERNELS = ("combine_max", "combine_max_with_positions", "staircase_select",
           "extract_columns")
#: the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): device
#: memory bytes/s and float32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
#: phase-3 staircase shapes: (label, G, W, CL, CR, cap, input options);
#: "both" runs sort_l on and off, "live" gives each window exactly that many
#: live (> -inf) entries a list (cycled over the windows, R one step ahead of
#: L) or a share of its width drawn from the range, kept as a compact
#: prefix ("prefix") or scattered among -inf
STAIRCASE_SHAPES = [
    ("tiny, unaligned", 1, 5, 20, 33, 128, {"both": True}),
    ("multi-tile L", 2, 9, 130, 200, 256, {"both": True}),
    ("wide L, narrow R", 1, 3, 300, 40, 384, {"both": True}),
    ("sign-bit codes, +-0.0 and ties", 2, 4, 64, 64, 200,
     {"signed_zeros": True, "sign_bit": True}),
    ("overflow (all survive)", 1, 4, 40, 40, 128, {"all_survive": True}),
    ("compact prefixes, 10-30% live", 4, 250, 512, 384, 1280,
     {"live": (0.1, 0.3), "prefix": True}),
    ("-inf in place, 10-30% live", 4, 250, 64, 64, 512,
     {"live": (0.1, 0.3), "both": True}),
    ("live 0/1/32/33/256/257 a list, in place", 2, 24, 320, 300, 1001,
     {"live": (0, 1, 32, 33, 256, 257), "both": True}),
    ("live 0/1/32/33/256/257 a list, prefixes", 2, 24, 320, 300, 1001,
     {"live": (0, 1, 32, 33, 256, 257), "prefix": True}),
    ("CL = CR = 4096", 1, 64, 4096, 4096, 4096, {}),
    ("CL = CR = 8192", 1, 16, 8192, 8192, 8192, {}),
    ("CL = CR = 12,000 (global staging)", 1, 2, 12_000, 12_000, 16_384, {}),
]
#: the phase-3 forced-caps chunk: the top span's cap above 8192 under a
#: ceiling of 16384 (its natural size with (0,6) = (6,6) = 128)
WIDE_CAPS = dict(ghosts=4, cap=16_384,
                 caps={(0, 6): 128, (6, 6): 128, (0, 12): 9216})


def log(msg: str) -> None:
    print(msg, flush=True)


def payload(path: str) -> bytes:
    raw = open(path, "rb").read()
    try:
        return zlib.decompress(raw)
    except zlib.error:
        return raw


# ---------------------------------------------------------------------------
# Synthetic projects: tree file, alignment file and a replayable --ar-dir
# (seeded random posteriors), written with ipk_tpu_torch's own modules. They
# write the same files, byte for byte, as tests/fixtures.py:make_project at
# the same arguments (tests/test_torch_host.py holds them to it).

def random_tree_newick(rng, num_leaves: int) -> str:
    """Random rooted binary tree with num_leaves labeled leaves."""
    nodes = [f"L{i}:{rng.uniform(0.05, 1.0):.4f}" for i in range(num_leaves)]
    while len(nodes) > 1:
        i = rng.integers(0, len(nodes))
        a = nodes.pop(i)
        j = rng.integers(0, len(nodes))
        b = nodes.pop(j)
        bl = rng.uniform(0.05, 1.0)
        nodes.append(f"({a},{b}):{bl:.4f}")
    # root: strip the root's branch length
    return nodes[0].rsplit(":", 1)[0] + "root;"


def random_alignment(rng, leaf_labels, width: int, traits=None,
                     gap_prob: float = 0.1):
    from ipk_tpu_torch.alignment import Alignment
    from ipk_tpu_torch.seq import DNA
    letters = (traits or DNA).letters
    seqs = []
    for _ in leaf_labels:
        chars = [
            "-" if rng.random() < gap_prob
            else letters[rng.integers(0, len(letters))]
            for _ in range(width)]
        seqs.append("".join(chars))
    return Alignment(list(leaf_labels), seqs)


def make_ar_tree(extended_tree):
    """AR view of the extended tree: same topology, inner nodes relabeled
    Node0..NodeN (as raxml-ng's ancestralTree), leaves unchanged."""
    from ipk_tpu_torch.tree import postorder
    ar = extended_tree.copy()
    counter = 0
    for node in postorder(ar.root):
        if not node.is_leaf():
            node.label = f"Node{counter}"
            counter += 1
    ar.index()
    return ar


def write_ancestral_probs(filename: str, ar_tree, width: int, rng,
                          traits=None, concentration: float = 0.5) -> None:
    """Synthetic .raxml.ancestralProbs: one block per internal node, one row
    per site, raxml-ng's column order (alphabetical for AA; ACGT for DNA)."""
    import numpy as np
    from ipk_tpu_torch.ar.reader import RAXML_AA_ORDER
    from ipk_tpu_torch.seq import DNA
    from ipk_tpu_torch.tree import postorder
    traits = traits or DNA
    sigma = traits.alphabet_size
    letters = RAXML_AA_ORDER if sigma == 20 else traits.letters
    with open(filename, "w") as f:
        f.write("Node\tSite\tState\t" +
                "\t".join(f"p_{c.upper()}" for c in letters) + "\n")
        for node in postorder(ar_tree.root):
            if node.is_leaf():
                continue
            probs = rng.dirichlet(np.ones(sigma) * concentration, size=width)
            probs = np.maximum(probs, 1e-12)
            for site in range(width):
                state = letters[int(np.argmax(probs[site]))]
                row = "\t".join(f"{p:.9f}" for p in probs[site])
                f.write(f"{node.label}\t{site+1}\t{state}\t{row}\n")


def make_ar_dir(tmp_path, extended_tree, width: int, seed: int = 0,
                traits=None):
    """An --ar-dir with synthetic probs and tree for the extended tree."""
    import numpy as np
    from ipk_tpu_torch.tree import to_newick
    rng = np.random.default_rng(seed)
    ar_dir = os.path.join(str(tmp_path), "ar_out")
    os.makedirs(ar_dir, exist_ok=True)
    ar_tree = make_ar_tree(extended_tree)
    with open(os.path.join(ar_dir, "align.raxml.ancestralTree"), "w") as f:
        f.write(to_newick(ar_tree) + "\n")
    write_ancestral_probs(os.path.join(ar_dir, "align.raxml.ancestralProbs"),
                          ar_tree, width, rng, traits)
    return ar_dir, ar_tree


def make_project(tmp_path, num_leaves=6, width=30, seed=1, traits=None):
    """Full synthetic project, gap-free: (tree_file, fasta_file, ar_dir)."""
    import numpy as np
    from ipk_tpu_torch.alignment import save_alignment
    from ipk_tpu_torch.tree import extend_tree, parse_newick, postorder
    rng = np.random.default_rng(seed)
    newick = random_tree_newick(rng, num_leaves)
    tree_file = os.path.join(str(tmp_path), "tree.newick")
    with open(tree_file, "w") as f:
        f.write(newick + "\n")
    tree = parse_newick(newick)
    leaves = [n.label for n in postorder(tree.root) if n.is_leaf()]
    align = random_alignment(rng, leaves, width, traits, gap_prob=0.0)
    fasta_file = os.path.join(str(tmp_path), "reference.fasta")
    save_alignment(align, fasta_file, "fasta")
    extended, _ = extend_tree(tree)
    ar_dir, _ = make_ar_dir(tmp_path, extended, width, seed + 1, traits)
    return tree_file, fasta_file, ar_dir


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke "
                           "run needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    if not smi:
        raise RuntimeError("nvidia-smi printed no card")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; "
        f"{torch.cuda.device_count()} card(s): {torch.cuda.get_device_name(0)}")
    return smi


def phase_build():
    from ipk_tpu_torch.core import _build
    t0 = time.monotonic()
    _build.load()
    log(f"[build] {_build.LIB_PATH} in {time.monotonic() - t0:.3f} s "
        f"(nvcc {_build.build_seconds:.3f} s)")
    for line in _build.build_log.splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line):
            log(f"[build] ptxas: {line.strip()}")


def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved, ops):
    """(least ms the card needs for the work, which of the two bounds it):
    the bytes over the memory rate against the operations over the f32
    rate."""
    by_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def combine_bound(G, W, nl, nr, positions=False):
    """combine_max's bound: L, R read once, A (and pos) and the counts
    written once; one add and one max per candidate (the explored count
    needs no operation per candidate)."""
    cells = G * nl * nr
    bytes_moved = 4 * G * W * (nl + nr) + 4 * cells * (2 if positions else 1)
    return bound(bytes_moved + 8 * G, 2 * G * W * nl * nr)


def staircase_bound(args, outs, emitted):
    """(bytes, bound ms, bound_by) of one staircase_select call: every score
    and eps read once, and the code of each live (> -inf) entry (a dead
    entry never counts or emits, so its code is never needed); every slot
    and total written once; one add a survivor emitted."""
    sL, cL, sR, cR, eps = args
    live = int((sL > float("-inf")).sum()) + int((sR > float("-inf")).sum())
    moved = (sum(t.numel() * t.element_size() for t in (sL, sR, eps))
             + live * cL.element_size()
             + sum(t.numel() * t.element_size() for t in outs))
    return (moved, *bound(moved, emitted))


def uncounted_ms(torch, L, R, eps, reps):
    """The main-path kernel without its explored count (the library's
    measuring entry, not a wrapper: no launch is counted)."""
    import ctypes
    from ipk_tpu_torch.core import _build
    lib = _build.load()
    G, W, nl = L.shape
    nr = R.shape[2]
    A = torch.empty((G, nl, nr), dtype=torch.float32, device=L.device)
    counts = torch.zeros(G, dtype=torch.int64, device=L.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(L.device).cuda_stream)

    def call():
        rc = lib.ipk_combine_max_uncounted(
            ctypes.c_void_p(L.data_ptr()), ctypes.c_void_p(R.data_ptr()),
            ctypes.c_float(float(eps)), ctypes.c_void_p(A.data_ptr()),
            ctypes.c_void_p(counts.data_ptr()), G, W, nl, nr,
            L.device.index, stream)
        if rc:
            raise RuntimeError(f"ipk_combine_max_uncounted failed: {rc}")
    return time_ms(torch, call, reps)


def compare_kernel(torch, label, L, R, eps, reps=5, plain_reps=2):
    """Kernel vs plain on one input: raises unless bit-equal."""
    from ipk_tpu_torch.core import dense, kernels
    A, counts = kernels.combine_max(L, R, eps)
    A_ref, counts_ref = dense.combine_max_ref(L, R, eps)
    torch.cuda.synchronize()
    same_mask = torch.equal(torch.isfinite(A), torch.isfinite(A_ref))
    live = torch.isfinite(A_ref)
    err = float((A[live] - A_ref[live]).abs().max()) if live.any() else 0.0
    if not (same_mask and torch.equal(A.view(torch.int32),
                                      A_ref.view(torch.int32))
            and torch.equal(counts, counts_ref)):
        raise RuntimeError(
            f"[kernel] {label}: kernel differs from combine_max_ref "
            f"(mask equal {same_mask}, max |dA| {err}, counts "
            f"{int(counts.sum())} vs {int(counts_ref.sum())})")
    ms = time_ms(torch, lambda: kernels.combine_max(L, R, eps), reps)
    plain_ms = time_ms(torch, lambda: dense.combine_max_ref(L, R, eps),
                       plain_reps)
    G, W, nl = L.shape
    bound_ms, bound_by = combine_bound(G, W, nl, R.shape[2])
    log(f"[kernel] {label}: G={G} W={W} nl={nl} nr={R.shape[2]} bit-equal "
        f"(A bits and counts, {int(counts.sum())} tuples); kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                tuples=int(counts.sum()), bound_ms=bound_ms,
                bound_by=bound_by)


def compare_extract(torch, label, A, gids, total_num_groups, threshold,
                    reps=5):
    """extract_columns on the card against its plain version on the CPU at
    one key batch's A: counts, branches and score bits equal, fv within
    1e-12 of max(|fv|, the median |fv|) of the plain version's (the host
    mif0); raises otherwise. Times: both passes with the read of the entry
    total between (CUDA events, mean of ``reps``), the column pass alone
    (its ``mif0`` span), and the plain version (host clock, one call)."""
    import numpy as np
    from ipk_tpu_torch.core import kernels
    from ipk_tpu_torch.core.dense import extract_columns_ref
    from ipk_tpu_torch.spans import Recorder
    opts = dict(total_num_groups=total_num_groups, threshold=threshold)
    counts, fv, br, sc = (t.cpu() for t in kernels.extract_columns(
        A, gids, **opts))
    A_cpu = A.cpu()
    t0 = time.perf_counter()
    ref = extract_columns_ref(A_cpu, gids.cpu(), **opts)
    plain_ms = (time.perf_counter() - t0) * 1e3
    live = (ref[0] > 0).numpy()
    fv_h = ref[1].numpy()[live]
    gap = np.abs(fv.numpy()[live] - fv_h)
    scale = np.maximum(np.abs(fv_h), np.median(np.abs(fv_h)))
    rel = float((gap / scale).max()) if live.any() else 0.0
    flips = int((fv.numpy()[live].astype(np.float32)
                 != fv_h.astype(np.float32)).sum())
    if not (torch.equal(counts, ref[0]) and torch.equal(br, ref[2])
            and torch.equal(sc.view(torch.int32), ref[3].view(torch.int32))
            and rel <= 1e-12):
        raise RuntimeError(
            f"[kernel] {label}: extract_columns differs from its plain "
            f"version (counts {torch.equal(counts, ref[0])}, branches "
            f"{torch.equal(br, ref[2])}, scores "
            f"{torch.equal(sc.view(torch.int32), ref[3].view(torch.int32))}, "
            f"largest fv gap {rel:.3e} of the scale)")
    ms = time_ms(torch, lambda: kernels.extract_columns(A, gids, **opts),
                 reps)
    rec = Recorder()
    for _ in range(reps):
        kernels.extract_columns(A, gids, recorder=rec, **opts)
    column_ms = rec.timings["mif0"] / reps * 1e3
    B, chunk = A.shape
    entries = len(sc)
    bytes_moved = 4 * B * chunk + 8 * entries + (4 + 8 + 8) * chunk + 8
    bound_ms, bound_by = bound(bytes_moved, 0)
    log(f"[kernel] {label}: A [{B}, {chunk}], {entries} entries; counts, "
        f"branches and scores bit-equal, fv within {rel:.3e} of the scale "
        f"(f32 fv differs in {flips} of {int(live.sum())} keys); kernel "
        f"{ms:.4f} ms (column pass {column_ms:.4f} ms), plain {plain_ms:.1f} "
        f"ms, bound {bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=float(gap.max(initial=0.0)), max_rel_fv=rel,
                ms=ms, column_ms=column_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, entries=entries,
                f32_flips=flips)


def phase_kernel(torch, tmp, tree_file, fasta_file, ar_dir, smi):
    import numpy as np
    from ipk_tpu_torch.builder import (choose_key_batches, stage1_inputs,
                                       stage1_state)
    from ipk_tpu_torch.core import kernels
    from ipk_tpu_torch.core.dense import (best_score_prefix, group_max,
                                          masked_halves)
    from ipk_tpu_torch.core.filter import score_threshold
    from ipk_tpu_torch.pipeline import BuildParams, prepare
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    # ragged: nl, nr and W are multiples of no tile size
    G, W, nl, nr = 3, 70, 33, 65
    L = rng.normal(size=(G, W, nl)).astype(np.float32)
    L[rng.random(L.shape) < 0.2] = -np.inf
    R = rng.normal(size=(G, W, nr)).astype(np.float32)
    compare_kernel(torch, "ragged random",
                   torch.from_numpy(L).to(dev), torch.from_numpy(R).to(dev),
                   torch.tensor(np.float32(0.5), device=dev))
    # AA k=4: masked halves of seeded amino posteriors
    k, sigma, omega = 4, 20, 6.0
    p = rng.dirichlet(np.ones(sigma) * 0.3, size=(128, 400)).astype(np.float32)
    P = np.log10(np.maximum(p, 1e-30)).astype(np.float32)
    Pt, pre, eps = stage1_state(P, best_score_prefix(P),
                                np.float32(np.log10((omega / sigma) ** k)),
                                dev)
    L, R = masked_halves(Pt, pre, eps, k=k, sigma=sigma)
    compare_kernel(torch, "AA k=4", L, R, eps)
    del Pt, pre, L, R
    # the scale project's halves, cut into key batches as the build cuts
    # them: each launch of the main path, on the same inputs
    inp = prepare(BuildParams(
        refalign=fasta_file, reftree=tree_file, ar_dir=ar_dir,
        working_dir=os.path.join(tmp, "wd_kernel"), kmer_size=SCALE["k"],
        omega=SCALE["omega"], verbosity=0, device="cuda"))
    s1 = stage1_inputs(inp.original_tree, inp.extended_tree,
                       inp.ghost_mapping, inp.ar_mapping, inp.label_rows,
                       inp.P, sigma=inp.traits.alphabet_size,
                       kmer_size=SCALE["k"], omega=SCALE["omega"])
    Pt, pre, eps = stage1_state(s1.P_all, s1.prefix_all, s1.eps, dev)
    L, R = masked_halves(Pt, pre, eps, k=SCALE["k"],
                         sigma=inp.traits.alphabet_size)
    del Pt, pre
    nl, nr = L.shape[2], R.shape[2]
    key_batches = choose_key_batches(len(s1.group_ids), nl, nr)
    step = nl // key_batches
    gids = torch.tensor(s1.group_ids, dtype=torch.int32, device=dev)
    total_num_groups = inp.original_tree.get_node_count()
    threshold = score_threshold(SCALE["omega"], inp.traits.alphabet_size,
                                SCALE["k"])
    runs, extracts = [], []
    for b in range(key_batches):
        Lb = L[:, :, b * step:(b + 1) * step].contiguous()
        label = f"DNA k=8 scale project, key batch {b + 1}/{key_batches}"
        run = compare_kernel(torch, label, Lb, R, eps, reps=5, plain_reps=1)
        run["uncounted_ms"] = uncounted_ms(torch, Lb, R, eps, reps=5)
        runs.append(run)
        log(f"[main path] combine_max, {label}: L {tuple(Lb.shape)} x R "
            f"{tuple(R.shape)}: kernel {run['ms']:.4f} ms (CUDA events, "
            f"mean of 5 after a warm-up), without the explored count "
            f"{run['uncounted_ms']:.4f} ms (the count "
            f"{100 * (1 - run['uncounted_ms'] / run['ms']):.1f}% of the "
            f"kernel; it is no separate launch); bound "
            f"{run['bound_ms']:.4f} ms ({run['bound_by']}), kernel at "
            f"{100 * run['bound_ms'] / run['ms']:.1f}% of it; {smi}")
        A_g, _ = kernels.combine_max(Lb, R, eps)
        A = group_max(A_g.reshape(A_g.shape[0], -1), s1.ghosts_per_group)
        del A_g, Lb
        ext = compare_extract(torch, label, A, gids, total_num_groups,
                              threshold)
        extracts.append(ext)
        log(f"[main path] extract_columns, {label}: A {tuple(A.shape)}: "
            f"kernel {ext['ms']:.4f} ms (CUDA events, mean of 5 after a "
            f"warm-up, both passes and the entry-total read between), "
            f"column pass (mif0) {ext['column_ms']:.4f} ms; bound "
            f"{ext['bound_ms']:.4f} ms ({ext['bound_by']}: A read once, 8 B "
            f"an entry written), kernel at "
            f"{100 * ext['bound_ms'] / ext['ms']:.1f}% of it; plain "
            f"{ext['plain_ms']:.1f} ms; {smi}")
        del A
    del L, R
    torch.cuda.empty_cache()
    res = dict(max_abs_err=max(r["max_abs_err"] for r in runs),
               ms=sum(r["ms"] for r in runs) / key_batches,
               plain_ms=sum(r["plain_ms"] for r in runs) / key_batches,
               bound_ms=sum(r["bound_ms"] for r in runs) / key_batches,
               bound_by=runs[0]["bound_by"],
               uncounted_ms=sum(r["uncounted_ms"] for r in runs)
               / key_batches,
               tuples=sum(r["tuples"] for r in runs),
               s1=s1, total_num_groups=total_num_groups,
               extract=dict(
                   max_abs_err=max(e["max_abs_err"] for e in extracts),
                   max_rel_fv=max(e["max_rel_fv"] for e in extracts),
                   f32_flips=sum(e["f32_flips"] for e in extracts),
                   **{key: sum(e[key] for e in extracts) / key_batches
                      for key in ("ms", "column_ms", "plain_ms",
                                  "bound_ms")}))
    log(f"[kernel] DNA k=8 scale project: {key_batches} launches per build, "
        f"kernel {res['ms']:.4f} ms per launch, "
        f"{res['ms'] * key_batches:.4f} ms per build; plain "
        f"{res['plain_ms']:.4f} ms per launch, "
        f"{res['plain_ms'] * key_batches:.4f} ms per build; bound "
        f"{res['bound_ms']:.4f} ms per launch")
    return res


def staircase_inputs(torch, G, W, CL, CR, seed, signed_zeros=False,
                     sign_bit=False, all_survive=False, live=None,
                     prefix=False):
    """Seeded survivor lists on the card: rounded (tied) scores, pruned
    -inf entries, optionally ±0.0 scores, codes with bit 31 set, a
    threshold every pair passes, or set live counts (see
    STAIRCASE_SHAPES)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sL = np.round(rng.uniform(-3, 0, (G, W, CL)), 1).astype(np.float32)
    sR = np.round(rng.uniform(-3, 0, (G, W, CR)), 1).astype(np.float32)
    if live is None:
        sL[rng.random(sL.shape) < 0.1] = -np.inf
        sR[rng.random(sR.shape) < 0.1] = -np.inf
    else:
        for side, (s, C) in enumerate(((sL, CL), (sR, CR))):
            if isinstance(live[0], int):
                n = np.resize(np.roll(live, -side), G * W).reshape(G, W)
            else:
                n = (rng.uniform(*live, (G, W)) * C).astype(np.int64)
            rank = (np.arange(C) if prefix else
                    np.argsort(np.argsort(rng.random((G, W, C)), -1), -1))
            s[rank >= n[..., None]] = -np.inf
    if signed_zeros:
        sL[..., ::5] = -0.0
        sR[..., 1::4] = -0.0
        sR[..., 2::4] = 0.0
    cL = rng.permutation(G * W * CL).astype(np.int64).reshape(G, W, CL)
    cR = rng.permutation(G * W * CR).astype(np.int64).reshape(G, W, CR)
    if sign_bit:
        cL = cL * 0x20000001 % (1 << 32)
        cR = cR * 0x30000001 % (1 << 32)
    eps = rng.uniform(-3.5, -2.5, (G, W)).astype(np.float32)
    if all_survive:
        sL, sR = np.maximum(sL, -1.0), np.maximum(sR, -1.0)
        eps[:] = -100.0
    return tuple(torch.from_numpy(x).cuda() for x in (sL, cL, sR, cR, eps))


def compare_staircase(torch, label, args, cap, sort_l, reps=5, plain_reps=2):
    """staircase_select vs staircase_select_ref on one input: raises unless
    cl, cr, scores (bit patterns) and totals are equal."""
    from ipk_tpu_torch.core import kernels, sparse
    got = kernels.staircase_select(*args, cap=cap, sort_l=sort_l)
    ref = sparse.staircase_select_ref(*args, cap=cap, sort_l=sort_l)
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(
        (got[0], got[1], got[2].view(torch.int32), got[3]),
        (ref[0], ref[1], ref[2].view(torch.int32), ref[3]))]
    if not all(same):
        raise RuntimeError(
            f"[kernel] staircase {label}: kernel differs from "
            f"staircase_select_ref (cl, cr, scores, totals equal: {same})")
    live = torch.isfinite(ref[2])
    err = (float((got[2][live] - ref[2][live]).abs().max())
           if live.any() else 0.0)
    ms = time_ms(torch, lambda: kernels.staircase_select(
        *args, cap=cap, sort_l=sort_l), reps)
    plain_ms = time_ms(torch, lambda: sparse.staircase_select_ref(
        *args, cap=cap, sort_l=sort_l), plain_reps)
    G, W, CL = args[0].shape
    _, bound_ms, bound_by = staircase_bound(
        args, got, int(ref[3].clamp(max=cap).sum()))
    log(f"[kernel] staircase {label}: G={G} W={W} CL={CL} "
        f"CR={args[2].shape[2]} cap={cap} sort_l={sort_l} bit-equal "
        f"({int(ref[3].sum())} survivors, max total {int(ref[3].max())}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def sparse_stage1(tmp, tree_file, fasta_file, ar_dir):
    """(stage-1 inputs, traits) of the phase-7 build, the scale project at
    SPARSE_SCALE's k and omega, derived as the builder derives them."""
    from ipk_tpu_torch.builder import stage1_inputs
    from ipk_tpu_torch.pipeline import BuildParams, prepare
    k, omega = SPARSE_SCALE["k"], SPARSE_SCALE["omega"]
    inp = prepare(BuildParams(
        refalign=fasta_file, reftree=tree_file, ar_dir=ar_dir,
        working_dir=os.path.join(tmp, "wd_kernel_sparse"), kmer_size=k,
        omega=omega, verbosity=0, device="cuda"))
    s1 = stage1_inputs(inp.original_tree, inp.extended_tree,
                       inp.ghost_mapping, inp.ar_mapping, inp.label_rows,
                       inp.P, sigma=inp.traits.alphabet_size, kmer_size=k,
                       omega=omega)
    return s1, inp.traits


def staircase_chunk(s1_traits, ghosts=32, cap=None, caps=None):
    """One chunk of the phase-7 build: the first whole ghost groups holding
    at least ``ghosts`` ghosts (32 by default, the chunk of builder.build)
    through sparse.enumerate_sparse_many with the kernel, recording every
    staircase_select call's inputs. caps None takes the probe's plan under
    the ceiling ``cap`` (SPARSE_SCALE's by default), as the build does.
    Returns (ghost rows, enumerate_sparse_many's keyword arguments,
    [(args, kwargs)] of each launch, its result, its stats and timings)."""
    from ipk_tpu_torch.core import kernels, sparse
    from ipk_tpu_torch.spans import Recorder
    s1, traits = s1_traits
    k = SPARSE_SCALE["k"]
    cap = cap or SPARSE_SCALE["cap"]
    if caps is None:
        caps = sparse.probe_caps(s1.P_all, s1.prefix_all, s1.eps, k=k,
                                 sigma=traits.alphabet_size, cap=cap)
    g1 = max(1, ghosts // s1.ghosts_per_group) * s1.ghosts_per_group
    chunk = dict(k=k, sigma=traits.alphabet_size,
                 bits=traits.bits_per_symbol, cap=cap, caps=caps,
                 device="cuda")
    recorded = []
    select = kernels.staircase_select

    def recording(*args, **kw):
        recorded.append(([a.clone() for a in args], kw))
        return select(*args, **kw)

    # the wrapper counts on the module attribute of its name, which is
    # `recording` while it is installed
    recording.launches = 0
    kernels.staircase_select = recording
    try:
        stats, rec = {}, Recorder()
        out = sparse.enumerate_sparse_many(
            s1.P_all[:g1], s1.prefix_all[:g1], s1.eps, stats=stats,
            recorder=rec, **chunk)
    finally:
        kernels.staircase_select = select
    return g1, chunk, recorded, out, {**stats, **rec.timings}


def chunk_vs_plain(s1, g1, chunk, out_k, st_k, n_launches, label):
    """Raise unless enumerate_sparse_many's kernel route (out_k, st_k) and
    its use_kernel=False route agree on the first g1 ghost rows (codes,
    score bits, overflow) and the kernel ran; log both."""
    import numpy as np
    from ipk_tpu_torch.core import sparse
    from ipk_tpu_torch.spans import Recorder
    rec_p = Recorder()
    out_p = sparse.enumerate_sparse_many(
        s1.P_all[:g1], s1.prefix_all[:g1], s1.eps, use_kernel=False,
        recorder=rec_p, **chunk)
    same = (np.array_equal(out_k[0], out_p[0])
            and np.array_equal(out_k[1].view(np.uint32),
                               out_p[1].view(np.uint32))
            and np.array_equal(out_k[2], out_p[2]))
    if not same or not n_launches:
        raise RuntimeError(
            f"[kernel] staircase on {label}: kernel route and "
            f"use_kernel=False differ, or the kernel never ran ({n_launches} "
            f"launches)")
    log(f"[kernel] staircase, {label} (W={out_k[1].shape[1]}, caps "
        f"{sparse._caps_key(st_k['final_caps'])}): enumerate_sparse_many "
        f"bit-equal with the kernel and with use_kernel=False (codes, "
        f"scores, overflow; {int(np.isfinite(out_k[1]).sum())} survivors, "
        f"{st_k.get('redispatches', 0)} re-dispatches); device_compute "
        f"kernel route {st_k['device_compute']:.6f} s, plain route "
        f"{rec_p.timings['device_compute']:.6f} s")


def phase_kernel_staircase(torch, tree_file, fasta_file, ar_dir, tmp, smi):
    from ipk_tpu_torch.core import kernels, sparse
    errs = []
    for n, (label, G, W, CL, CR, cap, opts) in enumerate(STAIRCASE_SHAPES):
        opts = dict(opts)
        orders = (True, False) if opts.pop("both", False) else (True,)
        args = staircase_inputs(torch, G, W, CL, CR, seed=n, **opts)
        for sort_l in orders:
            errs.append(compare_staircase(
                torch, label, args, cap, sort_l,
                plain_reps=1 if CL >= 4096 else 2)["max_abs_err"])
        if opts.get("all_survive"):
            tot = kernels.staircase_select(*args, cap=cap)[3]
            if not bool((tot == CL * CR).all()):
                raise RuntimeError("[kernel] staircase overflow: totals are "
                                   "not the true survivor count")
        del args

    # the first chunk of the phase-7 build, cut as the builder cuts it
    k, omega = SPARSE_SCALE["k"], SPARSE_SCALE["omega"]
    s1_traits = sparse_stage1(tmp, tree_file, fasta_file, ar_dir)
    s1, traits = s1_traits
    g1, chunk, recorded, out_k, st_k = staircase_chunk(s1_traits)
    chunk_vs_plain(s1, g1, chunk, out_k, st_k, len(recorded),
                   f"first {g1}-ghost chunk of the DNA k={k} omega={omega} "
                   f"scale project")
    runs = []
    for n, (args, kw) in enumerate(recorded):
        label = f"chunk launch {n + 1}/{len(recorded)}"
        run = compare_staircase(torch, label, args, kw["cap"], kw["sort_l"],
                                reps=5, plain_reps=1)
        runs.append(run)
        log(f"[main path] staircase_select, {label} of the DNA k={k} scale "
            f"build: L {tuple(args[0].shape)} x R {tuple(args[2].shape)}, "
            f"cap {kw['cap']}, sort_l {kw['sort_l']}: kernel "
            f"{run['ms']:.4f} ms (CUDA events, mean of 5 after a warm-up); "
            f"bound {run['bound_ms']:.4f} ms ({run['bound_by']}), kernel at "
            f"{100 * run['bound_ms'] / run['ms']:.1f}% of it; {smi}")
    del recorded, out_k

    # a few ghosts with the top span's cap above 8192
    caps = sparse.normalize_caps(WIDE_CAPS["caps"], k, traits.alphabet_size,
                                 WIDE_CAPS["cap"])
    g_w, chunk_w, rec_w, out_w, st_w = staircase_chunk(
        s1_traits, ghosts=WIDE_CAPS["ghosts"], cap=WIDE_CAPS["cap"],
        caps=caps)
    top = max(kw["cap"] for _, kw in rec_w)
    if top <= 8192:
        raise RuntimeError(f"[kernel] staircase forced caps: no launch "
                           f"above 8192 (widest cap {top})")
    chunk_vs_plain(s1, g_w, chunk_w, out_w, st_w, len(rec_w),
                   f"first {g_w} ghosts with the top cap forced above 8192 "
                   f"under a ceiling of {WIDE_CAPS['cap']} (widest launch "
                   f"cap {top})")
    del rec_w, out_w
    torch.cuda.empty_cache()
    res = dict(max_abs_err=max(errs + [r["max_abs_err"] for r in runs]),
               ms=sum(r["ms"] for r in runs) / len(runs),
               plain_ms=sum(r["plain_ms"] for r in runs) / len(runs),
               bound_ms=sum(r["bound_ms"] for r in runs) / len(runs),
               bound_by=runs[0]["bound_by"], s1_traits=s1_traits)
    log(f"[kernel] staircase on the chunk: {len(runs)} launches per chunk "
        f"run, kernel {res['ms']:.4f} ms per launch, "
        f"{res['ms'] * len(runs):.4f} ms per chunk; plain "
        f"{res['plain_ms']:.4f} ms per launch, "
        f"{res['plain_ms'] * len(runs):.4f} ms per chunk; bound "
        f"{res['bound_ms']:.4f} ms per launch ({res['bound_by']})")
    return res


def phase_goldens(torch, tmp):
    from ipk_tpu_torch.core import kernels
    from ipk_tpu_torch.pipeline import BuildParams, build_database, get_traits
    for proj, states, k, omega, golden in [
            ("D-dna", "nucl", 7, 2.0, "DB_k7_o2.0.ipk"),
            ("D-aa", "amino", 4, 10.0, "DB_k4_o10.ipk")]:
        root = os.path.join(REPO, "tests", "data", "golden", proj)
        out = os.path.join(tmp, f"{proj}.ipk")
        before = kernels.combine_max.launches
        result = build_database(BuildParams(
            refalign=os.path.join(root, "reference.fasta"),
            reftree=os.path.join(root, "tree.newick"), states=states,
            working_dir=os.path.join(tmp, f"wd_{proj}"),
            ar_dir=os.path.join(root, "ar_out"), kmer_size=k, omega=omega,
            output_filename=out, verbosity=0, device="cuda"))
        launched = kernels.combine_max.launches - before
        if payload(out) != payload(os.path.join(root, golden)):
            raise RuntimeError(f"[goldens] {proj}: payload differs from "
                               f"the committed {golden}")
        if launched <= 0:
            raise RuntimeError(f"[goldens] {proj}: combine_max never launched")
        log(f"[goldens] {proj} k={k}: payload-equal to {golden} "
            f"({result.db.size()} k-mers, {result.num_explored} tuples, "
            f"{launched} combine_max launches)")
    # amino with survivors (the D-aa golden holds none): card vs CPU
    aa = os.path.join(tmp, "aa")
    os.makedirs(aa)
    tree_file, fasta_file, ar_dir = make_project(
        pathlib.Path(aa), num_leaves=12, width=60, seed=5, traits=get_traits("amino"))
    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = os.path.join(aa, f"DB_{dev}.ipk")
        result = build_database(BuildParams(
            refalign=fasta_file, reftree=tree_file, states="amino",
            working_dir=os.path.join(aa, f"wd_{dev}"), ar_dir=ar_dir,
            kmer_size=4, omega=6.0, output_filename=outs[dev], verbosity=0,
            device=dev))
    if payload(outs["cuda"]) != payload(outs["cpu"]) or result.db.size() == 0:
        raise RuntimeError("[goldens] amino k=4: card and CPU builds differ "
                           "or are empty")
    log(f"[goldens] amino k=4 project: card payload-equal to CPU "
        f"({result.db.size()} k-mers, {result.num_explored} tuples)")


def phase_scale(torch, tmp, tree_file, fasta_file, ar_dir, kernel_tuples):
    import numpy as np
    from ipk_tpu_torch.pipeline import BuildParams, build_database
    args = dict(refalign=fasta_file, reftree=tree_file, kmer_size=SCALE["k"],
                omega=SCALE["omega"], ar_dir=ar_dir, verbosity=0,
                device="cuda")
    out1 = os.path.join(tmp, "scale_1.ipk")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    result = build_database(BuildParams(
        working_dir=os.path.join(tmp, "wd_s1"), output_filename=out1,
        **args))
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    out2 = os.path.join(tmp, "scale_2.ipk")
    t0 = time.monotonic()
    cli = subprocess.run(
        [sys.executable, "-m", "ipk_tpu_torch", "build", "-r", fasta_file,
         "-t", tree_file, "-w", os.path.join(tmp, "wd_s2"), "-k",
         str(SCALE["k"]), "--omega", str(SCALE["omega"]), "--ar-dir", ar_dir,
         "-m", "GTR", "-o", out2, "-v", "0", "--device", "cuda"],
        cwd=tmp, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p])})
    cli_wall = time.monotonic() - t0
    if cli.returncode != 0:
        raise RuntimeError(f"[scale] python -m ipk_tpu_torch build failed "
                           f"({cli.returncode}):\n{cli.stderr[-4000:]}")
    if open(out1, "rb").read() != open(out2, "rb").read():
        raise RuntimeError("[scale] the two builds are not byte-identical")
    db = result.db
    if db.size() == 0 or not np.isfinite(db.scores).all():
        raise RuntimeError("[scale] empty database or non-finite scores")
    if result.num_explored != kernel_tuples:
        raise RuntimeError(f"[scale] build explored {result.num_explored} "
                           f"tuples, the kernel check counted {kernel_tuples}")
    timings = {k: (round(v, 6) if isinstance(v, float) else v)
               for k, v in result.timings.items()}
    rate = result.num_explored / result.timings["device_compute"]
    log(f"[scale] {SCALE['num_leaves']} taxa x {SCALE['width']} sites, DNA "
        f"k={SCALE['k']}: {db.size()} k-mers, {db.num_entries()} entries; "
        f"byte-identical across in-process and CLI builds")
    log(f"[scale] timings {json.dumps(timings)}")
    log(f"[scale] build wall {wall:.3f} s (CLI process {cli_wall:.3f} s); "
        f"num_explored {result.num_explored}; stage-1 tuples/s "
        f"{rate:.4e}; max_memory_allocated {peak} B")


def build_sparse(params, out, **extra):
    """prepare + builder.build forced onto the sparse path (as a caller of
    ``build(..., sparse=True)`` would); returns the BuildResult."""
    from ipk_tpu_torch import builder
    from ipk_tpu_torch.pipeline import prepare
    inp = prepare(params)
    return builder.build(
        inp.original_tree, inp.extended_tree, inp.ghost_mapping,
        inp.ar_mapping, inp.label_rows, inp.P, traits=inp.traits,
        kmer_size=params.kmer_size, omega=params.omega, sparse=True,
        sparse_cap=params.max_candidates, output_filename=out,
        device=params.device, verbose=0, **extra)


def phase_sparse_goldens(torch, tmp):
    from ipk_tpu_torch.core import kernels
    from ipk_tpu_torch.pipeline import BuildParams, build_database
    for proj, states, k, omega, golden in [
            ("D-dna", "nucl", 7, 2.0, "DB_k7_o2.0.ipk"),
            ("D-aa", "amino", 4, 10.0, "DB_k4_o10.ipk")]:
        root = os.path.join(REPO, "tests", "data", "golden", proj)
        out = os.path.join(tmp, f"{proj}_sparse.ipk")
        before = kernels.staircase_select.launches
        result = build_sparse(BuildParams(
            refalign=os.path.join(root, "reference.fasta"),
            reftree=os.path.join(root, "tree.newick"), states=states,
            working_dir=os.path.join(tmp, f"wd_{proj}_sparse"),
            ar_dir=os.path.join(root, "ar_out"), kmer_size=k, omega=omega,
            verbosity=0, device="cuda"), out)
        if payload(out) != payload(os.path.join(root, golden)):
            raise RuntimeError(f"[sparse goldens] {proj}: the sparse build's "
                               f"payload differs from the committed {golden}")
        log(f"[sparse goldens] {proj} k={k} through the sparse path: "
            f"payload-equal to {golden} ({result.db.size()} k-mers, "
            f"{result.num_explored} tuples, "
            f"{kernels.staircase_select.launches - before} staircase "
            f"launches, caps {result.stats.get('final_caps')})")
    # amino at k=6: sparse by sigma^k; the card through the CLI, the CPU in
    # process
    aa = os.path.join(tmp, "aa")
    k, omega = 6, 4.0
    card = os.path.join(aa, "DB_k6_cuda.ipk")
    run_cli(["-r", os.path.join(aa, "reference.fasta"), "-t",
             os.path.join(aa, "tree.newick"), "-s", "amino", "-m", "LG",
             "-w", os.path.join(aa, "wd_k6_cuda"), "-k", str(k), "--omega",
             str(omega), "--ar-dir", os.path.join(aa, "ar_out"), "-o", card,
             "-v", "0", "--device", "cuda"], tmp, "[sparse goldens] amino")
    cpu = os.path.join(aa, "DB_k6_cpu.ipk")
    result = build_database(BuildParams(
        refalign=os.path.join(aa, "reference.fasta"),
        reftree=os.path.join(aa, "tree.newick"), states="amino",
        working_dir=os.path.join(aa, "wd_k6_cpu"),
        ar_dir=os.path.join(aa, "ar_out"), kmer_size=k, omega=omega,
        output_filename=cpu, verbosity=0, device="cpu"))
    if (payload(card) != payload(cpu) or result.db.size() == 0
            or not result.stats.get("final_caps")):
        raise RuntimeError("[sparse goldens] amino k=6: card and CPU builds "
                           "differ, are empty or did not take the sparse "
                           "path")
    log(f"[sparse goldens] amino k={k} omega={omega} project: card (CLI) "
        f"payload-equal to CPU ({result.db.size()} k-mers, "
        f"{result.num_explored} tuples, caps {result.stats['final_caps']})")


def run_cli(args, cwd, label):
    t0 = time.monotonic()
    cli = subprocess.run(
        [sys.executable, "-m", "ipk_tpu_torch", "build", *args],
        cwd=cwd, capture_output=True, text=True, timeout=900,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p])})
    if cli.returncode != 0:
        raise RuntimeError(f"{label}: python -m ipk_tpu_torch build failed "
                           f"({cli.returncode}):\n{cli.stderr[-4000:]}")
    return time.monotonic() - t0


def phase_sparse_scale(torch, tmp, tree_file, fasta_file, ar_dir):
    import numpy as np
    from ipk_tpu_torch.core import kernels
    from ipk_tpu_torch.pipeline import BuildParams, build_database
    k, omega, cap = (SPARSE_SCALE["k"], SPARSE_SCALE["omega"],
                     SPARSE_SCALE["cap"])
    out = os.path.join(tmp, "sparse_scale.ipk")
    before = kernels.staircase_select.launches
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    result = build_database(BuildParams(
        refalign=fasta_file, reftree=tree_file, kmer_size=k, omega=omega,
        max_candidates=cap, ar_dir=ar_dir,
        working_dir=os.path.join(tmp, "wd_sparse_scale"),
        output_filename=out, verbosity=0, device="cuda"))
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    launched = kernels.staircase_select.launches - before
    db = result.db
    if (db.size() == 0 or not np.isfinite(db.scores).all() or launched <= 0
            or not result.stats.get("final_caps")):
        raise RuntimeError(f"[sparse scale] empty database, non-finite "
                           f"scores, or the sparse path / kernel did not run "
                           f"({launched} staircase launches)")
    timings = {key: (round(v, 6) if isinstance(v, float) else v)
               for key, v in result.timings.items()}
    log(f"[sparse scale] {SCALE['num_leaves']} taxa x {SCALE['width']} "
        f"sites, DNA k={k} omega={omega}: {db.size()} k-mers, "
        f"{db.num_entries()} entries; num_explored {result.num_explored}; "
        f"{launched} staircase launches; "
        f"{result.stats.get('redispatches', 0)} re-dispatches; settled caps "
        f"{sorted(result.stats['final_caps'].items())}")
    log(f"[sparse scale] timings {json.dumps(timings)}")
    log(f"[sparse scale] build wall {wall:.3f} s; max_memory_allocated "
        f"{peak} B")

    # anchor at a middle size: dense and forced-sparse byte-identical
    mid = os.path.join(tmp, "mid")
    os.makedirs(mid)
    tree_m, fasta_m, ar_m = make_project(
        pathlib.Path(mid), num_leaves=MID["num_leaves"], width=MID["width"],
        seed=MID["seed"])
    params = dict(refalign=fasta_m, reftree=tree_m, kmer_size=MID["k"],
                  omega=MID["omega"], ar_dir=ar_m, verbosity=0,
                  device="cuda")
    dense_out = os.path.join(mid, "dense.ipk")
    t0 = time.monotonic()
    r_dense = build_database(BuildParams(
        working_dir=os.path.join(mid, "wd_dense"),
        output_filename=dense_out, **params))
    t_dense = time.monotonic() - t0
    sparse_out = os.path.join(mid, "sparse.ipk")
    t0 = time.monotonic()
    r_sparse = build_sparse(BuildParams(
        working_dir=os.path.join(mid, "wd_sparse"), **params), sparse_out)
    t_sparse = time.monotonic() - t0
    if (open(dense_out, "rb").read() != open(sparse_out, "rb").read()
            or r_dense.db.size() == 0):
        raise RuntimeError(f"[sparse scale] DNA k={MID['k']} anchor: dense "
                           "and sparse builds are not byte-identical (or "
                           "empty)")
    log(f"[sparse scale] {MID['num_leaves']} taxa x {MID['width']} sites, "
        f"DNA k={MID['k']} omega={MID['omega']}: dense (combine_max, "
        f"extract_columns) and forced-sparse (staircase, host mif0) builds "
        f"byte-identical "
        f"({r_dense.db.size()} k-mers, {r_dense.db.num_entries()} entries; "
        f"explored dense {r_dense.num_explored}, sparse "
        f"{r_sparse.num_explored}); wall dense {t_dense:.3f} s, sparse "
        f"{t_sparse:.3f} s")


def compare_positions(torch, label, L, R, eps, reps=5, plain_reps=1):
    """combine_max_with_positions vs its plain version on one input: raises
    unless A (bit patterns), pos and counts are equal."""
    from ipk_tpu_torch.core import dense, kernels
    A, pos, counts = kernels.combine_max_with_positions(L, R, eps)
    A_ref, pos_ref, counts_ref = dense.combine_max_with_positions_ref(
        L, R, eps)
    torch.cuda.synchronize()
    same = [torch.equal(A.view(torch.int32), A_ref.view(torch.int32)),
            torch.equal(pos, pos_ref), torch.equal(counts, counts_ref)]
    if not all(same):
        raise RuntimeError(
            f"[positions] {label}: kernel differs from "
            f"combine_max_with_positions_ref (A bits, pos, counts equal: "
            f"{same})")
    live = torch.isfinite(A_ref)
    err = float((A[live] - A_ref[live]).abs().max()) if live.any() else 0.0
    zeros = A_ref == 0
    n_neg_zero = int((zeros & torch.signbit(A_ref)).sum())
    ms = time_ms(torch, lambda: kernels.combine_max_with_positions(L, R, eps),
                 reps)
    plain_ms = time_ms(torch, lambda: dense.combine_max_with_positions_ref(
        L, R, eps), plain_reps)
    G, W, nl = L.shape
    bound_ms, bound_by = combine_bound(G, W, nl, R.shape[2], positions=True)
    log(f"[positions] {label}: G={G} W={W} nl={nl} nr={R.shape[2]} "
        f"bit-equal (A, pos, counts; {int(live.sum())} live cells, "
        f"{int(zeros.sum())} zero maxima of which {n_neg_zero} -0.0, "
        f"max pos {int(pos.max()) if pos.numel() else 0}, "
        f"{int(counts.sum())} tuples); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                tuples=int(counts.sum()), pos=pos, zeros=int(zeros.sum()),
                neg_zeros=n_neg_zero, bound_ms=bound_ms, bound_by=bound_by)


def phase_positions_kernel(torch, tmp, tree_file, fasta_file, ar_dir, smi):
    """Phase 8, first part: the kernel's positions mode against its plain
    version (these launches are not the main path's)."""
    import numpy as np
    from ipk_tpu_torch.builder import (choose_key_batches, stage1_inputs,
                                       stage1_state)
    from ipk_tpu_torch.core.dense import masked_halves
    from ipk_tpu_torch.pipeline import BuildParams, prepare
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    errs = []
    G, W, nl, nr = 3, 70, 33, 65
    L = rng.normal(size=(G, W, nl)).astype(np.float32)
    L[rng.random(L.shape) < 0.2] = -np.inf
    R = rng.normal(size=(G, W, nr)).astype(np.float32)
    errs.append(compare_positions(
        torch, "ragged random", torch.from_numpy(L).to(dev),
        torch.from_numpy(R).to(dev),
        torch.tensor(np.float32(0.5), device=dev))["max_abs_err"])
    res = compare_positions(
        torch, "constant matrix (every window ties)",
        torch.full((2, 37, 40), -0.75, device=dev),
        torch.full((2, 37, 70), -0.5, device=dev),
        torch.tensor(np.float32(-2.0), device=dev))
    if bool((res["pos"] != 0).any()):
        raise RuntimeError("[positions] constant matrix: a position is not "
                           "the earliest window")
    errs.append(res["max_abs_err"])
    L = -np.abs(np.round(rng.normal(size=(2, 100, 40)), 0)).astype(np.float32)
    R = -np.abs(np.round(rng.normal(size=(2, 100, 70)), 0)).astype(np.float32)
    L[rng.random(L.shape) < 0.4] = -0.0
    R[rng.random(R.shape) < 0.3] = -0.0
    R[rng.random(R.shape) < 0.2] = 0.0
    res = compare_positions(
        torch, "signed zeros", torch.from_numpy(L).to(dev),
        torch.from_numpy(R).to(dev),
        torch.tensor(np.float32(-1.5), device=dev))
    if not 0 < res["neg_zeros"] < res["zeros"]:
        raise RuntimeError("[positions] signed zeros: the input reached no "
                           "zero maximum of each sign")
    errs.append(res["max_abs_err"])
    # the scale project's halves, cut as a --keep-positions build cuts them
    inp = prepare(BuildParams(
        refalign=fasta_file, reftree=tree_file, ar_dir=ar_dir,
        working_dir=os.path.join(tmp, "wd_kernel_pos"), kmer_size=SCALE["k"],
        omega=SCALE["omega"], verbosity=0, device="cuda"))
    s1 = stage1_inputs(inp.original_tree, inp.extended_tree,
                       inp.ghost_mapping, inp.ar_mapping, inp.label_rows,
                       inp.P, sigma=inp.traits.alphabet_size,
                       kmer_size=SCALE["k"], omega=SCALE["omega"])
    Pt, pre, eps = stage1_state(s1.P_all, s1.prefix_all, s1.eps, dev)
    L, R = masked_halves(Pt, pre, eps, k=SCALE["k"],
                         sigma=inp.traits.alphabet_size)
    del Pt, pre
    nl, nr = L.shape[2], R.shape[2]
    key_batches = choose_key_batches(len(s1.group_ids), nl, nr,
                                     keep_positions=True)
    step = nl // key_batches
    runs = []
    for b in range(key_batches):
        Lb = L[:, :, b * step:(b + 1) * step].contiguous()
        label = (f"DNA k=8 scale project, --keep-positions key batch "
                 f"{b + 1}/{key_batches}")
        run = compare_positions(torch, label, Lb, R, eps)
        runs.append(run)
        log(f"[main path] combine_max_with_positions, {label}: L "
            f"{tuple(Lb.shape)} x R {tuple(R.shape)}: kernel "
            f"{run['ms']:.4f} ms (CUDA events, mean of 5 after a warm-up); "
            f"bound {run['bound_ms']:.4f} ms ({run['bound_by']}), kernel at "
            f"{100 * run['bound_ms'] / run['ms']:.1f}% of it; {smi}")
        del Lb
    del L, R
    torch.cuda.empty_cache()
    res = dict(max_abs_err=max(errs + [r["max_abs_err"] for r in runs]),
               ms=sum(r["ms"] for r in runs) / key_batches,
               plain_ms=sum(r["plain_ms"] for r in runs) / key_batches,
               bound_ms=sum(r["bound_ms"] for r in runs) / key_batches,
               bound_by=runs[0]["bound_by"],
               launches_per_build=key_batches)
    log(f"[positions] DNA k=8 scale project: {key_batches} launch(es) per "
        f"--keep-positions build, kernel {res['ms']:.4f} ms per launch; "
        f"plain {res['plain_ms']:.4f} ms per launch")
    return res


def load_db(path):
    from ipk_tpu_torch.builder import serialize
    return serialize.load(path)


def phase_positions(torch, tmp, tree_file, fasta_file, ar_dir):
    """Phase 8, second part: --keep-positions builds on the main path."""
    import numpy as np
    from ipk_tpu_torch.pipeline import BuildParams, build_database
    out = os.path.join(tmp, "scale_pos.ipk")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    result = build_database(BuildParams(
        refalign=fasta_file, reftree=tree_file, kmer_size=SCALE["k"],
        omega=SCALE["omega"], ar_dir=ar_dir, keep_positions=True,
        working_dir=os.path.join(tmp, "wd_pos"), output_filename=out,
        verbosity=0, device="cuda"))
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    pos_db, plain_db = load_db(out), load_db(os.path.join(tmp, "scale_1.ipk"))
    W = SCALE["width"] - SCALE["k"] + 1
    for name in ("keys", "offsets", "branches", "scores"):
        if (getattr(pos_db, name).tobytes()
                != getattr(plain_db, name).tobytes()):
            raise RuntimeError(f"[positions] scale build: {name} differ "
                               "from phase 5's build")
    if (pos_db.positions is None or len(pos_db.positions) != len(
            pos_db.scores) or int(pos_db.positions.max()) >= W):
        raise RuntimeError("[positions] scale build: positions missing or "
                           "out of range")
    timings = {k: (round(v, 6) if isinstance(v, float) else v)
               for k, v in result.timings.items()}
    log(f"[positions] {SCALE['num_leaves']} taxa x {SCALE['width']} sites, "
        f"DNA k={SCALE['k']} --keep-positions: {pos_db.size()} k-mers, "
        f"{pos_db.num_entries()} entries; keys, offsets, branches and "
        f"scores byte-equal to phase 5's build; positions 0..."
        f"{int(pos_db.positions.max())} (mean "
        f"{float(pos_db.positions.mean()):.3f})")
    log(f"[positions] timings {json.dumps(timings)}")
    log(f"[positions] build wall {wall:.3f} s; transfer_bytes "
        f"{result.timings['transfer_bytes']}; max_memory_allocated {peak} B")

    # amino through the CLI on the card, against the CPU in process
    aa = os.path.join(tmp, "aa")
    card = os.path.join(aa, "DB_pos_cuda.ipk")
    cli_wall = run_cli(
        ["-r", os.path.join(aa, "reference.fasta"), "-t",
         os.path.join(aa, "tree.newick"), "-s", "amino", "-m", "LG", "-w",
         os.path.join(aa, "wd_pos_cuda"), "-k", "4", "--omega", "6.0",
         "--ar-dir", os.path.join(aa, "ar_out"), "--keep-positions", "-o",
         card, "-v", "0", "--device", "cuda"], tmp, "[positions] amino")
    cpu = os.path.join(aa, "DB_pos_cpu.ipk")
    build_database(BuildParams(
        refalign=os.path.join(aa, "reference.fasta"),
        reftree=os.path.join(aa, "tree.newick"), states="amino",
        working_dir=os.path.join(aa, "wd_pos_cpu"),
        ar_dir=os.path.join(aa, "ar_out"), kmer_size=4, omega=6.0,
        keep_positions=True, output_filename=cpu, verbosity=0, device="cpu"))
    aa_db = load_db(card)
    if (payload(card) != payload(cpu) or aa_db.size() == 0
            or aa_db.positions is None):
        raise RuntimeError("[positions] amino k=4 --keep-positions: card "
                           "(CLI) and CPU builds differ, or are empty or "
                           "without positions")
    log(f"[positions] amino k=4 --keep-positions project: card (CLI, "
        f"{cli_wall:.3f} s) payload-equal to CPU ({aa_db.size()} k-mers, "
        f"{aa_db.num_entries()} entries)")

    # the 64-taxon project at DNA k=8, positions and merged branches
    mid = os.path.join(tmp, "mid")
    outs, walls = {}, {}
    for dev in ("cuda", "cpu"):
        outs[dev] = os.path.join(mid, f"pos_merge_{dev}.ipk")
        t0 = time.monotonic()
        build_database(BuildParams(
            refalign=os.path.join(mid, "reference.fasta"),
            reftree=os.path.join(mid, "tree.newick"),
            ar_dir=os.path.join(mid, "ar_out"), kmer_size=POS_MID["k"],
            omega=POS_MID["omega"], keep_positions=True, merge_branches=True,
            working_dir=os.path.join(mid, f"wd_pos_{dev}"),
            output_filename=outs[dev], verbosity=0, device=dev))
        walls[dev] = time.monotonic() - t0
    mid_db = load_db(outs["cuda"])
    if (payload(outs["cuda"]) != payload(outs["cpu"]) or mid_db.size() == 0
            or mid_db.positions is None
            or not (np.diff(mid_db.offsets) == 1).all()):
        raise RuntimeError("[positions] DNA k=8 --keep-positions "
                           "--merge-branches: card and CPU builds differ, or "
                           "are empty, without positions or not merged")
    log(f"[positions] {MID['num_leaves']} taxa x {MID['width']} sites, DNA "
        f"k={POS_MID['k']} --keep-positions --merge-branches: card "
        f"payload-equal to CPU ({mid_db.size()} k-mers, one entry each); "
        f"wall card {walls['cuda']:.3f} s, CPU {walls['cpu']:.3f} s")


def by_key(db):
    """The database's rows in key order: (keys, filter values, entry counts,
    branches, scores), every entry run kept in its stored order."""
    import numpy as np
    order = np.argsort(db.keys, kind="stable")
    counts = np.diff(db.offsets)[order]
    ends = np.cumsum(counts)
    run = np.repeat(np.arange(len(order)), counts)
    idx = (db.offsets[:-1][order][run]
           + np.arange(int(ends[-1]) if len(ends) else 0) - (ends - counts)[run])
    return (db.keys[order], db.filter_values[order], counts, db.branches[idx],
            db.scores[idx])


def same_rows(disk_path, ram_path, label):
    """Raise unless the on-disk file holds the in-RAM file's rows, sorted by
    (float32 filter value, key); return how many rows sit elsewhere than in
    the in-RAM file, and whether the payloads are equal."""
    import numpy as np
    disk, ram = load_db(disk_path), load_db(ram_path)
    same = [a.tobytes() == b.tobytes()
            for a, b in zip(by_key(disk), by_key(ram))]
    if not all(same) or disk.size() == 0:
        raise RuntimeError(f"[on-disk] {label}: the rows differ from the "
                           f"in-RAM build, or are none (keys, fv, counts, "
                           f"branches, scores equal: {same})")
    order = np.lexsort((disk.keys, disk.filter_values))
    if not np.array_equal(order, np.arange(len(order))):
        raise RuntimeError(f"[on-disk] {label}: not sorted by (float32 "
                           "filter value, key)")
    return (int((disk.keys != ram.keys).sum()),
            payload(disk_path) == payload(ram_path))


def phase_on_disk(torch, tmp, tree_file, fasta_file, ar_dir):
    """The on-disk merge orders rows by the filter values it reads back as
    float32, then by key (ipk_tpu's ``_merge_on_disk``); the in-RAM sort
    orders by the float64 values. So the two files hold the same rows, in
    the same order except among keys whose float32 filter values tie while
    their float64 values differ: ipk_tpu's own on-disk build differs from
    its in-RAM build there. The checks follow: the same rows in the (f32 fv,
    key) order, and card == CPU payloads of a multi-batch on-disk build."""
    from ipk_tpu_torch.pipeline import BuildParams, build_database
    wd = os.path.join(tmp, "wd_disk")
    out = os.path.join(tmp, "scale_disk.ipk")
    t0 = time.monotonic()
    result = build_database(BuildParams(
        refalign=fasta_file, reftree=tree_file, kmer_size=SCALE["k"],
        omega=SCALE["omega"], ar_dir=ar_dir, on_disk=True, working_dir=wd,
        output_filename=out, verbosity=0, device="cuda"))
    wall = time.monotonic() - t0
    moved, equal = same_rows(out, os.path.join(tmp, "scale_1.ipk"),
                             "the scale build")
    if os.path.exists(os.path.join(wd, "hashmaps")) or result.db.size():
        raise RuntimeError("[on-disk] hashmaps/ left behind, or the result "
                           "holds arrays")
    timings = {k: (round(v, 6) if isinstance(v, float) else v)
               for k, v in result.timings.items()}
    log(f"[on-disk] {SCALE['num_leaves']} taxa x {SCALE['width']} sites, "
        f"DNA k={SCALE['k']} --on-disk: the same {load_db(out).size()} rows "
        f"as phase 5's in-RAM file (keys, fv, entries), sorted by (f32 fv, "
        f"key); {moved} rows sit elsewhere than in the in-RAM file "
        f"({equal} payload-equal); hashmaps/ removed; wall {wall:.3f} s; "
        f"timings {json.dumps(timings)}")
    mid = os.path.join(tmp, "mid")
    outs, walls = {}, {}
    for dev in ("cuda", "cpu"):
        outs[dev] = os.path.join(mid, f"disk_k8_{dev}.ipk")
        wd = os.path.join(mid, f"wd_disk_k8_{dev}")
        t0 = time.monotonic()
        build_database(BuildParams(
            refalign=os.path.join(mid, "reference.fasta"),
            reftree=os.path.join(mid, "tree.newick"),
            ar_dir=os.path.join(mid, "ar_out"), kmer_size=POS_MID["k"],
            omega=POS_MID["omega"], on_disk=True, working_dir=wd,
            output_filename=outs[dev], verbosity=0, device=dev))
        walls[dev] = time.monotonic() - t0
        if os.path.exists(os.path.join(wd, "hashmaps")):
            raise RuntimeError("[on-disk] k=8: hashmaps/ left behind")
    if payload(outs["cuda"]) != payload(outs["cpu"]):
        raise RuntimeError("[on-disk] DNA k=8 --on-disk: card and CPU builds "
                           "differ")
    log(f"[on-disk] {MID['num_leaves']} taxa x {MID['width']} sites, DNA "
        f"k={POS_MID['k']} --on-disk (key batches merged): card "
        f"payload-equal to CPU ({load_db(outs['cuda']).size()} k-mers); wall "
        f"card {walls['cuda']:.3f} s, CPU {walls['cpu']:.3f} s")
    # the same build with its output on the null device: the spill and the
    # merge's sections stay under the working directory and go with it
    wd = os.path.join(mid, "wd_disk_k8_null")
    t0 = time.monotonic()
    result = build_database(BuildParams(
        refalign=os.path.join(mid, "reference.fasta"),
        reftree=os.path.join(mid, "tree.newick"),
        ar_dir=os.path.join(mid, "ar_out"), kmer_size=POS_MID["k"],
        omega=POS_MID["omega"], on_disk=True, working_dir=wd,
        output_filename=os.devnull, verbosity=0, device="cuda"))
    wall = time.monotonic() - t0
    left = sorted(set(os.listdir(wd)) - set(os.listdir(
        os.path.join(mid, "wd_disk_k8_cuda"))))
    if (os.path.exists(os.devnull + ".merge") or left
            or os.path.exists(os.path.join(wd, "hashmaps"))):
        raise RuntimeError(f"[on-disk] output on {os.devnull}: "
                           f"{os.devnull}.merge or hashmaps/ left behind, or "
                           f"{left} in the working directory")
    t = result.timings
    log(f"[on-disk] DNA k={POS_MID['k']} --on-disk -o {os.devnull}: "
        f"nothing beside the output, hashmaps/ and its merge sections "
        f"removed; {t['spill_parts']} parts, {t['spill_bytes']} bytes "
        f"spilled, {t['merge_rows']} rows merged in {t['merge_blocks']} "
        f"blocks; spill {t['spill']:.3f} s, merge blocks "
        f"{t['merge.blocks']:.3f} s, write {t['merge.write']:.3f} s; wall "
        f"{wall:.3f} s")
    wd = os.path.join(mid, "wd_sparse_disk")
    out = os.path.join(mid, "sparse_disk.ipk")
    t0 = time.monotonic()
    build_sparse(BuildParams(
        refalign=os.path.join(mid, "reference.fasta"),
        reftree=os.path.join(mid, "tree.newick"),
        ar_dir=os.path.join(mid, "ar_out"), kmer_size=MID["k"],
        omega=MID["omega"], working_dir=wd, verbosity=0, device="cuda"), out,
        on_disk=True, working_dir=wd)
    wall = time.monotonic() - t0
    moved, equal = same_rows(out, os.path.join(mid, "sparse.ipk"),
                             f"the forced-sparse DNA k={MID['k']} build")
    if os.path.exists(os.path.join(wd, "hashmaps")):
        raise RuntimeError("[on-disk] sparse: hashmaps/ left behind")
    log(f"[on-disk] {MID['num_leaves']} taxa x {MID['width']} sites, DNA "
        f"k={MID['k']} forced sparse --on-disk: the same "
        f"{load_db(out).size()} rows as its in-RAM sparse build, sorted by "
        f"(f32 fv, key); {moved} rows sit elsewhere ({equal} payload-equal); "
        f"hashmaps/ removed; wall {wall:.3f} s")


def read_alignment(path):
    """FASTA → [rows, width] uint8 (the smoke's own parser)."""
    import numpy as np
    seqs, cur = [], []
    for line in open(path):
        line = line.strip()
        if line.startswith(">"):
            if cur:
                seqs.append("".join(cur))
            cur = []
        elif line:
            cur.append(line)
    if cur:
        seqs.append("".join(cur))
    return np.frombuffer("".join(seqs).encode("ascii"),
                         np.uint8).reshape(len(seqs), -1)


def make_reads(fasta_file, path):
    """READS["n"] reads of READS["length"] sites cut from random leaves of
    the alignment at random offsets, each site substituted by another base
    with probability READS["subst"], from READS["seed"]."""
    import numpy as np
    rng = np.random.default_rng(READS["seed"])
    aln = read_alignment(fasta_file)
    n, length = READS["n"], READS["length"]
    rows = rng.integers(0, aln.shape[0], n)
    starts = rng.integers(0, aln.shape[1] - length + 1, n)
    reads = aln[rows[:, None], starts[:, None] + np.arange(length)]
    lut = np.full(256, 0, np.int64)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    codes = lut[reads]
    subst = rng.random(reads.shape) < READS["subst"]
    codes = np.where(subst, (codes + rng.integers(1, 4, reads.shape)) % 4,
                     codes)
    reads = np.frombuffer(b"ACGT", np.uint8)[codes]
    with open(path, "wb") as f:
        f.write(b"".join(b">r%d\n%s\n" % (i, reads[i].tobytes())
                         for i in range(n)))
    return [r.tobytes().decode() for r in reads], float(subst.mean())


def phase_placement(torch, tmp, fasta_file):
    import re
    import numpy as np
    from ipk_tpu_torch.placement import TorchPlacementIndex
    db_path = os.path.join(tmp, "scale_1.ipk")
    reads_path = os.path.join(tmp, "reads.fasta")
    t0 = time.monotonic()
    reads, rate = make_reads(fasta_file, reads_path)
    log(f"[place] {len(reads)} reads of {READS['length']} sites, "
        f"{rate:.4f} of sites substituted, written in "
        f"{time.monotonic() - t0:.3f} s")
    jplace = os.path.join(tmp, "reads.jplace")
    t0 = time.monotonic()
    cli = subprocess.run(
        [sys.executable, "-m", "ipk_tpu_torch", "place", db_path, reads_path,
         "-o", jplace, "--top", "7", "--device", "cuda"],
        cwd=tmp, capture_output=True, text=True, timeout=900,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p])})
    cli_wall = time.monotonic() - t0
    if cli.returncode != 0:
        raise RuntimeError(f"[place] python -m ipk_tpu_torch place failed "
                           f"({cli.returncode}):\n{cli.stderr[-4000:]}")
    summary = cli.stdout.strip().splitlines()[-1]
    m = re.search(r"Placed (\d+) queries .* in ([0-9.]+) s \(([0-9.]+) "
                  r"queries/s on (\S+), max_memory_allocated (\d+) B\)",
                  summary)
    if not m or int(m.group(1)) != len(reads):
        raise RuntimeError(f"[place] unexpected CLI summary: {summary!r}")
    log(f"[place] CLI: {summary} (process wall {cli_wall:.3f} s)")
    placements = json.load(open(jplace))["placements"]

    # the first reads against the host f64 scorer
    n = READS["check"]
    db = load_db(db_path)
    t0 = time.monotonic()
    index = TorchPlacementIndex(db, device="cuda")
    ids, totals, _ = index.place_batch(reads[:n])
    dev_s = time.monotonic() - t0
    worst, checked, gaps = 0.0, 0, 0
    for q in range(n):
        ids_h, tot_h, _ = index.host.score_query(reads[q])
        if not np.array_equal(ids_h, ids):
            raise RuntimeError("[place] branch columns differ")
        excess = np.abs(totals[q] - tot_h) - (5e-3 + 1e-4 * np.abs(tot_h))
        worst = max(worst, float(np.abs(totals[q] - tot_h).max()))
        if (excess > 0).any():
            raise RuntimeError(f"[place] read {q}: device totals beyond "
                               f"rtol 1e-4 / atol 5e-3 of the host scorer "
                               f"(max |d| {worst})")
        top2 = np.sort(tot_h)[-2:]
        if top2[1] - top2[0] > 5e-3:
            gaps += 1
            pl = placements[q]
            if pl["n"] != [f"r{q}"] or pl["p"][0][0] != int(
                    ids_h[np.argmax(tot_h)]):
                raise RuntimeError(f"[place] read {q}: the CLI's top-1 "
                                   "differs from the host scorer's")
        checked += 1
    log(f"[place] first {checked} reads: device totals within rtol 1e-4 / "
        f"atol 5e-3 of the host f64 scorer (max |d| {worst:.6g}); top-1 "
        f"equal on all {gaps} reads whose host top-2 gap exceeds 5e-3; "
        f"in-process device scoring {dev_s:.3f} s")


def phase_native_ar(torch, tmp, tree_file, fasta_file):
    import numpy as np
    from ipk_tpu_torch import builder, cli
    from ipk_tpu_torch.ar import optimize as opt_mod
    from ipk_tpu_torch.pipeline import BuildParams, build_database, prepare
    base = dict(refalign=fasta_file, reftree=tree_file, ar_binary="native",
                kmer_size=SCALE["k"], omega=SCALE["omega"], verbosity=0)
    inputs, walls, dbs = {}, {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.monotonic()
        inputs[dev] = prepare(BuildParams(
            working_dir=os.path.join(tmp, f"wd_native_{dev}"), device=dev,
            **base))
        walls[dev] = time.monotonic() - t0
    rows_c, P_c = inputs["cuda"].label_rows, inputs["cuda"].P
    rows_p, P_p = inputs["cpu"].label_rows, inputs["cpu"].P
    if set(rows_c) != set(rows_p):
        raise RuntimeError("[native AR] card and CPU posteriors cover "
                           "different nodes")
    order = [rows_p[label] for label in rows_c]
    diff = float(np.abs(np.power(10.0, P_c.astype(np.float64))
                        - np.power(10.0, P_p[order].astype(np.float64))).max())
    if not diff <= 1e-5:
        raise RuntimeError(f"[native AR] card and CPU posteriors differ by "
                           f"{diff} > 1e-5")
    log(f"[native AR] {SCALE['num_leaves']} taxa x {SCALE['width']} sites: "
        f"posteriors of {len(rows_c)} nodes, card vs CPU max |dp| {diff:.3g} "
        f"(atol 1e-5); prepare wall (alignment, tree, AR, artifacts, read) "
        f"card {walls['cuda']:.3f} s, CPU {walls['cpu']:.3f} s")
    for dev, inp in inputs.items():
        dbs[dev] = os.path.join(tmp, f"native_{dev}.ipk")
        builder.build(inp.original_tree, inp.extended_tree, inp.ghost_mapping,
                      inp.ar_mapping, inp.label_rows, inp.P,
                      traits=inp.traits, kmer_size=SCALE["k"],
                      omega=SCALE["omega"], output_filename=dbs[dev],
                      device="cuda", verbose=0)
    if cli.main(["diff-text", dbs["cuda"], dbs["cpu"], "--eps", "1e-3"]) != 0:
        raise RuntimeError("[native AR] the databases built from the card's "
                           "and the CPU's posteriors differ under diff-text")
    log(f"[native AR] DNA k={SCALE['k']} databases built on the card from "
        f"both posteriors: equal under diff-text --eps 1e-3 "
        f"({load_db(dbs['cuda']).size()} k-mers)")

    fits = []
    fit = opt_mod.optimize_parameters

    def timed_fit(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        result = fit(*args, **kwargs)
        torch.cuda.synchronize()
        fits.append((time.monotonic() - t0, result))
        return result

    opt_mod.optimize_parameters = timed_fit
    try:
        t0 = time.monotonic()
        result = build_database(BuildParams(
            working_dir=os.path.join(tmp, "wd_native_opt"), device="cuda",
            ar_optimize=True, ar_opt_steps=AR_OPT_STEPS,
            output_filename=os.path.join(tmp, "native_opt.ipk"), **base))
        wall = time.monotonic() - t0
    finally:
        opt_mod.optimize_parameters = fit
    if len(fits) != 1:
        raise RuntimeError("[native AR] --ar-optimize did not run the fit")
    secs, opt = fits[0]
    if not (opt.loglik_final > opt.loglik_initial and opt.steps
            == AR_OPT_STEPS and result.db.size() > 0):
        raise RuntimeError(f"[native AR] --ar-optimize: log likelihood "
                           f"{opt.loglik_initial} -> {opt.loglik_final} did "
                           "not rise, or the build is empty")
    log(f"[native AR] --ar native --ar-optimize on the card: {opt.steps} "
        f"Adam steps (f64) in {secs:.3f} s ({opt.steps / secs:.3f} steps/s); "
        f"logL {opt.loglik_initial:.4f} -> {opt.loglik_final:.4f}; alpha "
        f"{opt.alpha:.4f}; whole build {wall:.3f} s "
        f"({result.db.size()} k-mers)")


def phase_profile(torch, tmp, tree_file, fasta_file, ar_dir):
    """Phase 12: the phase-5 build under --profile: a Chrome trace beside a
    database payload-equal to phase 5's."""
    from ipk_tpu_torch.pipeline import BuildParams, build_database
    out = os.path.join(tmp, "scale_profiled.ipk")
    trace_dir = os.path.join(tmp, "profile")
    t0 = time.monotonic()
    build_database(BuildParams(
        refalign=fasta_file, reftree=tree_file, kmer_size=SCALE["k"],
        omega=SCALE["omega"], ar_dir=ar_dir, profile_dir=trace_dir,
        working_dir=os.path.join(tmp, "wd_profile"), output_filename=out,
        verbosity=0, device="cuda"))
    wall = time.monotonic() - t0
    if payload(out) != payload(os.path.join(tmp, "scale_1.ipk")):
        raise RuntimeError("[profile] the profiled build differs from phase "
                           "5's")
    trace = os.path.join(trace_dir, "trace.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    on_card = [e for e in events if e.get("cat") == "kernel"]
    if not ops:
        raise RuntimeError("[profile] the trace holds no operator")
    log(f"[profile] {SCALE['num_leaves']} taxa x {SCALE['width']} sites, DNA "
        f"k={SCALE['k']} with --profile: payload-equal to phase 5's build; "
        f"trace {os.path.getsize(trace)} B, {len(events)} events ("
        f"{len(ops)} operators, {len(on_card)} kernels on the card, "
        f"{sum(e.get('dur', 0) for e in on_card):.1f} us of them; "
        f"combine_max among them: "
        f"{any('combine_max' in e['name'] for e in on_card)}); build wall "
        f"{wall:.3f} s")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def one_rank_key_merge(mesh, s1_traits):
    """device_key_merge on the first 32-ghost chunk of the phase-7 build,
    enumerated through the mesh, against the host merge (merge_window_lists
    per group, then the lexsort by (key, group)), byte for byte."""
    import numpy as np
    from ipk_tpu_torch import device as device_mod
    from ipk_tpu_torch.core import sparse
    from ipk_tpu_torch.parallel import key_merge
    s1, traits = s1_traits
    k, cap = SPARSE_SCALE["k"], SPARSE_SCALE["cap"]
    sigma, bits = traits.alphabet_size, traits.bits_per_symbol
    gpg = s1.ghosts_per_group
    g1 = max(1, 32 // gpg) * gpg
    P, pre = s1.P_all[:g1], s1.prefix_all[:g1]
    caps = sparse.probe_caps(s1.P_all, s1.prefix_all, s1.eps, k=k,
                             sigma=sigma, cap=cap)
    t0 = time.monotonic()
    while True:
        pend = sparse.enumerate_pairs_deferred(
            P, pre, s1.eps, k=k, sigma=sigma, bits=bits, caps=caps,
            mesh=mesh)
        done, result, caps = sparse.resolve_overflow(
            pend, k=k, sigma=sigma, cap=cap, caps=caps, mesh=mesh,
            gather=False)
        if done:
            break
    cl, cr, scores, overflow = result
    if overflow.any():
        raise RuntimeError("[multi-rank A] the chunk overflowed its caps")
    device_mod.synchronize(mesh.device)
    t_enum = time.monotonic() - t0
    t0 = time.monotonic()
    keys, group, merged = key_merge.device_key_merge(
        mesh, cl, cr, scores, ghosts_per_group=gpg,
        nl=1 << (bits * (k // 2)), bits=bits, k=k)
    t_merge = time.monotonic() - t0
    t0 = time.monotonic()
    codes = sparse._pack_host(cl.cpu().numpy(), cr.cpu().numpy(), k=k,
                              bits=bits)
    s_h = scores.cpu().numpy()
    parts = [sparse.merge_window_lists(codes[i:i + gpg], s_h[i:i + gpg])
             for i in range(0, g1, gpg)]
    h_keys = np.concatenate([c for c, _ in parts])
    h_group = np.concatenate([np.full(len(c), g, np.int64)
                              for g, (c, _) in enumerate(parts)])
    h_scores = np.concatenate([s for _, s in parts])
    order = np.lexsort((h_group, h_keys))
    t_host = time.monotonic() - t0
    same = [np.array_equal(keys, h_keys[order]),
            np.array_equal(group, h_group[order]),
            merged.tobytes() == h_scores[order].tobytes()]
    if not all(same) or not len(keys):
        raise RuntimeError(f"[multi-rank A] device_key_merge differs from the "
                           f"host merge (keys, groups, score bits equal: "
                           f"{same}; {len(keys)} entries)")
    log(f"[multi-rank A] device_key_merge on the first {g1}-ghost chunk of "
        f"the DNA k={k} scale build ({int(np.isfinite(s_h).sum())} tuples in "
        f"[{g1}, {s_h.shape[1]}, {s_h.shape[2]}] lists): {len(keys)} "
        f"entries, byte-equal to merge_window_lists + the host lexsort "
        f"(keys, groups, score bits); enumeration through the mesh "
        f"{t_enum:.3f} s, device merge {t_merge:.3f} s, host merge "
        f"{t_host:.3f} s")


def one_rank_device_mi(torch, mesh, kres):
    """sharded_batched_build_step at the phase-5 scale: each key batch's A
    and counts bit-equal to the plain combine's, its f32 filter values
    within rtol 2e-5 / atol 1e-7 of the host f64 mif0 on that A."""
    import numpy as np
    from ipk_tpu_torch import device as device_mod
    from ipk_tpu_torch.builder import choose_key_batches
    from ipk_tpu_torch.core import dense
    from ipk_tpu_torch.core.filter import mif0_filter_values, score_threshold
    from ipk_tpu_torch.parallel.build_sharded import (
        pad_ghosts, sharded_batched_build_step)
    s1, N = kres["s1"], kres["total_num_groups"]
    k, sigma, gpg = SCALE["k"], 4, s1.ghosts_per_group
    nl, nr = sigma ** (k // 2), sigma ** (k - k // 2)
    key_batches = choose_key_batches(len(s1.group_ids), nl, nr)
    threshold = score_threshold(SCALE["omega"], sigma, k)
    P, pre, _ = pad_ghosts(s1.P_all, s1.prefix_all,
                           mesh.size("branch") * gpg)
    halves_fn, batch_fn, step_l = sharded_batched_build_step(
        mesh, k=k, sigma=sigma, ghosts_per_group=gpg, total_num_groups=N,
        threshold=threshold, key_batches=key_batches)
    L, R, eps = halves_fn(P, pre, s1.eps)
    walls, keys, worst_abs, worst_rel = [], 0, 0.0, 0.0
    for b in range(key_batches):
        lo = b * step_l
        device_mod.synchronize(mesh.device)
        t0 = time.monotonic()
        A, fv, counts = batch_fn(L, R, eps, lo)
        device_mod.synchronize(mesh.device)
        walls.append(time.monotonic() - t0)
        A_g, counts_ref = dense.combine_max_ref(
            L[:, :, lo:lo + step_l].contiguous(), R, eps)
        A_ref = dense.group_max(A_g.reshape(A_g.shape[0], -1), gpg)
        del A_g
        if not (torch.equal(A.view(torch.int32), A_ref.view(torch.int32))
                and torch.equal(counts, counts_ref)):
            raise RuntimeError(f"[multi-rank A] device-MI step, key batch "
                               f"{b + 1}: A or counts differ from the plain "
                               f"combine's")
        A_np = A.cpu().numpy()
        mask = np.isfinite(A_np)
        present = mask.any(axis=0)
        host = mif0_filter_values(A_np, mask, N, threshold)[present]
        d = np.abs(fv.cpu().numpy().astype(np.float64)[present] - host)
        worst_abs = max(worst_abs, float(d.max()))
        worst_rel = max(worst_rel, float((d / np.abs(host)).max()))
        beyond = int((d > 1e-7 + 2e-5 * np.abs(host)).sum())
        keys += int(present.sum())
        if beyond:
            raise RuntimeError(
                f"[multi-rank A] device-MI step, key batch {b + 1}: {beyond} "
                f"of {int(present.sum())} filter values beyond rtol 2e-5 / "
                f"atol 1e-7 of the host f64 mif0 (max |d| {d.max():.3g})")
    log(f"[multi-rank A] sharded_batched_build_step on the DNA k={k} scale "
        f"project ({key_batches} key batches): A and counts bit-equal to the "
        f"plain combine; f32 filter values of {keys} keys within rtol 2e-5 / "
        f"atol 1e-7 of the host f64 mif0 (max |d| {worst_abs:.3g}, max "
        f"relative {worst_rel:.3g}); step wall per batch "
        f"{[round(w, 4) for w in walls]} s")


def one_rank_padding(torch, mesh, kres, sres):
    """pad_ghosts' rows (PAD_LOG_SCORE) through both kernels beside three
    real ghosts: no survivor, no count, no NaN."""
    from ipk_tpu_torch.builder import stage1_state
    from ipk_tpu_torch.core import dense, kernels, sparse
    from ipk_tpu_torch.parallel.build_sharded import pad_ghosts
    s1 = kres["s1"]
    P, pre, G = pad_ghosts(s1.P_all[:3], s1.prefix_all[:3], 4)
    Pt, pt, eps = stage1_state(P, pre, s1.eps, mesh.device)
    L, R = dense.masked_halves(Pt, pt, eps, k=SCALE["k"], sigma=4)
    A, counts = kernels.combine_max(L.contiguous(), R.contiguous(), eps)
    if (bool(torch.isnan(A).any()) or bool(torch.isfinite(A[G:]).any())
            or int(counts[G:].sum()) or not bool(torch.isfinite(A[:G]).any())):
        raise RuntimeError("[multi-rank A] a padded ghost left a survivor, a "
                           "count or a NaN in combine_max (or the real ghosts "
                           "none)")
    s1s, traits = sres["s1_traits"]
    k, cap = SPARSE_SCALE["k"], SPARSE_SCALE["cap"]
    P, pre, G = pad_ghosts(s1s.P_all[:3], s1s.prefix_all[:3], 4)
    caps = sparse.probe_caps(s1s.P_all, s1s.prefix_all, s1s.eps, k=k,
                             sigma=traits.alphabet_size, cap=cap)
    _, (_, _, scores, _, ovf_ghosts) = sparse.enumerate_pairs_deferred(
        P, pre, s1s.eps, k=k, sigma=traits.alphabet_size,
        bits=traits.bits_per_symbol, caps=caps, device=mesh.device)
    if (bool(torch.isnan(scores).any()) or bool(torch.isfinite(
            scores[G:]).any()) or bool(ovf_ghosts[G:].any())
            or not bool(torch.isfinite(scores[:G]).any())):
        raise RuntimeError("[multi-rank A] a padded ghost left a survivor, an "
                           "overflow or a NaN in the staircase enumeration "
                           "(or the real ghosts none)")
    log(f"[multi-rank A] pad_ghosts: 3 ghosts padded to 4 with "
        f"PAD_LOG_SCORE, through combine_max (DNA k={SCALE['k']}) and the "
        f"staircase enumeration (DNA k={k}): the padded ghost leaves no "
        f"survivor, count or overflow, and no NaN anywhere")


def phase_one_rank(torch, kres, sres, device="cuda", backend="nccl"):
    """Phase 13 (A): the parallel layer at world size 1 over NCCL, in
    process, called directly (the builder shards only above one rank)."""
    import torch.distributed as dist
    from ipk_tpu_torch.parallel.mesh import make_mesh
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend,
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(device=device)
        one_rank_key_merge(mesh, sres["s1_traits"])
        one_rank_device_mi(torch, mesh, kres)
        one_rank_padding(torch, mesh, kres, sres)
    finally:
        dist.destroy_process_group()


def rank_jobs(tmp, tree_file, fasta_file, ar_dir, device):
    """Phase 14's builds, each run by every rank: (name, job, the one-rank
    file of an earlier phase it is held to)."""
    mid = os.path.join(tmp, "mid")
    scale = dict(refalign=fasta_file, reftree=tree_file, ar_dir=ar_dir,
                 kmer_size=SCALE["k"], omega=SCALE["omega"])
    mid_p = dict(refalign=os.path.join(mid, "reference.fasta"),
                 reftree=os.path.join(mid, "tree.newick"),
                 ar_dir=os.path.join(mid, "ar_out"), kmer_size=MID["k"],
                 omega=MID["omega"])
    cli_args = ["-r", mid_p["refalign"], "-t", mid_p["reftree"], "-k",
                str(MID["k"]), "--omega", str(MID["omega"]), "--ar-dir",
                mid_p["ar_dir"], "-m", "GTR", "-v", "0", "--device", device]
    return [
        ("dense", dict(params=scale), os.path.join(tmp, "scale_1.ipk")),
        ("device merge", dict(params=mid_p, sparse=True),
         os.path.join(mid, "sparse.ipk")),
        ("positions", dict(params={**scale, "keep_positions": True}),
         os.path.join(tmp, "scale_pos.ipk")),
        ("device-mi", dict(params={**scale, "device_mi": True}),
         os.path.join(tmp, "scale_1.ipk")),
        ("CLI", dict(argv=cli_args), os.path.join(mid, "dense.ipk"))]


def rank_main(spec_path: str, rank: int) -> int:
    """One rank of phase 14: join the gloo world, run every job with the
    launch counts reset before it, write the results to rank<r>.json."""
    import torch
    from ipk_tpu_torch import cli
    from ipk_tpu_torch import device as device_mod
    from ipk_tpu_torch.parallel.mesh import initialize_distributed
    from ipk_tpu_torch.pipeline import BuildParams, build_database
    with open(spec_path) as f:
        spec = json.load(f)
    n, d = spec["ranks"], spec["dir"]
    initialize_distributed(spec["coordinator"], n, rank, backend="gloo",
                           device=spec["device"])
    results = {}
    try:
        for name, job in spec["jobs"]:
            stem = os.path.join(d, f"{name.replace(' ', '_')}.rank{rank}")
            out, wd = stem + ".ipk", stem + ".wd"
            reset_counts()
            t0 = time.monotonic()
            if "argv" in job:
                # the CLI finds the world joined and keeps it
                rc = cli.main(["build", *job["argv"], "-o", out, "-w", wd,
                               "--coordinator", spec["coordinator"],
                               "--num-hosts", str(n), "--host-id",
                               str(rank)])
                if rc:
                    raise RuntimeError(f"[rank {rank}] the CLI build "
                                       f"returned {rc}")
                info = {}
            else:
                params = BuildParams(**job["params"], working_dir=wd,
                                     output_filename=out, verbosity=0,
                                     device=spec["device"])
                result = (build_sparse(params, out) if job.get("sparse")
                          else build_database(params))
                info = dict(merge=result.stats.get("merge"),
                            explored=result.num_explored)
            device_mod.synchronize(device_mod.resolve(spec["device"]))
            info.update(wall=time.monotonic() - t0, launches=read_counts(),
                        out=out)
            results[name] = info
            log(f"[rank {rank}] {name}: {info['wall']:.3f} s, kernel "
                f"launches {json.dumps(info['launches'])}")
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    return 0


def close_rows(path, ref_path, label):
    """Raise unless the device-MI database holds the host-filter database's
    rows (keys, branches, scores) with filter values within rtol 2e-5 /
    atol 1e-7; return the largest difference."""
    import numpy as np
    got, ref = by_key(load_db(path)), by_key(load_db(ref_path))
    same = [a.tobytes() == b.tobytes()
            for i, (a, b) in enumerate(zip(got, ref)) if i != 1]
    d = np.abs(got[1].astype(np.float64) - ref[1].astype(np.float64))
    beyond = int((d > 1e-7 + 2e-5 * np.abs(ref[1])).sum())
    if not all(same) or beyond or not len(got[0]):
        raise RuntimeError(f"[multi-rank B] {label}: rows differ from the "
                           f"host-filter build (keys, counts, branches, "
                           f"scores equal: {same}) or {beyond} filter values "
                           f"beyond rtol 2e-5 / atol 1e-7")
    return float(d.max())


def phase_two_ranks(tmp, tree_file, fasta_file, ar_dir, kernel_tuples,
                    device="cuda"):
    """Phase 14 (B): two ranks over gloo on the one card, each a process of
    this script, run every build of rank_jobs; every rank's file is held to
    the one-rank build of an earlier phase."""
    d = os.path.join(tmp, "ranks")
    os.makedirs(d)
    jobs = rank_jobs(tmp, tree_file, fasta_file, ar_dir, device)
    spec_path = os.path.join(d, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(dict(dir=d, ranks=2, device=device,
                       coordinator=f"127.0.0.1:{free_port()}",
                       jobs=[(name, job) for name, job, _ in jobs]), f)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])}
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    logs = [os.path.join(d, f"rank{r}.log") for r in range(2)]
    t0 = time.monotonic()
    procs = []
    try:
        for r in range(2):
            with open(logs[r], "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--rank",
                     spec_path, str(r)], cwd=d, env=env, stdout=out,
                    stderr=subprocess.STDOUT))
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.monotonic() - t0
    for r in range(2):
        for line in open(logs[r]).read().splitlines()[-40:]:
            log(f"  rank {r}| {line}")
    if any(rcs):
        raise RuntimeError(f"[multi-rank B] a rank failed: exit codes {rcs}")
    results = []
    for r in range(2):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            results.append(json.load(f))
    for name, _, ref in jobs:
        for r, res in enumerate(results):
            info = res[name]
            if name == "device-mi":
                info["max_abs_fv_diff"] = close_rows(info["out"], ref, name)
            elif name == "CLI":
                if open(info["out"], "rb").read() != open(ref, "rb").read():
                    raise RuntimeError(f"[multi-rank B] CLI: rank {r}'s file "
                                       f"is not byte-equal to the one-rank "
                                       f"build")
            elif payload(info["out"]) != payload(ref):
                raise RuntimeError(f"[multi-rank B] {name}: rank {r}'s "
                                   f"database differs from the one-rank "
                                   f"build's")
        if name == "device merge" and any(
                res[name]["merge"] != "device" for res in results):
            raise RuntimeError(f"[multi-rank B] device merge: the merge took "
                               f"{[res[name]['merge'] for res in results]}")
        if name == "dense" and any(res[name]["explored"] != kernel_tuples
                                   for res in results):
            raise RuntimeError("[multi-rank B] dense: the explored count is "
                               "not the one-rank build's")
    summary = {name: dict(
        wall_s=[round(res[name]["wall"], 3) for res in results],
        launches=[res[name]["launches"] for res in results],
        **({"merge": results[0][name]["merge"]} if name == "device merge"
           else {}),
        **({"max_abs_fv_diff": max(res[name]["max_abs_fv_diff"]
                                   for res in results)}
           if name == "device-mi" else {}))
        for name, _, _ in jobs}
    log(f"[multi-rank B] 2 ranks over gloo on one card: every rank's file "
        f"equal to its one-rank build (dense, device merge, positions and "
        f"CLI by payload or bytes; device-mi by rows, fv within rtol 2e-5 / "
        f"atol 1e-7); ranks' wall {wall:.1f} s")
    return summary


def reset_counts():
    from ipk_tpu_torch.core import kernels
    for name in KERNELS:
        getattr(kernels, name).launches = 0


def read_counts():
    from ipk_tpu_torch.core import kernels
    return {name: getattr(kernels, name).launches for name in KERNELS}


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "ipk_tpu_torch")):
        print("chip_smoke.py: the ipk_tpu_torch package is not beside this "
              "script; run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if sys.argv[1:2] == ["--rank"]:
        return rank_main(sys.argv[2], int(sys.argv[3]))
    import torch
    smi = phase_device(torch)
    phase_build()
    tmp = tempfile.mkdtemp(prefix="ipk_tpu_torch_smoke_")
    try:
        t0 = time.monotonic()
        scale_dir = os.path.join(tmp, "scale")
        os.makedirs(scale_dir)
        tree_file, fasta_file, ar_dir = make_project(
            pathlib.Path(scale_dir), num_leaves=SCALE["num_leaves"],
            width=SCALE["width"], seed=SCALE["seed"])
        log(f"[setup] scale project written in {time.monotonic() - t0:.1f} s")
        kres = phase_kernel(torch, tmp, tree_file, fasta_file, ar_dir, smi)
        sres = phase_kernel_staircase(torch, tree_file, fasta_file, ar_dir,
                                      tmp, smi)
        walls = {}
        counts = {}

        def path(name, *phases):
            """Drive one path with the launch counts reset just before it
            and read just after it."""
            t_path = time.monotonic()
            reset_counts()
            for fn, args in phases:
                fn(*args)
            counts[name] = read_counts()
            walls[name] = time.monotonic() - t_path
            log(f"[path] {name}: {walls[name]:.1f} s, kernel launches "
                f"{json.dumps(counts[name])}")

        path("dense", (phase_goldens, (torch, tmp)),
             (phase_scale, (torch, tmp, tree_file, fasta_file, ar_dir,
                            kres["tuples"])))
        path("sparse", (phase_sparse_goldens, (torch, tmp)),
             (phase_sparse_scale, (torch, tmp, tree_file, fasta_file,
                                   ar_dir)))
        t_pk = time.monotonic()
        pres = phase_positions_kernel(torch, tmp, tree_file, fasta_file,
                                      ar_dir, smi)
        walls["positions kernel check"] = time.monotonic() - t_pk
        path("positions", (phase_positions, (torch, tmp, tree_file,
                                             fasta_file, ar_dir)))
        path("on-disk", (phase_on_disk, (torch, tmp, tree_file, fasta_file,
                                         ar_dir)))
        path("place", (phase_placement, (torch, tmp, fasta_file)))
        path("native AR", (phase_native_ar, (torch, tmp, tree_file,
                                             fasta_file)))
        path("profile", (phase_profile, (torch, tmp, tree_file, fasta_file,
                                         ar_dir)))
        path("multi-rank A", (phase_one_rank, (torch, kres, sres)))
        del kres["s1"], sres["s1_traits"]
        torch.cuda.empty_cache()
        t_b = time.monotonic()
        ranks = phase_two_ranks(tmp, tree_file, fasta_file, ar_dir,
                                kres["tuples"])
        walls["multi-rank B"] = time.monotonic() - t_b
        log(f"[multi-rank] A (NCCL, 1 rank, in process): wall "
            f"{walls['multi-rank A']:.3f} s, launches "
            f"{json.dumps(counts['multi-rank A'])}; B (gloo, 2 ranks sharing "
            f"one card: a correctness check, not a scaling measurement): "
            f"wall "
            f"{walls['multi-rank B']:.3f} s, per build and rank "
            f"{json.dumps(ranks)}; {smi}")
        required = [("dense", "combine_max"), ("dense", "extract_columns"),
                    ("sparse", "staircase_select"),
                    ("positions", "combine_max_with_positions"),
                    ("on-disk", "combine_max"),
                    ("on-disk", "staircase_select"),
                    ("on-disk", "extract_columns"),
                    ("native AR", "combine_max"), ("profile", "combine_max"),
                    ("profile", "extract_columns"),
                    ("multi-rank A", "combine_max"),
                    ("multi-rank A", "staircase_select")]
        missing = [f"{k} on the {p} path" for p, k in required
                   if counts[p][k] <= 0]
        if missing:
            raise RuntimeError(f"kernels not launched on their paths: "
                               f"{missing}; counts {counts}")
        log(f"[done] smoke wall {time.monotonic() - t0:.1f} s; per path "
            f"{json.dumps({k: round(v, 1) for k, v in walls.items()})}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"kernels": [{
        "name": "combine_max", "route": "cuda",
        "source": "ipk_tpu_torch/core/csrc/combine_max.cu",
        "replaces": "ipk_tpu/core/pallas_kernels.py:163",
        "launches": sum(counts[p]["combine_max"]
                        for p in ("dense", "on-disk", "native AR", "profile",
                                  "multi-rank A")),
        "max_abs_err": kres["max_abs_err"],
        "ms": kres["ms"], "plain_ms": kres["plain_ms"],
        "bound_ms": kres["bound_ms"], "bound_by": kres["bound_by"],
        "library_ms": None}, {
        "name": "combine_max_with_positions", "route": "cuda",
        "source": "ipk_tpu_torch/core/csrc/combine_max.cu",
        "replaces": "ipk_tpu/core/dense.py:310",
        "launches": counts["positions"]["combine_max_with_positions"],
        "max_abs_err": pres["max_abs_err"],
        "ms": pres["ms"], "plain_ms": pres["plain_ms"],
        "bound_ms": pres["bound_ms"], "bound_by": pres["bound_by"],
        "library_ms": None}, {
        "name": "staircase_select", "route": "cuda",
        "source": "ipk_tpu_torch/core/csrc/staircase_select.cu",
        "replaces": "ipk_tpu/core/pallas_kernels.py:404",
        "launches": sum(counts[p]["staircase_select"]
                        for p in ("sparse", "on-disk", "multi-rank A")),
        "max_abs_err": sres["max_abs_err"],
        "ms": sres["ms"], "plain_ms": sres["plain_ms"],
        "bound_ms": sres["bound_ms"], "bound_by": sres["bound_by"],
        "library_ms": None}, {
        "name": "extract_columns", "route": "cuda",
        "source": "ipk_tpu_torch/core/csrc/extract_columns.cu",
        "replaces": None,
        "launches": sum(counts[p]["extract_columns"]
                        for p in ("dense", "on-disk", "native AR", "profile",
                                  "multi-rank A")),
        "max_abs_err": kres["extract"]["max_abs_err"],
        "max_rel_fv": kres["extract"]["max_rel_fv"],
        "ms": kres["extract"]["ms"],
        "column_ms": kres["extract"]["column_ms"],
        "plain_ms": kres["extract"]["plain_ms"],
        "bound_ms": kres["extract"]["bound_ms"], "bound_by": "bytes",
        "library_ms": None}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
