#!/usr/bin/env python3
"""A/B timing of one CUDA kernel of the port against other versions of it,
on one card.

    python3 kernel_ab.py [--kernel combine_max|staircase_select]
                         [--reps N] [--rounds N] OTHER [OTHER ...]

Each OTHER is a ``.cu`` file or a checkout holding
``ipk_tpu_torch/core/csrc/<kernel>.cu`` (for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
Each is compiled with nvcc into its own library under
``build/ipk_tpu_torch/ab/``, with the flags of ``core._build``, and called
through the C entries every version exports. Versions are timed in turns
(this, others, others reversed, this) for ``--rounds`` rounds, each timing
the CUDA-event mean of ``--reps`` launches after a warm-up, after checking
every version bit-equal to this checkout's kernel. Prints one line per
timing, the card's name and power limit, and a JSON summary as the last
line. Needs one CUDA card, nvcc and nvidia-smi.

``--kernel combine_max`` (the default): this checkout's kernel goes through
``core.kernels`` as the build calls it; its ``ipk_combine_max_uncounted``
(the same kernel without the explored count) is timed beside it. The inputs
are the main-path launches of ``chip_smoke.py``'s DNA k=8 scale project (256
taxa x 1500 sites, seed 9): the first key batch of the plain build, L [1020,
1493, 64] x R [1020, 1493, 256], and the one launch of the
``--keep-positions`` build, L = R [1020, 1493, 256]. Every version must give
A (bits), pos and counts equal to this checkout's kernel. Also prints the
instruction mix of each combine_max kernel's hot loop (``cuobjdump
-sass``), and what the kernel's work depends on in these halves: the share
of live (> -inf) values, and the rescans the positions mode queues (plain
torch, :func:`replacements`).

``--kernel staircase_select``: the inputs are the launches of the first
32-ghost chunk of the same project's DNA k=12, omega 2.0 sparse build
(``chip_smoke.staircase_chunk``), then ``chip_smoke.py``'s 4096- and
8192-wide shapes and a launch of 1024 windows of dense 1024-wide lists
(:data:`DENSE`), each timed on its own. Every version must
give cl, cr, score bits and totals equal to this checkout's kernel. For each
launch it prints the live (> -inf) entries per window of each list and the
survivors per window (what the redesigned kernel's work follows), and, for
this checkout, the time split into staging + sort, count + scan and
emission, through the library's measuring entry
``ipk_staircase_select_stages`` (each run stops after a stage; the build
never calls it).
"""

import argparse
import ctypes
import json
import os
import pathlib
import subprocess
import sys
import tempfile

from chip_smoke import time_ms

REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, flush=True)


def build_other(src, tag):
    """Compile one kernel source into its own library and load it."""
    from ipk_tpu_torch.core import _build
    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(src))[0]
    lib = os.path.join(out_dir, f"lib{name}_{tag}.so")
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o", lib, src]
    run = subprocess.run(cmd, capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{run.stdout}{run.stderr}")
    for line in (run.stdout + run.stderr).splitlines():
        if "registers" in line or "spill" in line:
            log(f"[{tag}] ptxas: {line.strip()}")
    return ctypes.CDLL(lib)


def hot_loops(lib_path):
    """Per combine_max kernel in the library, the instruction mix of its
    hot loop (cuobjdump -sass): of the loops between a backward branch and
    its target, the one densest in FMNMX."""
    import re
    from collections import Counter
    from ipk_tpu_torch.core import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    out = []
    for func in sass.split("Function : ")[1:]:
        name = func.split("\n", 1)[0].strip()
        if "combine_max_kernel" not in name:
            continue
        ins = [(int(a, 16), op) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
            func)]
        best = None
        for addr, op in ins:
            if not op.startswith("BRA"):
                continue
            m = re.search(rf"/\*{addr:04x}\*/[^\n]*BRA[^\n]*?(0x[0-9a-f]+)",
                          func)
            target = int(m.group(1), 16) if m else addr
            if target < addr:
                body = Counter(o.split(".")[0] for a, o in ins
                               if target <= a <= addr)
                density = body["FMNMX"] / sum(body.values())
                # a max loop has at least 16 FMNMX (4 x 4 cells), the
                # count's sort network a few
                if body["FMNMX"] >= 16 and (best is None
                                            or density > best[0]):
                    best = (density, body)
        kind = re.search(r"ILb(\d)ELb(\d)E", name).groups()
        label = {("0", "1"): "plain", ("1", "1"): "positions",
                 ("0", "0"): "uncounted"}[kind]
        if best:
            body = best[1]
            out.append(f"{label}: {sum(body.values())} instructions, FADD "
                       f"{body['FADD']}, FMNMX {body['FMNMX']}, LDS "
                       f"{body['LDS']}")
    return "; ".join(out)


def main_path_halves(torch, tmp):
    import chip_smoke
    from ipk_tpu_torch.builder import (choose_key_batches, stage1_inputs,
                                       stage1_state)
    from ipk_tpu_torch.core.dense import masked_halves
    from ipk_tpu_torch.pipeline import BuildParams, prepare
    scale = chip_smoke.SCALE
    tree_file, fasta_file, ar_dir = chip_smoke.make_project(
        pathlib.Path(tmp), num_leaves=scale["num_leaves"],
        width=scale["width"], seed=scale["seed"])
    inp = prepare(BuildParams(
        refalign=fasta_file, reftree=tree_file, ar_dir=ar_dir,
        working_dir=os.path.join(tmp, "wd"), kmer_size=scale["k"],
        omega=scale["omega"], verbosity=0, device="cuda"))
    s1 = stage1_inputs(inp.original_tree, inp.extended_tree,
                       inp.ghost_mapping, inp.ar_mapping, inp.label_rows,
                       inp.P, sigma=inp.traits.alphabet_size,
                       kmer_size=scale["k"], omega=scale["omega"])
    Pt, pre, eps = stage1_state(s1.P_all, s1.prefix_all, s1.eps,
                                torch.device("cuda"))
    L, R = masked_halves(Pt, pre, eps, k=scale["k"],
                         sigma=inp.traits.alphabet_size)
    batches = choose_key_batches(len(s1.group_ids), L.shape[2], R.shape[2])
    Lb = L[:, :, :L.shape[2] // batches].contiguous()
    return Lb, L, R, eps


def replacements(torch, L, R, eps, block=32, ghosts=16):
    """What the positions mode's per-block replace does on these halves, in
    plain torch: over 32-window blocks, how many (cell, block) pairs have a
    block maximum above the cell's running maximum (which starts at eps),
    each a queued rescan, per live cell."""
    G, W, n = L.shape
    rescans = live = 0
    for g0 in range(0, G, ghosts):
        acc = torch.full((min(ghosts, G - g0), n, R.shape[2]), float(eps),
                         device=L.device)
        for w0 in range(0, W, block):
            bmax = (L[g0:g0 + ghosts, w0:w0 + block, :, None]
                    + R[g0:g0 + ghosts, w0:w0 + block, None, :]).amax(1)
            need = bmax > acc
            rescans += int(need.sum())
            acc = torch.where(need, bmax, acc)
        live += int((acc > eps).sum())
    return (f"positions mode: {live} live cells, {rescans} rescans "
            f"({rescans / max(live, 1):.3f} a live cell)")


def sources(others, kernel):
    return [o if o.endswith(".cu") else os.path.join(
        o, "ipk_tpu_torch", "core", "csrc", f"{kernel}.cu") for o in others]


def in_turns(torch, fns, args, label, results):
    """Time each of ``fns`` in turns (all, then all reversed) for
    ``args.rounds`` rounds; append each mean to ``results[label/tag]``."""
    order = list(fns) + list(reversed(list(fns)))
    for rnd in range(args.rounds):
        for tag in order:
            ms = time_ms(torch, fns[tag], args.reps)
            results.setdefault(f"{label}/{tag}", []).append(ms)
            log(f"[ab] round {rnd + 1} {label} {tag}: {ms:.4f} ms")


def combine_max_ab(torch, args):
    from ipk_tpu_torch.core import _build, kernels
    lib = _build.load()
    log(f"[ab] hot loops (cuobjdump -sass): {hot_loops(_build.LIB_PATH)}")
    srcs = sources(args.others, "combine_max")
    others = {f"other{n}": build_other(src, f"other{n}")
              for n, src in enumerate(srcs)}
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    for so in others.values():
        so.ipk_combine_max.argtypes = [vp, vp, ctypes.c_float, vp, vp, ll,
                                       ll, ll, ll, ctypes.c_int, vp]
        so.ipk_combine_max_positions.argtypes = [
            vp, vp, ctypes.c_float, vp, vp, vp, ll, ll, ll, ll,
            ctypes.c_int, vp]
    for tag, src in zip(others, srcs):
        log(f"[{tag}] {src}")
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        Lb, L, R, eps = main_path_halves(torch, tmp)
    dev = L.device
    eps_f = float(eps)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def plain_c(fn):
        G, W, nl = Lb.shape
        A = torch.empty((G, nl, R.shape[2]), device=dev)
        counts = torch.zeros(G, dtype=torch.int64, device=dev)

        def call():
            counts.zero_()
            rc = fn(ctypes.c_void_p(Lb.data_ptr()),
                    ctypes.c_void_p(R.data_ptr()), ctypes.c_float(eps_f),
                    ctypes.c_void_p(A.data_ptr()),
                    ctypes.c_void_p(counts.data_ptr()), G, W, nl,
                    R.shape[2], dev.index, stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            return A, counts
        return call

    def positions_c(fn):
        G, W, n = L.shape
        A = torch.empty((G, n, n), device=dev)
        pos = torch.empty((G, n, n), dtype=torch.int32, device=dev)
        counts = torch.zeros(G, dtype=torch.int64, device=dev)

        def call():
            counts.zero_()
            rc = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (L, R)),
                    ctypes.c_float(eps_f),
                    *(ctypes.c_void_p(t.data_ptr()) for t in (A, pos, counts)),
                    G, W, n, n, dev.index, stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            return A, pos, counts
        return call

    plain = {"this": lambda: kernels.combine_max(Lb, R, eps),
             "this_uncounted": plain_c(lib.ipk_combine_max_uncounted)}
    positions = {"this": lambda: kernels.combine_max_with_positions(L, R,
                                                                    eps)}
    for tag, so in others.items():
        plain[tag] = plain_c(so.ipk_combine_max)
        positions[tag] = positions_c(so.ipk_combine_max_positions)

    ref = [t.clone() for t in plain["this"]()]
    for tag, fn in plain.items():
        got = fn()
        if tag != "this_uncounted" and not (
                torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32))
                and torch.equal(got[1], ref[1])):
            raise RuntimeError(f"plain mode: {tag} differs from this kernel")
    ref = [t.clone() for t in positions["this"]()]
    for tag, fn in positions.items():
        got = fn()
        if not (torch.equal(got[0].view(torch.int32),
                            ref[0].view(torch.int32))
                and torch.equal(got[1], ref[1])
                and torch.equal(got[2], ref[2])):
            raise RuntimeError(f"positions mode: {tag} differs from this "
                               "kernel")
    del ref, got
    log(f"[ab] inputs: plain L {tuple(Lb.shape)} x R {tuple(R.shape)}, "
        f"positions L = R {tuple(L.shape)}; every version bit-equal")
    live_l = float(torch.isfinite(L).float().mean())
    live_r = float(torch.isfinite(R).float().mean())
    log(f"[ab] live (> -inf) values: L {live_l:.4f}, R {live_r:.4f}; "
        f"{replacements(torch, L, R, eps)}")

    results = {}
    for mode, fns in (("plain", plain), ("positions", positions)):
        in_turns(torch, fns, args, mode, results)
    return results


def staircase_c(torch, so, a, kw, stop=None):
    """(call, outputs): one library's ``ipk_staircase_select`` (or, with
    ``stop``, its ``ipk_staircase_select_stages``) on one launch's inputs
    ``a``, into outputs of its own, plus the global scratch in the versions
    whose entry takes one (those that export ``ipk_staircase_scratch_bytes``;
    the parent of the wide path takes none)."""
    sL, cL, sR, cR, eps = a
    G, W, CL = sL.shape
    CR, cap, dev = sR.shape[2], kw["cap"], sL.device
    outs = (torch.empty((G, W, cap), dtype=torch.int64, device=dev),
            torch.empty((G, W, cap), dtype=torch.int64, device=dev),
            torch.empty((G, W, cap), dtype=torch.float32, device=dev),
            torch.empty((G, W), dtype=torch.int32, device=dev))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    keep = list(a) + list(outs)
    if hasattr(so, "ipk_staircase_scratch_bytes"):
        so.ipk_staircase_scratch_bytes.argtypes = [ll, ll, ll, ctypes.c_int]
        so.ipk_staircase_scratch_bytes.restype = ll
        nbytes = so.ipk_staircase_scratch_bytes(G * W, CL, CR, dev.index)
        keep.append(torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                device=dev))
    ptrs = [vp(t.data_ptr()) for t in keep]
    fn = (so.ipk_staircase_select if stop is None
          else so.ipk_staircase_select_stages)
    fn.argtypes = [vp] * len(ptrs) + [ll, ll, ll, ll, ctypes.c_int,
                                      ctypes.c_int, vp] + (
        [] if stop is None else [ctypes.c_int])
    fn.restype = ctypes.c_int
    tail = [] if stop is None else [stop]
    stream = vp(torch.cuda.current_stream(dev).cuda_stream)
    sort_l = int(kw.get("sort_l", True))

    def call():
        rc = fn(*ptrs, G * W, CL, CR, cap, sort_l, dev.index, stream, *tail)
        if rc:
            raise RuntimeError(f"staircase launch failed: CUDA error {rc}")
        return outs
    return call, outs


def bits(torch, t):
    """Scores by bit pattern (so -0.0 and +0.0 differ), other tensors as
    they are."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def live_stats(torch, a, totals, cap):
    """What the redesigned kernel's work follows in one launch's inputs:
    live (> -inf) entries per window of each list, and survivors."""
    def q(x):
        x = x.flatten().float()
        p = torch.quantile(x, torch.tensor([0.5, 0.9, 0.99], device=x.device))
        return (f"p50 {p[0]:.0f} p90 {p[1]:.0f} p99 {p[2]:.0f} max "
                f"{x.max():.0f} mean {x.mean():.1f}")
    nL = (a[0] > float("-inf")).sum(-1)
    nR = (a[2] > float("-inf")).sum(-1)
    wide = torch.maximum(nL, nR).flatten()
    shares = ", ".join(f"<= {b}: {float((wide <= b).float().mean()):.4f}"
                       for b in (32, 64, 128, 256, 512))
    live = float(totals.clamp(max=cap).sum()) / (totals.numel() * cap)
    return (f"live L {q(nL)}; live R {q(nR)}; windows by the longer live "
            f"list {shares}; survivors {q(totals)}; live slots {live:.4f}")


#: beside the chunk's launches, the smoke's wide shapes that every version
#: takes (lists of 90% live entries: each window goes to the block pass),
#: and a launch of dense lists, as a large --max-candidates gives
WIDE_LABELS = ("CL = CR = 4096", "CL = CR = 8192")
DENSE = ("dense prefixes, 50-90% live", 4, 256, 1024, 1024, 4096,
         {"live": (0.5, 0.9), "prefix": True})


def staircase_ab(torch, args):
    import chip_smoke
    from ipk_tpu_torch.core import _build, kernels
    lib = _build.load()
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    usage = subprocess.run([cuobjdump, "-res-usage", _build.LIB_PATH],
                           capture_output=True, text=True, check=True).stdout
    for func in usage.split("Function ")[1:]:
        if "staircase" in func.split(":")[0]:
            log(f"[this] resources: {' '.join(func.split())}")
    srcs = sources(args.others, "staircase_select")
    others = {f"other{n}": build_other(src, f"other{n}")
              for n, src in enumerate(srcs)}
    for tag, src in zip(others, srcs):
        log(f"[{tag}] {src}")
    scale = chip_smoke.SCALE
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        files = chip_smoke.make_project(
            pathlib.Path(tmp), num_leaves=scale["num_leaves"],
            width=scale["width"], seed=scale["seed"])
        s1_traits = chip_smoke.sparse_stage1(tmp, *files)
    g1, _, recorded, _, stats = chip_smoke.staircase_chunk(s1_traits)
    del s1_traits
    k = chip_smoke.SPARSE_SCALE["k"]
    log(f"[ab] first {g1}-ghost chunk of the DNA k={k} scale build: "
        f"{len(recorded)} staircase launches, caps "
        f"{sorted(stats['final_caps'].items())}")
    launches = [(f"launch {n + 1}", a, kw) for n, (a, kw) in
                enumerate(recorded)]
    for n, (label, G, W, CL, CR, cap, opts) in enumerate(
            chip_smoke.STAIRCASE_SHAPES + [DENSE]):
        if label in WIDE_LABELS or label == DENSE[0]:
            launches.append((label, chip_smoke.staircase_inputs(
                torch, G, W, CL, CR, seed=n, **opts), dict(cap=cap)))
    results = {}
    for label, a, kw in launches:
        ref = [t.clone() for t in kernels.staircase_select(*a, **kw)]
        fns = {}
        for tag, so in [("this", lib)] + list(others.items()):
            call, outs = staircase_c(torch, so, a, kw)
            got = call()
            torch.cuda.synchronize()
            if not all(torch.equal(bits(torch, x), bits(torch, y))
                       for x, y in zip(got, ref)):
                raise RuntimeError(f"staircase {label}: {tag} differs from "
                                   "this kernel")
            fns[tag] = call
        G, W, CL = a[0].shape
        moved, bound_ms, bound_by = chip_smoke.staircase_bound(
            a, ref, int(ref[3].clamp(max=kw["cap"]).sum()))
        log(f"[ab] {label}: N={G * W} L {CL} x R {a[2].shape[2]}, cap "
            f"{kw['cap']}, sort_l {kw.get('sort_l', True)}; every version "
            f"bit-equal; bound {bound_ms:.4f} ms ({bound_by}, {moved} B)")
        log(f"[ab] {label}: {live_stats(torch, a, ref[3], kw['cap'])}")
        in_turns(torch, fns, args, label, results)
        for stop, name in ((1, "staging + sort"), (2, "+ count + scan")):
            ms = time_ms(torch, staircase_c(torch, lib, a, kw, stop)[0],
                         args.reps)
            results.setdefault(f"{label}/this to {name}", []).append(ms)
            log(f"[ab] {label} this, up to {name}: {ms:.4f} ms")
        del ref, fns
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="+")
    ap.add_argument("--kernel", default="combine_max",
                    choices=("combine_max", "staircase_select"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py needs a CUDA card")
    results = (combine_max_ab if args.kernel == "combine_max"
               else staircase_ab)(torch, args)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({k: sum(v) / len(v) for k, v in results.items()}))


if __name__ == "__main__":
    main()
