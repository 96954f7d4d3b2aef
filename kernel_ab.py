#!/usr/bin/env python3
"""A/B timing of the combine_max CUDA kernel, both modes, on one card.

    python3 kernel_ab.py [--reps N] [--rounds N] OTHER [OTHER ...]

Each OTHER is a ``combine_max.cu`` or a checkout holding
``ipk_tpu_torch/core/csrc/combine_max.cu`` (for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
Each is compiled with nvcc into its own library under
``build/ipk_tpu_torch/ab/``, with the flags of ``core._build``, and called
through the C entries ``ipk_combine_max`` and ``ipk_combine_max_positions``
that every version exports. This checkout's kernel goes through
``core.kernels`` as the build calls it; its ``ipk_combine_max_uncounted``
(the same kernel without the explored count) is timed beside it.

The inputs are the main-path launches of ``chip_smoke.py``'s DNA k=8 scale
project (256 taxa x 1500 sites, seed 9): the first key batch of the plain
build, L [1020, 1493, 64] x R [1020, 1493, 256], and the one launch of the
``--keep-positions`` build, L = R [1020, 1493, 256]. Every version must give
A (bits), pos and counts equal to this checkout's kernel. Each timing is the
CUDA-event mean of ``--reps`` launches after a warm-up; the versions are
timed in turns (this, others, others reversed, this) for ``--rounds``
rounds. Also prints the instruction mix of each combine_max kernel's hot
loop (``cuobjdump -sass``), and what the kernel's work depends on in these
halves: the share of live (> -inf) values, and the rescans the positions
mode queues (plain torch, :func:`replacements`). Prints one line per
timing, the card's name and power limit, and a JSON summary as the last
line. Needs one CUDA card, nvcc and nvidia-smi.
"""

import argparse
import ctypes
import json
import os
import pathlib
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, flush=True)


def build_other(src, tag):
    from ipk_tpu_torch.core import _build
    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libcombine_max_{tag}.so")
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o", lib, src]
    run = subprocess.run(cmd, capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{run.stdout}{run.stderr}")
    for line in (run.stdout + run.stderr).splitlines():
        if "registers" in line or "spill" in line:
            log(f"[{tag}] ptxas: {line.strip()}")
    so = ctypes.CDLL(lib)
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    so.ipk_combine_max.argtypes = [vp, vp, ctypes.c_float, vp, vp, ll, ll,
                                   ll, ll, ctypes.c_int, vp]
    so.ipk_combine_max_positions.argtypes = [
        vp, vp, ctypes.c_float, vp, vp, vp, ll, ll, ll, ll, ctypes.c_int, vp]
    return so


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


def time_ms(torch, fn, reps):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="+")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py needs a CUDA card")
    from ipk_tpu_torch.core import _build, kernels
    lib = _build.load()
    log(f"[ab] hot loops (cuobjdump -sass): {hot_loops(_build.LIB_PATH)}")
    srcs = [o if o.endswith(".cu") else os.path.join(
        o, "ipk_tpu_torch", "core", "csrc", "combine_max.cu")
        for o in args.others]
    others = {f"other{n}": build_other(src, f"other{n}")
              for n, src in enumerate(srcs)}
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
        order = list(fns) + list(reversed(list(fns)))
        for rnd in range(args.rounds):
            for tag in order:
                ms = time_ms(torch, fns[tag], args.reps)
                results.setdefault(f"{mode}/{tag}", []).append(ms)
                log(f"[ab] round {rnd + 1} {mode} {tag}: {ms:.4f} ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({k: sum(v) / len(v) for k, v in results.items()}))


if __name__ == "__main__":
    main()
