#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, nvcc and
nvidia-smi. Imports nothing of JAX. Every phase raises on failure:

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile the kernels of ipk_tpu_torch/core/csrc with nvcc.
3. kernel  — combine_max on the card against its plain PyTorch version
             (combine_max_ref) on the same inputs, bit-equal A and counts
             (tolerance: none, the arithmetic is exactly rounded f32), at
             ragged random halves, AA k=4 halves (nl = nr = 400) and every
             key batch the phase-5 build launches on its real halves;
             kernel and plain times.
4. goldens — tests/data/golden D-dna (k=7) and D-aa (k=4) built on the card,
             payload-equal to the committed databases; a small amino build
             payload-equal between the card and the CPU.
5. scale   — a 256-taxon x 1500-site DNA project at k=8 (510 branches, 1020
             ghost matrices, W=1493) built in process and again through
             ``python -m ipk_tpu_torch build``; byte-identical files; timings,
             explored tuples, stage-1 tuples/s and peak device memory.

Kernel launch counts are reset just before phase 4 and read after phase 5,
so they count the main path only. The line before the last is a JSON
object of the kernels; the last line is
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


def log(msg: str) -> None:
    print(msg, flush=True)


def payload(path: str) -> bytes:
    raw = open(path, "rb").read()
    try:
        return zlib.decompress(raw)
    except zlib.error:
        return raw


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
        if "registers" in line or "spill" in line:
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


def compare_kernel(torch, label, L, R, eps, reps=5, plain_reps=2):
    """Kernel vs plain on one input: raises unless bit-equal."""
    from ipk_tpu_torch.core import dense, kernels
    A, counts = kernels.combine_max(L, R, eps)
    A_ref, counts_ref = dense.combine_max_ref(L, R, eps)
    torch.cuda.synchronize()
    same_mask = torch.equal(torch.isfinite(A), torch.isfinite(A_ref))
    live = torch.isfinite(A_ref)
    err = float((A[live] - A_ref[live]).abs().max()) if live.any() else 0.0
    if not (same_mask and torch.equal(A, A_ref)
            and torch.equal(counts, counts_ref)):
        raise RuntimeError(
            f"[kernel] {label}: kernel differs from combine_max_ref "
            f"(mask equal {same_mask}, max |dA| {err}, counts "
            f"{int(counts.sum())} vs {int(counts_ref.sum())})")
    ms = time_ms(torch, lambda: kernels.combine_max(L, R, eps), reps)
    plain_ms = time_ms(torch, lambda: dense.combine_max_ref(L, R, eps),
                       plain_reps)
    G, W, nl = L.shape
    log(f"[kernel] {label}: G={G} W={W} nl={nl} nr={R.shape[2]} bit-equal "
        f"(A and counts, {int(counts.sum())} tuples); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                tuples=int(counts.sum()))


def phase_kernel(torch, tmp, tree_file, fasta_file, ar_dir):
    import numpy as np
    from ipk_tpu_torch.builder import (choose_key_batches, stage1_inputs,
                                       stage1_state)
    from ipk_tpu_torch.core.dense import best_score_prefix, masked_halves
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
    runs = []
    for b in range(key_batches):
        Lb = L[:, :, b * step:(b + 1) * step].contiguous()
        runs.append(compare_kernel(
            torch, f"DNA k=8 scale project, key batch {b + 1}/{key_batches}",
            Lb, R, eps, reps=5, plain_reps=1))
        del Lb
    del L, R
    torch.cuda.empty_cache()
    res = dict(max_abs_err=max(r["max_abs_err"] for r in runs),
               ms=sum(r["ms"] for r in runs) / key_batches,
               plain_ms=sum(r["plain_ms"] for r in runs) / key_batches,
               tuples=sum(r["tuples"] for r in runs))
    log(f"[kernel] DNA k=8 scale project: {key_batches} launches per build, "
        f"kernel {res['ms']:.4f} ms per launch, "
        f"{res['ms'] * key_batches:.4f} ms per build; plain "
        f"{res['plain_ms']:.4f} ms per launch, "
        f"{res['plain_ms'] * key_batches:.4f} ms per build")
    return res


def phase_goldens(torch, tmp):
    from ipk_tpu_torch.core import kernels
    from ipk_tpu_torch.pipeline import BuildParams, build_database, get_traits
    from fixtures import make_project
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


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "ipk_tpu_torch")):
        print("chip_smoke.py: the ipk_tpu_torch package is not beside this "
              "script; run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import torch
    smi = phase_device(torch)
    phase_build()
    from ipk_tpu_torch.core import kernels
    from fixtures import make_project
    tmp = tempfile.mkdtemp(prefix="ipk_tpu_torch_smoke_")
    try:
        t0 = time.monotonic()
        scale_dir = os.path.join(tmp, "scale")
        os.makedirs(scale_dir)
        tree_file, fasta_file, ar_dir = make_project(
            pathlib.Path(scale_dir), num_leaves=SCALE["num_leaves"],
            width=SCALE["width"], seed=SCALE["seed"])
        log(f"[setup] scale project written in {time.monotonic() - t0:.1f} s")
        kres = phase_kernel(torch, tmp, tree_file, fasta_file, ar_dir)
        kernels.combine_max.launches = 0
        phase_goldens(torch, tmp)
        phase_scale(torch, tmp, tree_file, fasta_file, ar_dir,
                    kres["tuples"])
        launches = kernels.combine_max.launches
        if launches <= 0:
            raise RuntimeError("combine_max was not launched on the main path")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"kernels": [{
        "name": "combine_max", "route": "cuda",
        "source": "ipk_tpu_torch/core/csrc/combine_max.cu",
        "replaces": "ipk_tpu/core/pallas_kernels.py:163",
        "launches": launches, "max_abs_err": kres["max_abs_err"],
        "ms": kres["ms"], "plain_ms": kres["plain_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
