"""Runs jobs of ipk_tpu_torch on the ranks of a gloo world on the CPU.

The tests call :func:`run_ranks`, which starts one process of this file per
rank. Each joins the world through its own ``file://`` rendezvous under the
test's directory (so tests under xdist never share one), runs the jobs in
order, and writes each job's outputs to ``<dir>/<job>.rank<r>.npz``; a build
job writes its database to ``<dir>/<job>.rank<r>.ipk`` and its route and
explored count to ``<dir>/<job>.rank<r>.json``. It imports no jax.

Job kinds (``spec["kind"]``), inputs from ``<dir>/<job>.in.npz``:

* ``key_merge``: ``parallel.key_merge.device_key_merge`` → keys, border,
  scores, or ``overflow`` 1;
* ``build_step``: ``sharded_build_step`` on a ``n_key``-wide mesh → A, fv,
  counts;
* ``batched_step``: ``sharded_batched_build_step``, batch by batch → A, fv,
  counts;
* ``enumerate``: ``sharded_enumerate`` → A;
* ``sparse_many``: ``sparse.enumerate_sparse_many`` with the mesh → codes,
  scores, overflow;
* ``gpu_clash``: ``check_one_rank_per_gpu`` with every rank naming cuda:0
  → ``raised`` 1 when it raises;
* ``build``: ``pipeline.build_database`` with ``params`` on the CPU, after
  the ``patch`` of the builder (``key_batches``, ``sparse``, ``budget``,
  ``merge_overflow``) and with ``env`` set.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(n: int, jobs: list, directory, timeout: float = 240.0):
    """Run ``jobs`` (dicts with "name", "kind" and the kind's keys) on n
    ranks; raise with a rank's stderr if any rank fails or runs out of
    time. Inputs must be saved as ``<directory>/<name>.in.npz`` first."""
    directory = str(directory)
    spec = os.path.join(directory, f"world{n}.json")
    rendezvous = os.path.join(directory, f"world{n}.rdv")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    with open(spec, "w") as f:
        json.dump({"jobs": jobs, "init": "file://" + rendezvous}, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               spec, str(r), str(n)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(n)]
    try:
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, err) in enumerate(zip(procs, errs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {n} failed ({p.returncode}):\n"
                               f"{err.decode()[-4000:]}")


def load(directory, name: str, rank: int):
    return np.load(os.path.join(str(directory), f"{name}.rank{rank}.npz"))


def _patched_build(job, out, wd):
    """build_database on the CPU with the job's builder patches."""
    import ipk_tpu_torch.builder as builder
    from ipk_tpu_torch.parallel import key_merge
    from ipk_tpu_torch.pipeline import BuildParams, build_database
    patch = job.get("patch", {})
    saved = {name: getattr(builder, name) for name in (
        "pick_key_batches", "MAX_DENSE_KEYSPACE",
        "_DEVICE_MERGE_BUDGET_BYTES", "_enumerate_sparse_branches")}
    saved_merge = key_merge.device_key_merge
    saved_env = {key: os.environ.get(key) for key in job.get("env", {})}
    if "key_batches" in patch:
        builder.pick_key_batches = lambda *a, **kw: patch["key_batches"]
    if patch.get("sparse"):
        builder.MAX_DENSE_KEYSPACE = 1
    if "budget" in patch:
        builder._DEVICE_MERGE_BUDGET_BYTES = patch["budget"]
    if patch.get("merge_overflow"):
        def blown(*args, **kwargs):
            raise key_merge.KeyMergeOverflow("forced bucket overflow (test)")

        def no_rerun(*args, **kwargs):
            raise AssertionError("stage 1 was re-run instead of reused")
        key_merge.device_key_merge = blown
        builder._enumerate_sparse_branches = no_rerun
    os.environ.update(job.get("env", {}))
    try:
        return build_database(BuildParams(
            **job["params"], working_dir=wd, output_filename=out,
            verbosity=0, device="cpu"))
    finally:
        for name, value in saved.items():
            setattr(builder, name, value)
        key_merge.device_key_merge = saved_merge
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def _run_job(job, directory, rank):
    import torch
    from ipk_tpu_torch.core import sparse
    from ipk_tpu_torch.parallel import build_sharded, key_merge, mesh
    name, kind = job["name"], job["kind"]
    stem = os.path.join(directory, f"{name}.rank{rank}")
    if kind == "build":
        result = _patched_build(job, stem + ".ipk",
                                os.path.join(directory, f"wd_{name}_{rank}"))
        with open(stem + ".json", "w") as f:
            json.dump({"merge": result.stats.get("merge"),
                       "num_explored": result.num_explored}, f)
        return
    if kind == "gpu_clash":
        try:
            mesh.check_one_rank_per_gpu(torch.device("cuda", 0))
            raised = 0
        except RuntimeError:
            raised = 1
        np.savez(stem + ".npz", raised=np.int64(raised))
        return
    inp = np.load(os.path.join(directory, f"{name}.in.npz"))
    m = mesh.make_mesh(n_key=job.get("n_key", 1), device="cpu")
    out = {}
    if kind == "key_merge":
        try:
            keys, border, scores = key_merge.device_key_merge(
                m, m.local_rows(inp["cl"]), m.local_rows(inp["cr"]),
                m.local_rows(inp["scores"]),
                ghosts_per_group=job["gpg"], nl=job["nl"], bits=job["bits"],
                k=job["k"], bucket_cap=job.get("bucket_cap"))
            out = dict(keys=keys, border=border, scores=scores)
        except key_merge.KeyMergeOverflow:
            out = dict(overflow=np.int64(1))
    elif kind == "build_step":
        step = build_sharded.sharded_build_step(
            m, k=job["k"], sigma=job["sigma"], ghosts_per_group=job["gpg"],
            total_num_groups=job["groups"], threshold=job["threshold"])
        A, fv, counts = step(inp["P"], inp["prefix"], inp["eps"])
        out = dict(A=A.numpy(), fv=fv.numpy(), counts=counts.numpy())
    elif kind == "batched_step":
        halves_fn, batch_fn, step_l = build_sharded.sharded_batched_build_step(
            m, k=job["k"], sigma=job["sigma"], ghosts_per_group=job["gpg"],
            total_num_groups=job["groups"], threshold=job["threshold"],
            key_batches=job["key_batches"])
        L, R, eps = halves_fn(inp["P"], inp["prefix"], inp["eps"])
        parts = [batch_fn(L, R, eps, b * step_l)
                 for b in range(job["key_batches"])]
        out = dict(A=torch.cat([p[0] for p in parts], dim=1).numpy(),
                   fv=torch.cat([p[1] for p in parts]).numpy(),
                   counts=sum(p[2] for p in parts).numpy())
    elif kind == "enumerate":
        out = dict(A=build_sharded.sharded_enumerate(
            m, inp["P"], inp["prefix"], inp["eps"], k=job["k"],
            sigma=job["sigma"], ghosts_per_group=job["gpg"]))
    elif kind == "sparse_many":
        codes, scores, overflow = sparse.enumerate_sparse_many(
            inp["P"], inp["prefix"], inp["eps"], k=job["k"],
            sigma=job["sigma"], bits=job["bits"], cap=job["cap"], mesh=m)
        out = dict(codes=codes, scores=scores, overflow=overflow)
    else:
        raise ValueError(f"unknown job kind {kind}")
    np.savez(stem + ".npz", **out)


def main(spec_path: str, rank: int, world: int) -> int:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    directory = os.path.dirname(spec_path)
    dist.init_process_group("gloo", init_method=spec["init"],
                            world_size=world, rank=rank)
    try:
        for job in spec["jobs"]:
            _run_job(job, directory, rank)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3])))
