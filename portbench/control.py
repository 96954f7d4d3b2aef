#!/usr/bin/env python3
"""The readings that a configuration's limits are set from, on one card.

    python3 portbench/control.py --config <name> --traffic <name> \\
        --seeds <n>... [--control <count>]

For each seed: the project of that seed, one build through the cell's
entry (``pipeline.build_database`` with the cell's parameters), and the
numbers of ``compare.compare`` for its database (the program's readings,
the lower ends of the limits). For the first ``--control`` seeds also the
control: the plain reference computed in bfloat16, the precision below the
configuration's float32 scores, put in the program's place and compared
the same way (the upper ends). One JSON line a seed and kind; the last line
holds the largest program reading and the smallest control reading of each
number.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None, device: str = "cuda") -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", default="build")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from portbench import compare, harness, project, reference
    from portbench.run import load_json
    if device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    harness.DEVICE = device
    config = load_json(os.path.join(HERE, "configs", args.config + ".json"))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     args.traffic + ".json"))
    b = config["build"]
    from ipk_tpu_torch.pipeline import build_database
    worst = {}
    least = {}
    for i, seed in enumerate(args.seeds):
        tmp = tempfile.mkdtemp(prefix="portbench-control-")
        try:
            files = project.make_project(tmp, config["num_leaves"],
                                         config["width"], seed,
                                         config["model"])
            out = os.path.join(tmp, "DB.ipk")
            params = harness.build_params(files, os.path.join(tmp, "work"),
                                          out, config, traffic)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                build_database(params)
            build_s = time.perf_counter() - t0
            size = os.path.getsize(out)
            numbers = harness.check(config, files, out, seed)
            line = {"seed": seed, "kind": "program", "build_s": build_s,
                    "ipk_bytes": size,
                    **{n: c["value"] for n, c in numbers.items()}}
            print(json.dumps(line), flush=True)
            for n in compare.NAMES:
                worst[n] = max(worst.get(n, line[n]), line[n])
            if i < args.control:
                with open(files.tree_file) as f:
                    lay = reference.layout(f.read())
                logp = torch.log10(torch.from_numpy(files.probs).to(
                    device, torch.float32))
                keys = compare.sample_keys(b["kmer_size"],
                                           config["check_keys"], seed)
                low = compare.reference_database(
                    logp.to(torch.bfloat16), lay, keys, b["kmer_size"],
                    b["omega"])
                got = compare.compare(low, logp, lay, keys, b["kmer_size"],
                                      b["omega"], config["limits"])
                print(json.dumps({"seed": seed, "kind": "control_bf16",
                                  **got}), flush=True)
                for n in compare.NAMES:
                    least[n] = min(least.get(n, got[n]), got[n])
                del logp, low
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"config": args.config, "program_max": worst,
                      "control_min": least,
                      "limits": config["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
