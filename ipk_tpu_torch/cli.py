"""Command-line interface of the port: ``python -m ipk_tpu_torch
build|diff|dump|place|diff-text``.

The option names and defaults are those of ``ipk_tpu/cli.py`` (which mirror
the reference wrapper, ``ipk.py:70-202``), plus ``--device``. It is written
on argparse rather than click so that it runs where click is not installed.

* ``build`` — compute a phylo-k-mer database on a torch device.
* ``diff``  — compare two databases; exits 1 on any difference.
* ``dump``  — plain-text dump in the reference's ipkdump format.
* ``place`` — place query sequences against a database; writes jplace v3.
* ``diff-text`` — tolerant comparison in linear space, ignoring k-mers at
  the threshold; exits 1 on any other difference.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from .ar.bridge import AMINO_MODELS, NUCL_MODELS

ALL_MODELS = NUCL_MODELS + AMINO_MODELS
KMER_FILTERS = ["mif0", "random"]
GHOST_STRATEGIES = ["inner-only", "outer-only", "both"]


def _existing_path(value: str) -> str:
    if not os.path.exists(value):
        raise argparse.ArgumentTypeError(f"Path '{value}' does not exist.")
    return value


def _existing_dir(value: str) -> str:
    if not os.path.isdir(value):
        raise argparse.ArgumentTypeError(
            f"Directory '{value}' does not exist.")
    return value


def _choice_lower(choices: List[str], what: str):
    def parse(value: str) -> str:
        value = value.lower()
        if value not in choices:
            raise argparse.ArgumentTypeError(
                f"{what} must be one of: " + ", ".join(choices))
        return value
    return parse


def parse_config(ar_config: str) -> str:
    """--ar-config JSON → raw --ar-parameters string (``ipk.py:241-250``)."""
    with open(ar_config) as f:
        content = json.load(f)
    if "arguments" not in content:
        raise RuntimeError(f"Error parsing {ar_config}: 'arguments' not found")
    return " ".join(f"--{k} {v}" for k, v in content["arguments"].items())


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ipk_tpu_torch",
        description="Phylo-k-mer database construction on PyTorch/CUDA.")
    parser.add_argument("--version", action="version",
                        version="ipk-tpu-torch 0.1.0")
    sub = parser.add_subparsers(dest="command", required=True)

    b = sub.add_parser("build", help="Compute a database of phylo-k-mers.")
    b.add_argument("-b", "--ar", default="",
                   help="Path to the ancestral reconstruction binary "
                        "(RAxML-ng), or 'native' for the built-in AR on the "
                        "build's device.")
    b.add_argument("-r", "--refalign", type=_existing_path, required=True,
                   help="Reference multiple sequence alignment in FASTA.")
    b.add_argument("-t", "--reftree", type=_existing_path, required=True,
                   help="Reference phylogenetic tree in Newick format.")
    b.add_argument("-s", "--states", choices=["nucl", "amino"],
                   default="nucl")
    b.add_argument("-v", "--verbosity", type=int, default=1)
    b.add_argument("-w", "--workdir", required=True)
    b.add_argument("-a", "--alpha", type=float, default=1.0)
    b.add_argument("-c", "--categories", type=int, default=4)
    b.add_argument("-k", "--k", type=int, default=8)
    b.add_argument("-m", "--model", default=None)
    b.add_argument("--convert-uo", action="store_true",
                   help="Convert U, O amino acids to C, L.")
    b.add_argument("--write-reduction", default="",
                   help="Write reduced alignment to file.")
    b.add_argument("--bb", dest="algorithm", action="store_const",
                   const="BB", help="Branch-and-bound enumeration.")
    b.add_argument("--dc", dest="algorithm", action="store_const",
                   const="DC", help="Divide-and-conquer enumeration.")
    b.add_argument("--dcla", dest="algorithm", action="store_const",
                   const="DCLA",
                   help="Divide-and-conquer with lookahead (default).")
    b.add_argument("--dccw", dest="algorithm", action="store_const",
                   const="DCCW", help="Divide-and-conquer, chained windows.")
    b.add_argument("--no-reduction", action="store_true")
    b.add_argument("--reduction-ratio", type=float, default=0.99)
    b.add_argument("--omega", type=float, default=1.5)
    b.add_argument("--filter", type=_choice_lower(KMER_FILTERS, "Filter"),
                   default="mif0")
    b.add_argument("-u", "--mu", type=float, default=1.0)
    b.add_argument("--ghosts",
                   type=_choice_lower(GHOST_STRATEGIES, "Strategy"),
                   default="both")
    b.add_argument("--use-unrooted", action="store_true")
    b.add_argument("--merge-branches", action="store_true")
    b.add_argument("--ar-dir", type=_existing_dir)
    b.add_argument("--ar-only", action="store_true")
    b.add_argument("--ar-config", type=_existing_path)
    b.add_argument("--ar-optimize", action="store_true",
                   help="With --ar native: fit branch lengths, GTR rates "
                        "and the gamma alpha by maximum likelihood first.")
    b.add_argument("--ar-opt-steps", type=int, default=200)
    b.add_argument("--keep-positions", action="store_true")
    b.add_argument("--uncompressed", action="store_true")
    b.add_argument("--threads", type=int, default=0,
                   help="Host threads for the native filter, deflate and "
                        "gather pools AND the AR subprocess. 0 = auto.")
    b.add_argument("-o", "--output", default="", help="Output file name")
    b.add_argument("--on-disk", action="store_true")
    b.add_argument("--max-candidates", type=int, default=4096,
                   help="Per-window survivor-list capacity on the large-k "
                        "(sparse) path; the build fails loudly if exceeded.")
    b.add_argument("--profile", dest="profile_dir", default="",
                   help="Write a torch.profiler Chrome trace of the build "
                        "into DIR.")
    b.add_argument("--device-mi", action="store_true",
                   help="Compute the mif0 filter on the devices as "
                        "collectives (f32) instead of the host f64 pass; "
                        "needs more than one rank.")
    b.add_argument("--coordinator", default="",
                   help="Multi-rank: rank 0's rendezvous address host:port "
                        "(the same for every rank).")
    b.add_argument("--num-hosts", type=int, default=0,
                   help="Multi-rank: the number of ranks, one process and "
                        "one device each.")
    b.add_argument("--host-id", type=int, default=-1,
                   help="Multi-rank: this process's rank in [0, "
                        "num-hosts).")
    b.add_argument("--device", default="cuda",
                   help="torch device to build on: cuda (default), cuda:N "
                        "or cpu.")

    d = sub.add_parser("diff", help="Compare two databases field by field; "
                                    "exit 1 on any difference.")
    d.add_argument("db1", type=_existing_path)
    d.add_argument("db2", type=_existing_path)
    d.add_argument("--verbose", action="store_true")
    d.add_argument("--eps", type=float, default=0.0,
                   help="Score tolerance; 0 = exact.")

    u = sub.add_parser("dump", help="Plain-text dump (reference ipkdump "
                                    "format).")
    u.add_argument("database", type=_existing_path)

    pl = sub.add_parser("place", help="Place query sequences (FASTA) "
                                      "against a database; writes jplace v3.")
    pl.add_argument("database", type=_existing_path)
    pl.add_argument("queries", type=_existing_path)
    pl.add_argument("-o", "--output", required=True,
                    help="Output .jplace file")
    pl.add_argument("--top", type=int, default=7,
                    help="Number of best branches reported per query.")
    pl.add_argument("--device", default="cuda",
                    help="torch device that scores batches of 64 queries "
                         "or more: cuda (default), cuda:N or cpu.")

    t = sub.add_parser("diff-text", help="Tolerant comparison ignoring "
                                         "threshold-boundary k-mers; exit 1 "
                                         "on differences.")
    t.add_argument("db1", type=_existing_path)
    t.add_argument("db2", type=_existing_path)
    t.add_argument("--eps", type=float, default=1e-3,
                   help="Linear-space score tolerance.")
    return parser


def _build(args, parser: argparse.ArgumentParser) -> int:
    if not args.ar_config and args.model not in ALL_MODELS:
        parser.error(
            "argument -m/--model: Please define a valid evolutionary model "
            "either via --model or in a config file via --ar-config. Valid "
            f"values: {ALL_MODELS}")
    if args.states == "nucl" and args.keep_positions:
        print("Error: --keep-positions is not supported for DNA.",
              file=sys.stderr)
        return 1
    from .pipeline import BuildParams, build_database
    created = False
    if args.num_hosts > 1:
        # one rank a process, each with one device (--device cpu: gloo)
        from .parallel.mesh import initialize_distributed
        created = initialize_distributed(
            coordinator=args.coordinator or None,
            num_processes=args.num_hosts,
            process_id=args.host_id if args.host_id >= 0 else None,
            device=args.device)
    params = BuildParams(
        refalign=args.refalign, reftree=args.reftree, states=args.states,
        working_dir=args.workdir,
        output_filename=args.output or os.path.join(args.workdir, "DB.ipk"),
        ar_binary=args.ar, ar_dir=args.ar_dir or "",
        ar_parameters=parse_config(args.ar_config) if args.ar_config else "",
        ar_only=args.ar_only, ar_optimize=args.ar_optimize,
        ar_opt_steps=args.ar_opt_steps, model=args.model or "GTR",
        alpha=args.alpha, categories=args.categories, kmer_size=args.k,
        omega=args.omega, mu=args.mu, reduction_ratio=args.reduction_ratio,
        no_reduction=args.no_reduction, filter=args.filter,
        ghosts=args.ghosts, use_unrooted=args.use_unrooted,
        merge_branches=args.merge_branches,
        keep_positions=args.keep_positions, uncompressed=args.uncompressed,
        on_disk=args.on_disk, num_threads=args.threads,
        algorithm=args.algorithm or "DCLA", convert_uo=args.convert_uo,
        write_reduction=args.write_reduction,
        max_candidates=args.max_candidates, profile_dir=args.profile_dir,
        device_mi=args.device_mi, verbosity=args.verbosity,
        device=args.device)
    try:
        build_database(params)
    finally:
        if created:
            import torch.distributed as dist
            dist.destroy_process_group()
    return 0


def _place(args) -> int:
    import torch
    from . import serialize
    from .alignment import read_fasta
    from .device import resolve
    from .placement import place_queries, write_jplace
    dev = resolve(args.device)
    db = serialize.load(args.database)
    queries = list(read_fasta(args.queries))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    placements = place_queries(db, queries, top=args.top, device=dev)
    seconds = time.monotonic() - t0
    write_jplace(db, placements, args.output)
    line = (f"Placed {len(placements)} queries -> {args.output} in "
            f"{seconds:.3f} s ({len(queries) / max(seconds, 1e-9):.1f} "
            f"queries/s on {dev}")
    if dev.type == "cuda":
        line += (f", max_memory_allocated "
                 f"{torch.cuda.max_memory_allocated(dev)} B")
    print(line + ")")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = _build_parser()
    args = parser.parse_args(argv)
    from .utils.malloc_tune import retain_heap
    retain_heap()
    if args.command == "build":
        return _build(args, parser)
    if args.command == "diff":
        from .tools import diff_databases
        ok = diff_databases(args.db1, args.db2, verbose=args.verbose,
                            eps=args.eps)
        return 0 if ok else 1
    if args.command == "diff-text":
        from .tools import diff_plain_text
        return 0 if diff_plain_text(args.db1, args.db2, eps=args.eps) else 1
    if args.command == "place":
        return _place(args)
    from .tools import dump_database
    dump_database(args.database, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
