"""End-to-end database build: alignment → tree extension → AR → build on a
torch device. The counterpart of ``ipk_tpu/pipeline.py`` (and of the
reference's ``build_database``, ``ipk/src/main.cpp:129-199``), writing the
same artifacts:

* ``<workdir>/align.reduced.fasta``
* ``<workdir>/extended_trees/extended_tree.newick``
* ``<workdir>/extended_trees/extended_align.{fasta,phylip}``
* ``<workdir>/AR/ar_tree_rerooted.newick`` when AR unroots a rooted input

AR runs as a raxml-ng subprocess or is replayed from ``--ar-dir``, through
``ar.bridge``, or, with ``--ar native`` and no ``--ar-dir``, on the
build's device (``ipk_tpu_torch.ar.native``, optionally after the ML fit of
``--ar-optimize``), which writes raxml-ng's artifacts under
``<workdir>/AR/``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, NamedTuple, Optional

import numpy as np

from . import alignment as aln
from . import tree as tr
from .ar import bridge
from .ar.mapping import map_nodes
from .ar.reader import read_ancestral_probs
from .builder import BuildResult, build
from .seq import SeqTraits, get_traits
from .spans import Recorder
from .tree import PhyloTree
from .utils.threads import set_host_threads

__all__ = ["BuildParams", "BuildInputs", "build_database", "prepare",
           "get_traits"]


@dataclasses.dataclass
class BuildParams:
    """Mirror of the CLI parameter surface (``ipk.py:70-202``), plus the
    torch device the build runs on."""
    refalign: str = ""
    reftree: str = ""
    states: str = "nucl"
    working_dir: str = ""
    output_filename: str = ""
    ar_binary: str = ""
    ar_dir: str = ""
    ar_parameters: str = ""
    ar_only: bool = False
    ar_optimize: bool = False
    ar_opt_steps: int = 200
    model: str = "GTR"
    alpha: float = 1.0
    categories: int = 4
    kmer_size: int = 8
    omega: float = 1.5
    mu: float = 1.0              # accepted but dead, like the reference
    reduction_ratio: float = 0.99
    no_reduction: bool = False
    filter: str = "mif0"
    ghosts: str = "both"
    algorithm: str = "DCLA"      # accepted; DCLA semantics always run
    convert_uo: bool = False
    write_reduction: str = ""
    max_candidates: int = 4096   # survivor-list cap on the sparse large-k path
    profile_dir: str = ""        # torch.profiler Chrome trace of the build
    use_unrooted: bool = False
    merge_branches: bool = False
    keep_positions: bool = False
    uncompressed: bool = False
    on_disk: bool = False
    device_mi: bool = False
    num_threads: int = 0         # 0 = auto; N pins every host pool and AR
    verbosity: int = 1
    device: str = "cuda"


class BuildInputs(NamedTuple):
    """What the stages before the build hand to ``builder.build``."""
    original_tree: PhyloTree
    extended_tree: PhyloTree
    ghost_mapping: Dict[str, int]
    ar_mapping: Dict[str, str]
    label_rows: Dict[str, int]
    P: np.ndarray                # AR posteriors, one row per AR node x site
    traits: SeqTraits


def prepare(p: BuildParams,
            recorder: Optional[Recorder] = None) -> Optional[BuildInputs]:
    """Run the stages before the build (alignment, tree extension, AR) and
    write their artifacts; None when ``p.ar_only`` stops after AR. The
    ``prepare`` span and its children (``prepare.alignment``,
    ``prepare.tree``, ``prepare.extend``, ``prepare.ar``,
    ``prepare.ar_read``) go to ``recorder``."""
    rec = recorder if recorder is not None else Recorder()
    with rec.span("prepare", group=True):
        return _prepare(p, rec)


def _prepare(p: BuildParams, rec: Recorder) -> Optional[BuildInputs]:
    set_host_threads(p.num_threads)
    ar_threads = p.num_threads if p.num_threads > 0 else (os.cpu_count() or 1)
    traits = get_traits(p.states)
    if p.kmer_size > traits.max_kmer_length:
        raise RuntimeError(f"Maximum k-mer size allowed: {traits.max_kmer_length}")
    if p.merge_branches and not p.keep_positions and p.verbosity > 0:
        print("Note: --merge-branches without --keep-positions is an "
              "ipk_tpu extension (the reference rejects it).")

    # L5: alignment preprocessing
    with rec.span("prepare.alignment"):
        align = aln.preprocess_alignment(p.working_dir, p.refalign,
                                         p.reduction_ratio, p.no_reduction,
                                         traits, p.verbosity,
                                         convert_uo_flag=p.convert_uo,
                                         write_reduction=p.write_reduction)

    # L5: tree extension
    with rec.span("prepare.tree"):
        original_tree, extended_tree, ghost_mapping = tr.preprocess_tree(
            p.reftree, p.use_unrooted)
        ext_dir = os.path.join(p.working_dir, "extended_trees")
        os.makedirs(ext_dir, exist_ok=True)
        ext_tree_file = os.path.join(ext_dir, "extended_tree.newick")
        tr.save_tree(extended_tree, ext_tree_file)

    with rec.span("prepare.extend"):
        extended = aln.extend_alignment(align, extended_tree, traits)
        fasta_path = os.path.join(ext_dir, "extended_align.fasta")
        phylip_path = os.path.join(ext_dir, "extended_align.phylip")
        aln.save_alignment(extended, fasta_path, "fasta")
        aln.save_alignment(extended, phylip_path, "phylip")

    # L4: ancestral reconstruction (native on the device, subprocess, or
    # --ar-dir replay); --ar-optimize acts on the native route only
    with rec.span("prepare.ar"):
        if p.ar_binary == "native" and not p.ar_dir:
            from .ar.native import run_native_ar
            probs_file, ar_tree_file = run_native_ar(
                extended_tree, extended, p.working_dir, traits,
                alpha=p.alpha, categories=p.categories,
                optimize=p.ar_optimize, opt_steps=p.ar_opt_steps,
                verbosity=p.verbosity, device=p.device)
        else:
            probs_file, ar_tree_file = _external_ar(p, ar_threads,
                                                    ext_tree_file,
                                                    phylip_path)

    if p.ar_only:
        if p.verbosity > 0:
            print("--ar-only requested. Finishing after ancestral "
                  "reconstruction.")
        return None

    with rec.span("prepare.ar_read"):
        # AR unroots a rooted input; re-root it back (``main.cpp:170-178``)
        ar_tree = tr.load_newick(ar_tree_file)
        if original_tree.is_rooted() and not ar_tree.is_rooted():
            tr.reroot_tree(ar_tree)
            ar_dir_out = os.path.join(p.working_dir, "AR")
            os.makedirs(ar_dir_out, exist_ok=True)
            tr.save_tree(ar_tree, os.path.join(ar_dir_out,
                                               "ar_tree_rerooted.newick"))

        ar_mapping = map_nodes(extended_tree, ar_tree)
        label_rows, P = read_ancestral_probs(probs_file, traits)
    return BuildInputs(original_tree, extended_tree, ghost_mapping,
                       ar_mapping, label_rows, P, traits)


def _external_ar(p: BuildParams, ar_threads: int, ext_tree_file: str,
                 phylip_path: str):
    """AR by a raxml-ng subprocess or an ``--ar-dir`` replay, through
    ``ar.bridge``: (probs file, AR tree file)."""
    ar_params = bridge.ArParameters(
        binary_file=p.ar_binary, ar_dir=p.ar_dir,
        ar_parameters=p.ar_parameters, model=p.model, alpha=p.alpha,
        categories=p.categories, num_threads=ar_threads,
        tree_file=ext_tree_file, alignment_file=phylip_path)
    if p.ar_dir:
        # replay: detect which tool produced the directory by suffix
        # (raxml-ng first, then phyml — ``ar.cpp:599-640,497-537``)
        software = "raxml-ng"
        if (bridge._find_file_by_suffix(
                p.ar_dir, bridge.RaxmlWrapper.PROBS_SUFFIX) is None
                and os.path.isdir(p.ar_dir)
                and bridge._find_file_by_suffix(
                    p.ar_dir, bridge.PhymlWrapper.MATRIX_SUFFIX)):
            software = "phyml"
    else:
        binary = p.ar_binary or bridge.find_raxmlng()
        ar_params.binary_file = binary
        software = bridge.guess_software(binary, p.working_dir)
    probs_file, ar_tree_file = bridge.run_ancestral_reconstruction(
        software, ar_params)
    if software == "phyml":
        # reading phyml posteriors is unsupported, as in the reference
        # (``ar.cpp:77-81``)
        raise RuntimeError("PhyML is not supported in this version.")
    return probs_file, ar_tree_file


def build_database(p: BuildParams) -> Optional[BuildResult]:
    """``prepare`` then ``build``, under one root span ``build_database``:
    the result's ``timings`` and ``spans`` hold both stages'."""
    recorder = Recorder()
    with recorder.span("build_database", group=True):
        inp = prepare(p, recorder)
        if inp is None:
            return None
        output = p.output_filename or os.path.join(p.working_dir, "DB.ipk")

        def run_build():
            return build(inp.original_tree, inp.extended_tree,
                         inp.ghost_mapping, inp.ar_mapping, inp.label_rows,
                         inp.P, traits=inp.traits, kmer_size=p.kmer_size,
                         omega=p.omega, filter_type=p.filter,
                         ghost_strategy=p.ghosts,
                         merge_branches=p.merge_branches,
                         keep_positions=p.keep_positions,
                         output_filename=output, uncompressed=p.uncompressed,
                         on_disk=p.on_disk, working_dir=p.working_dir,
                         sparse_cap=p.max_candidates,
                         device_mi=p.device_mi, device=p.device,
                         verbose=p.verbosity, recorder=recorder)

        if not p.profile_dir:
            return run_build()
        # --profile: the build alone under torch.profiler (CPU, and CUDA on
        # a card), as ipk_tpu traces it (ipk_tpu/pipeline.py:177-183); the
        # Chrome trace goes to <profile_dir>/trace.json (trace.rank<N>.json
        # on rank N of a world of more than one). Every thread is traced:
        # stage 1 runs in the prefetch worker. The build's spans are
        # ``ipk.<name>`` events in it.
        import torch
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile
        from .device import resolve
        from .parallel.mesh import world_size
        activities = [ProfilerActivity.CPU]
        if resolve(p.device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities, experimental_config=(
                _ExperimentalConfig(profile_all_threads=True))) as prof:
            result = run_build()
    os.makedirs(p.profile_dir, exist_ok=True)
    name = "trace.json"
    if world_size() > 1:
        name = f"trace.rank{torch.distributed.get_rank()}.json"
    prof.export_chrome_trace(os.path.join(p.profile_dir, name))
    return result
