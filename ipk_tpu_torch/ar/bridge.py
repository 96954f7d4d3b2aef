"""Ancestral-reconstruction bridge: external tool invocation + replay.

The port's own copy of ``ipk_tpu/ar/bridge.py``: only its imports differ,
so numerics, ordering, formats and messages stay those of the reference.

Counterpart of ``ipk/src/ar.cpp`` layers (SURVEY.md §2.1 "AR bridge"):

* :func:`guess_software` — probe ``<binary> --help`` output for
  "phyml"/"raxml-ng" (``ar.cpp:273-328``).
* :class:`RaxmlWrapper` — builds the exact raxml-ng argv of the reference
  (``--ancestral --msa .. --tree .. --threads N --precision 9 --seed 1
  --force msa --redo`` + model string ``<MODEL>+G<cats>{<alpha>}+IU{0}+FC
  --blopt nr_safe --opt-model on --opt-branches on``; ``ar.cpp:650-707``) or
  passes raw ``--ar-parameters`` verbatim (``ar.cpp:696-704``).
* ``--ar-dir`` replay: instead of running AR, search the directory for the
  first files suffixed ``.raxml.ancestralProbs`` / ``.raxml.ancestralTree``
  (``ar.cpp:599-640``). This is the hermetic-test seam (SURVEY.md §4).
* :class:`PhymlWrapper` — byte-parity phyml argv (``ar.cpp:550-563``) and
  ``--ar-dir`` suffix replay (``ar.cpp:497-537``); invocation succeeds, but
  READING phyml posteriors is unsupported — the pipeline throws the
  reference's exact "PhyML is not supported in this version"
  (``ar.cpp:77-81``) after the AR step.
* model names: 22 nucleotide + 23 amino models accepted at the wrapper level
  (``ipk.py:21-27``); the binary-level enum subset is not re-imposed because
  raxml-ng is the actual authority on model strings.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
from typing import Optional, Tuple

__all__ = ["ArParameters", "guess_software", "run_ancestral_reconstruction",
           "find_raxmlng", "RaxmlWrapper", "PhymlWrapper",
           "NUCL_MODELS", "AMINO_MODELS"]

# ipk.py:21-27
NUCL_MODELS = ["JC", "K80", "F81", "HKY", "TN93ef",
               "TN93", "K81", "K81uf", "TPM2", "TPM2uf", "TPM3", "TPM3uf",
               "TIM1", "TIM1uf", "TIM2", "TIM2uf", "TIM3", "TIM3uf", "TVMef",
               "TVM", "SYM", "GTR"]
AMINO_MODELS = ["Blosum62", "cpREV", "Dayhoff", "DCMut", "DEN", "FLU", "HIVb",
                "HIVw", "JTT", "JTT-DCMut", "LG", "mtART", "mtMAM", "mtREV",
                "mtZOA", "PMB", "rtREV", "stmtREV", "VT", "WAG", "LG4M",
                "LG4X", "PROTGTR"]


@dataclasses.dataclass
class ArParameters:
    """AR invocation parameters (cf. ``ar::parameters``, ``ar.h``)."""
    binary_file: str = ""
    ar_dir: str = ""
    ar_parameters: str = ""       # raw --ar-parameters string, passed verbatim
    model: str = "GTR"
    alpha: float = 1.0
    categories: int = 4
    num_threads: int = 1
    tree_file: str = ""
    alignment_file: str = ""


def find_raxmlng() -> str:
    """Locate raxml-ng on PATH (``ipk.py:233-238``)."""
    path = shutil.which("raxml-ng")
    if not path:
        raise RuntimeError("RAxML-ng not found. Please check it exists in your "
                           "PATH or provide a full filename")
    return path


def guess_software(binary_file: str, working_dir: str) -> str:
    """Run ``<binary> --help`` and grep for the tool name (``ar.cpp:273-328``).

    Returns "raxml-ng" or "phyml".
    """
    os.makedirs(working_dir, exist_ok=True)
    log_path = os.path.join(working_dir, "ar_help.log")
    try:
        with open(log_path, "w") as out:
            subprocess.run([binary_file, "--help"], stdout=out,
                           stderr=subprocess.DEVNULL, check=False)
    except OSError:
        raise RuntimeError(
            f"Error: Could not run ancestral reconstruction software: {binary_file}")
    with open(log_path) as f:
        for line in f:
            low = line.lower()
            if "phyml" in low:
                return "phyml"
            if "raxml-ng" in low:
                return "raxml-ng"
    raise RuntimeError(
        f"Error: Unsupported ancestral reconstruction software: {binary_file}")


def _find_file_by_suffix(directory: str, suffix: str) -> Optional[str]:
    """First regular file with the given suffix (``ar.cpp:458-469``)."""
    for entry in sorted(os.listdir(directory)):
        path = os.path.join(directory, entry)
        if os.path.isfile(path) and entry.endswith(suffix):
            return path
    return None


def _check_file(path: str) -> None:
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        raise RuntimeError("Error during ancestral reconstruction: could not "
                           f"find {path}")


class RaxmlWrapper:
    """raxml-ng invocation/replay (``ar.cpp:584-720``)."""

    PROBS_SUFFIX = ".raxml.ancestralProbs"
    TREE_SUFFIX = ".raxml.ancestralTree"

    def __init__(self, params: ArParameters):
        self.params = params

    def make_args(self) -> list:
        p = self.params
        args = ["--ancestral",
                "--msa", p.alignment_file,
                "--tree", p.tree_file,
                "--threads", str(p.num_threads),
                "--precision", "9",
                "--seed", "1",
                "--force", "msa",
                "--redo"]
        if not p.ar_parameters:
            model = f"{p.model}+G{p.categories}{{{p.alpha}}}+IU{{0}}+FC"
            args += ["--model", model,
                     "--blopt", "nr_safe",
                     "--opt-model", "on",
                     "--opt-branches", "on"]
        else:
            args += p.ar_parameters.split(" ")
        return args

    def run(self) -> Tuple[str, str]:
        """Returns (probs_file, tree_file)."""
        p = self.params
        if not p.ar_dir:
            args = [p.binary_file] + self.make_args()
            print("Running:", " ".join(args))
            result = subprocess.run(args)
            if result.returncode != 0:
                raise RuntimeError("Error during ancestral reconstruction: "
                                   f"exit code {result.returncode}")
            probs = p.alignment_file + self.PROBS_SUFFIX
            tree = p.alignment_file + self.TREE_SUFFIX
            _check_file(probs)
            _check_file(tree)
        else:
            if not os.path.isdir(p.ar_dir):
                raise RuntimeError(f"Error! No such directory: {p.ar_dir}")
            probs = _find_file_by_suffix(p.ar_dir, self.PROBS_SUFFIX)
            if not probs:
                raise RuntimeError(
                    f'Could not find "*{self.PROBS_SUFFIX}" in the folder '
                    f"provided by --ar-dir: {p.ar_dir}")
            tree = _find_file_by_suffix(p.ar_dir, self.TREE_SUFFIX)
            if not tree:
                raise RuntimeError(
                    f'Could not find "*{self.TREE_SUFFIX}" in the folder '
                    f"provided by --ar-dir: {p.ar_dir}")
        print("Ancestral reconstruction results have been found:")
        print(f"\t{probs}\n\t{tree}")
        return probs, tree


class PhymlWrapper:
    """PhyML invocation/replay (``ar.cpp:481-582``): the argv and the
    ``--ar-dir`` suffix replay match the reference byte-for-byte, and like
    the reference the run/replay SUCCEEDS — the unsupported part is
    *reading* PhyML posteriors, which the reference's reader throws on
    (``ar.cpp:77-81``), so consuming the returned files raises the same
    "PhyML is not supported in this version" error downstream."""

    MATRIX_SUFFIX = "_phyml_ancestral_seq.txt"
    TREE_SUFFIX = "_phyml_ancestral_tree.txt"

    def __init__(self, params: ArParameters):
        self.params = params

    def make_args(self) -> list:
        p = self.params
        # ar.cpp:550-563
        return ["--ancestral",
                "--no_memory_check",
                "-i", p.alignment_file,
                "-u", p.tree_file,
                "-m", p.model,
                "-c", str(p.categories),
                "-b", "0",
                "-v", "0.0",
                "-o", "r",
                "-a", str(p.alpha),
                "-f", "e",
                "--leave_duplicates"]

    def run(self) -> Tuple[str, str]:
        p = self.params
        if not p.ar_dir:
            args = [p.binary_file] + self.make_args()
            print("Running:", " ".join(args))
            result = subprocess.run(args)
            if result.returncode != 0:
                raise RuntimeError("Error during ancestral reconstruction: "
                                   f"exit code {result.returncode}")
            matrix = p.alignment_file + self.MATRIX_SUFFIX
            tree = p.alignment_file + self.TREE_SUFFIX
            _check_file(matrix)
            _check_file(tree)
        else:
            if not os.path.isdir(p.ar_dir):
                raise RuntimeError(f"Error! No such directory: {p.ar_dir}")
            matrix = _find_file_by_suffix(p.ar_dir, self.MATRIX_SUFFIX)
            if not matrix:
                raise RuntimeError(
                    f'Could not find "*{self.MATRIX_SUFFIX}" in the folder '
                    f"provided by --ar-dir: {p.ar_dir}")
            tree = _find_file_by_suffix(p.ar_dir, self.TREE_SUFFIX)
            if not tree:
                raise RuntimeError(
                    f'Could not find "*{self.TREE_SUFFIX}" in the folder '
                    f"provided by --ar-dir: {p.ar_dir}")
        print("Ancestral reconstruction results have been found:")
        print(f"\t{matrix}\n\t{tree}")
        return matrix, tree


def run_ancestral_reconstruction(software: str, params: ArParameters
                                 ) -> Tuple[str, str]:
    """Run (or replay) AR; returns (probs_file, tree_file)."""
    if software == "raxml-ng":
        return RaxmlWrapper(params).run()
    if software == "phyml":
        return PhymlWrapper(params).run()
    raise RuntimeError("Unsupported ancestral reconstruction output format.")
