"""Readers for ancestral-reconstruction posterior outputs.

The port's own copy of ``ipk_tpu/ar/reader.py``: only its imports differ,
so numerics, ordering, formats and messages stay those of the reference.

Counterpart of the reference's lazy ``raxmlng_reader`` (``ipk/src/ar.cpp:144-270``)
and ``proba_matrix`` (``ipk/src/proba_matrix.{h,cpp}``). The reference seeks and
CSV-parses one node block at a time because its pipeline is sequential and
memory-frugal; the TPU pipeline instead wants the whole [nodes, sites, σ]
tensor resident at once (it is the *input* of the batched dense kernel), so we
parse the entire TSV in one vectorized pass.

Semantics replicated:
* probabilities are log10-transformed at parse time in f32 (``ar.cpp:257-259``)
* amino-acid columns are permuted from the raxml-ng order
  ``a r n d c q e g h i l k m f p s t w y v`` to the i2l/RAPPAS order
  ``r h k d e s t n q c g p a i l m f w y v`` (``ar.cpp:227-234``)
* DNA columns A,C,G,T are used as-is (``ar.cpp:222-225``)

File format (raxml-ng --ancestral .raxml.ancestralProbs): a header line, then
one tab-separated row per (node, site): ``Node  Site  State  p_1 ... p_sigma``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..seq import SeqTraits, DNA, AA

__all__ = ["read_ancestral_probs", "RAXML_AA_ORDER", "aa_permutation"]

def _load_native() -> Optional[ctypes.CDLL]:
    """The C++ mmap/from_chars parser (native/probs_parser.cpp), built on
    demand with portable flags (utils/native.py); falls back to the
    pure-Python parser when unavailable or IPK_TPU_NO_NATIVE is set."""
    from ..utils.native import load_native_lib
    lib = load_native_lib("libprobs_parser.so")
    if lib is None or getattr(lib, "_ipk_typed", False):
        return lib
    lib.ipk_probs_parse.restype = ctypes.c_void_p
    lib.ipk_probs_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.ipk_probs_error.restype = ctypes.c_char_p
    lib.ipk_probs_num_labels.restype = ctypes.c_int64
    lib.ipk_probs_num_labels.argtypes = [ctypes.c_void_p]
    lib.ipk_probs_num_values.restype = ctypes.c_int64
    lib.ipk_probs_num_values.argtypes = [ctypes.c_void_p]
    lib.ipk_probs_labels.restype = ctypes.c_char_p
    lib.ipk_probs_labels.argtypes = [ctypes.c_void_p]
    lib.ipk_probs_rows_per_label.restype = ctypes.POINTER(ctypes.c_int64)
    lib.ipk_probs_rows_per_label.argtypes = [ctypes.c_void_p]
    lib.ipk_probs_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.ipk_probs_data.argtypes = [ctypes.c_void_p]
    lib.ipk_probs_free.argtypes = [ctypes.c_void_p]
    lib._ipk_typed = True
    return lib


def _read_native(filename: str, sigma: int
                 ) -> Optional[Tuple[Dict[str, int], np.ndarray]]:
    lib = _load_native()
    if lib is None:
        return None
    handle = lib.ipk_probs_parse(filename.encode(), sigma)
    if not handle:
        raise RuntimeError(
            f"Failed to parse {filename}: "
            f"{lib.ipk_probs_error().decode()}")
    try:
        n_labels = lib.ipk_probs_num_labels(handle)
        n_values = lib.ipk_probs_num_values(handle)
        labels = lib.ipk_probs_labels(handle).decode().split("\n")
        rows = np.ctypeslib.as_array(lib.ipk_probs_rows_per_label(handle),
                                     shape=(n_labels,))
        counts = set(rows.tolist())
        if len(counts) != 1:
            raise RuntimeError(
                f"Node blocks of unequal width in {filename}: "
                f"{sorted(counts)}")
        S = counts.pop()
        if n_values != n_labels * S * sigma:
            raise RuntimeError(f"Malformed probabilities in {filename}")
        flat = np.ctypeslib.as_array(lib.ipk_probs_data(handle),
                                     shape=(n_values,)).copy()
        probs = flat.reshape(n_labels, S, sigma)
        return {label: i for i, label in enumerate(labels)}, probs
    finally:
        lib.ipk_probs_free(handle)

#: raxml-ng's amino-acid column order in .raxml.ancestralProbs (``ar.cpp:227``).
RAXML_AA_ORDER = "ARNDCQEGHILKMFPSTWYV"


def aa_permutation() -> np.ndarray:
    """Permutation p with out[:, i] = raxml_cols[:, p[i]] mapping raxml order
    to the i2l/RAPPAS encoding order (``ar.cpp:232-234``)."""
    return np.array([RAXML_AA_ORDER.index(ch) for ch in AA.letters],
                    dtype=np.int64)


def read_ancestral_probs(filename: str, traits: SeqTraits = DNA,
                         ) -> Tuple[Dict[str, int], np.ndarray]:
    """Parse a .raxml.ancestralProbs TSV into a dense tensor.

    Returns (node_label -> row index, P[num_nodes, S, sigma] f32 log10).
    All node blocks must have the same number of sites (true by construction:
    raxml-ng emits every alignment site for every internal node).

    Uses the native mmap parser when built (libprobs_parser.so),
    otherwise a pure-Python fallback.
    """
    sigma = traits.alphabet_size
    native = _read_native(filename, sigma)
    if native is not None:
        label_rows, probs = native
        if traits.alphabet_size == 20:
            probs = probs[:, :, aa_permutation()]
        with np.errstate(divide="ignore"):
            return label_rows, np.log10(probs, dtype=np.float32)

    labels: List[str] = []
    label_rows: Dict[str, int] = {}
    prob_chunks: List[np.ndarray] = []

    with open(filename, "rb") as f:
        header = f.readline()
        if not header:
            raise RuntimeError(f"Empty ancestral probabilities file: {filename}")
        data = f.read()

    # Vectorized parse: split rows, then split the first three columns off and
    # parse the numeric tail with np.fromstring-like machinery.
    lines = data.split(b"\n")
    rows_per_label: Dict[str, int] = {}
    numeric_rows: List[bytes] = []
    for line in lines:
        if not line:
            continue
        node_end = line.find(b"\t")
        node = line[:node_end].decode()
        if not labels or labels[-1] != node:
            if node in label_rows:
                raise RuntimeError(
                    f"Non-contiguous node block for {node} in {filename}")
            label_rows[node] = len(labels)
            labels.append(node)
            rows_per_label[node] = 0
        rows_per_label[node] += 1
        # skip Site and State columns
        site_end = line.find(b"\t", node_end + 1)
        state_end = line.find(b"\t", site_end + 1)
        numeric_rows.append(line[state_end + 1:])

    if not labels:
        raise RuntimeError(f"No data rows in {filename}")
    counts = set(rows_per_label.values())
    if len(counts) != 1:
        raise RuntimeError(
            f"Node blocks of unequal width in {filename}: {sorted(counts)}")
    S = counts.pop()

    flat = np.array(b"\t".join(numeric_rows).split(b"\t"), dtype=np.float64)
    if flat.size != len(labels) * S * sigma:
        raise RuntimeError(
            f"Malformed probabilities in {filename}: expected "
            f"{len(labels) * S * sigma} values, got {flat.size}")
    probs = flat.reshape(len(labels), S, sigma).astype(np.float32)

    if traits.alphabet_size == 20:
        probs = probs[:, :, aa_permutation()]

    with np.errstate(divide="ignore"):
        P = np.log10(probs, dtype=np.float32)
    return label_rows, P
