"""Reference-alignment preprocessing: FASTA IO, gap-ratio column reduction,
alignment extension with ghost leaves, PHYLIP export.

The port's own copy of ``ipk_tpu/alignment.py``: only its imports differ,
so numerics, ordering, formats and messages stay those of the reference.

Counterpart of ``ipk/src/alignment.cpp`` (reference layer L5, SURVEY.md §1).
The alignment here is additionally exposed as a dense numpy byte matrix for
vectorized gap-ratio computation — the reference loops per character
(``alignment.cpp:139-160``); we compute the same ratios with one LUT gather.

Semantics replicated:
* column dropped iff gap_ratio >= reduction_ratio (``alignment.cpp:162-187``)
* reduced alignment saved as ``<workdir>/align.reduced.fasta``
  (``alignment.cpp:266-269``)
* extension appends all-gap rows for extended-tree leaves missing from the
  alignment, in tree postorder (``alignment.cpp:302-318``)
* PHYLIP writer: header "\\t<n>\\t<width>", 250-char label column, sequence in
  10-char chunks separated by spaces (``alignment.cpp:86-125``)
"""

from __future__ import annotations

import os
from typing import Iterator, List, Tuple

import numpy as np

from .seq import SeqTraits, DNA
from .tree import PhyloTree, postorder

__all__ = [
    "Alignment",
    "read_fasta",
    "write_fasta",
    "write_phylip",
    "load_alignment",
    "reduce_alignment",
    "preprocess_alignment",
    "extend_alignment",
    "save_alignment",
]


def read_fasta(filename: str) -> Iterator[Tuple[str, str]]:
    """Stream (header, sequence) records (cf. ``i2l::io::read_fasta``,
    ``alignment.cpp:64-73``)."""
    header = None
    chunks: List[str] = []
    with open(filename) as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if not line:
                continue
            if line.startswith(">"):
                if header is not None:
                    yield header, "".join(chunks)
                header = line[1:].strip()
                chunks = []
            else:
                chunks.append(line.strip())
    if header is not None:
        yield header, "".join(chunks)


def write_fasta(records: Iterator[Tuple[str, str]], filename: str) -> None:
    with open(filename, "w") as f:
        for header, seq in records:
            f.write(f">{header}\n{seq}\n")


def write_phylip(records: List[Tuple[str, str]], filename: str) -> None:
    """Relaxed PHYLIP with the reference's exact formatting
    (``alignment.cpp:86-125``): header "\\t<count>\\t<width>", 250-char padded
    labels, 10-char sequence chunks joined by single spaces (no trailing space
    on the final short chunk)."""
    label_width = 250
    with open(filename, "w") as f:
        width = len(records[0][1]) if records else 0
        f.write(f"\t{len(records)}\t{width}\n")
        for header, seq in records:
            f.write(header)
            f.write(" " * max(0, label_width - len(header)))
            pos = 0
            while pos < len(seq):
                remained = len(seq) - pos
                if remained > 10:
                    f.write(seq[pos:pos + 10] + " ")
                    pos += 10
                else:
                    f.write(seq[pos:])
                    pos += remained
            f.write("\n")


class Alignment:
    """A uniform-width set of sequences (``alignment.cpp:21-30``)."""

    def __init__(self, headers: List[str], sequences: List[str]):
        if not sequences:
            raise RuntimeError("The alignment is empty.")
        self.headers = list(headers)
        self.sequences = list(sequences)

    @property
    def width(self) -> int:
        return len(self.sequences[0])

    @property
    def height(self) -> int:
        return len(self.sequences)

    def records(self) -> List[Tuple[str, str]]:
        return list(zip(self.headers, self.sequences))

    def validate(self) -> None:
        """Equal-length check (``alignment.cpp:189-204``). Per-state validation
        is written-but-disabled in the reference (``alignment.cpp:236-243``);
        we match its effective behavior and skip it too."""
        w = self.width
        for header, seq in zip(self.headers, self.sequences):
            if len(seq) != w:
                raise RuntimeError(
                    "Error: Sequences in the input alignment do not have same "
                    f"number of sites. {header} is {len(seq)}bp in length, "
                    f"while {self.headers[0]} is {w}bp in length.")

    def as_bytes(self) -> np.ndarray:
        """Dense [height, width] uint8 view for vectorized preprocessing."""
        return np.frombuffer(
            "".join(self.sequences).encode("ascii"), dtype=np.uint8
        ).reshape(self.height, self.width)


def load_alignment(filename: str) -> Alignment:
    headers, seqs = [], []
    for header, seq in read_fasta(filename):
        headers.append(header)
        seqs.append(seq)
    return Alignment(headers, seqs)


def calculate_gap_ratio(align: Alignment, traits: SeqTraits = DNA) -> np.ndarray:
    """Per-column gap fraction (``alignment.cpp:139-160``), vectorized."""
    data = align.as_bytes()
    gap_lut = traits.gap_lut()
    return gap_lut[data].sum(axis=0, dtype=np.float64) / float(align.height)


def reduce_alignment(align: Alignment, reduction_ratio: float,
                     traits: SeqTraits = DNA) -> Alignment:
    """Drop columns with gap fraction >= reduction_ratio
    (``alignment.cpp:162-187``)."""
    ratios = calculate_gap_ratio(align, traits)
    keep = ratios < reduction_ratio
    data = align.as_bytes()[:, keep]
    seqs = [row.tobytes().decode("ascii") for row in data]
    return Alignment(align.headers, seqs)


def save_alignment(align: Alignment, filename: str, fmt: str = "fasta") -> None:
    if fmt == "fasta":
        write_fasta(iter(align.records()), filename)
    elif fmt == "phylip":
        write_phylip(align.records(), filename)
    else:
        raise ValueError(f"Unknown alignment format: {fmt}")


def convert_uo(align: Alignment) -> Alignment:
    """Convert U, O amino acids to C, L (``--convert-uo``, ``ipk.py:122-124``;
    the reference wrapper accepts the flag but never forwards it — here it is
    actually implemented)."""
    table = str.maketrans("UuOo", "CcLl")
    return Alignment(align.headers, [s.translate(table)
                                     for s in align.sequences])


def preprocess_alignment(working_dir: str, alignment_file: str,
                         reduction_ratio: float, no_reduction: bool,
                         traits: SeqTraits = DNA, verbose: int = 1,
                         convert_uo_flag: bool = False,
                         write_reduction: str = "") -> Alignment:
    """Load → validate → (reduce + save) (``alignment.cpp:245-293``).

    write_reduction: optional extra path to save the reduced alignment to
    (``--write-reduction``, ``ipk.py:102-104``; dead in the reference wrapper,
    implemented here).
    """
    os.makedirs(working_dir, exist_ok=True)
    if verbose > 0:
        print(f"Loading the reference alignment: {alignment_file}")
    align = load_alignment(alignment_file)
    if convert_uo_flag:
        align = convert_uo(align)
    align.validate()
    if not no_reduction:
        align = reduce_alignment(align, reduction_ratio, traits)
        align.validate()
        save_alignment(align, os.path.join(working_dir, "align.reduced.fasta"))
        if write_reduction:
            save_alignment(align, write_reduction)
    if verbose > 0:
        print(f"Loaded and filtered {align.height} sequences.\n")
    return align


def extend_alignment(align: Alignment, extended_tree: PhyloTree,
                     traits: SeqTraits = DNA) -> Alignment:
    """Append all-gap rows for extended-tree leaves absent from the alignment
    (ghost leaves X2/X3), in tree postorder (``alignment.cpp:302-318``)."""
    present = set(align.headers)
    headers = list(align.headers)
    seqs = list(align.sequences)
    empty = traits.get_gap() * align.width
    for node in postorder(extended_tree.root):
        if node.is_leaf() and node.label not in present:
            headers.append(node.label)
            seqs.append(empty)
    return Alignment(headers, seqs)
