"""In-memory phylo-k-mer database container.

The port's own copy of ``ipk_tpu/db.py``: only its imports differ,
so numerics, ordering, formats and messages stay those of the reference.

Counterpart of ``i2l::phylo_kmer_db`` (contract inferred from IPK call sites,
SURVEY.md §2.2). Unlike the reference's hash map + kmer_order vector, this is
array-backed (struct-of-arrays) because the TPU builder produces the database
as flat sorted arrays in one shot; a key→row dict is built lazily for
``search``.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["PhyloKmerDB", "PROTOCOL_VERSION"]

#: Serialization protocol version of this framework. The reference's v0.5.x
#: protocol ("sorted by MI", CHANGELOG v0.5.0/v0.5.1) is the semantic model;
#: the exact i2l byte layout is unrecoverable from the reference snapshot
#: (SURVEY.md gap G1), so this framework versions its own layout starting at 1.
PROTOCOL_VERSION = 1


class PhyloKmerDB:
    """Array-backed phylo-k-mer DB, rows in serialization (filter) order.

    Attributes
    ----------
    keys : uint64 [K] packed k-mer keys
    filter_values : float32 [K]
    offsets : int64 [K+1] entry-range per key
    branches : uint32 [E] original-tree postorder ids
    scores : float32 [E] log10 scores
    positions : optional uint32 [E] (aa-pos variant, ``branch_group.h:13-24``)
    tree_index : [(num_nodes, subtree_branch_length)] per node, postorder
    """

    def __init__(self, kmer_size: int, omega: float, sequence_type: str,
                 tree: str, tree_index=None, version: int = PROTOCOL_VERSION):
        self.kmer_size = int(kmer_size)
        self.omega = float(omega)
        self.sequence_type = sequence_type
        self.tree = tree
        self.tree_index = list(tree_index or [])
        self.version = version
        self.keys = np.zeros(0, dtype=np.uint64)
        self.filter_values = np.zeros(0, dtype=np.float32)
        self.offsets = np.zeros(1, dtype=np.int64)
        self.branches = np.zeros(0, dtype=np.uint32)
        self.scores = np.zeros(0, dtype=np.float32)
        self.positions: Optional[np.ndarray] = None
        self._row_by_key = None

    # -- construction -------------------------------------------------------
    def set_data(self, keys, filter_values, offsets, branches, scores,
                 positions=None) -> None:
        self.keys = np.asarray(keys, dtype=np.uint64)
        self.filter_values = np.asarray(filter_values, dtype=np.float32)
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.branches = np.asarray(branches, dtype=np.uint32)
        self.scores = np.asarray(scores, dtype=np.float32)
        self.positions = (None if positions is None
                          else np.asarray(positions, dtype=np.uint32))
        self._row_by_key = None
        assert len(self.offsets) == len(self.keys) + 1

    def set_data_mapped(self, keys, filter_values, offsets, branches, scores,
                        positions=None) -> None:
        """Adopt column views without copying (``serialize.load(mmap=True)``
        hands np.memmap columns so DBs larger than RAM can be served)."""
        self.keys = keys
        self.filter_values = filter_values
        self.offsets = offsets
        self.branches = branches
        self.scores = scores
        self.positions = positions
        self._row_by_key = None
        assert len(self.offsets) == len(self.keys) + 1

    # -- queries ------------------------------------------------------------
    def size(self) -> int:
        """Number of distinct k-mers (``phylo_kmer_db::size``)."""
        return len(self.keys)

    def num_entries(self) -> int:
        """Total (k-mer, branch) pairs (``i2l::get_num_entries``)."""
        return len(self.branches)

    def entries_at(self, row: int):
        lo, hi = self.offsets[row], self.offsets[row + 1]
        if self.positions is not None:
            return list(zip(self.branches[lo:hi].tolist(),
                            self.scores[lo:hi].tolist(),
                            self.positions[lo:hi].tolist()))
        return list(zip(self.branches[lo:hi].tolist(),
                        self.scores[lo:hi].tolist()))

    def search(self, key: int):
        """entries for a key or None (``phylo_kmer_db::search``)."""
        if self._row_by_key is None:
            self._row_by_key = {int(k): i for i, k in enumerate(self.keys)}
        row = self._row_by_key.get(int(key))
        return None if row is None else self.entries_at(row)

    def __iter__(self) -> Iterator[Tuple[int, list]]:
        for row in range(len(self.keys)):
            yield int(self.keys[row]), self.entries_at(row)

    def __len__(self) -> int:
        return len(self.keys)
