"""Extended-tree ↔ AR-tree node mapping and ghost tensor assembly.

The port's own copy of ``ipk_tpu/ar/mapping.py``: only its imports differ,
so numerics, ordering, formats and messages stay those of the reference.

* :func:`map_nodes` replicates ``ar::map_nodes`` (``ipk/src/ar.cpp:790-834``):
  simultaneous postorder traversal of the extended tree and the AR tree,
  mapping every *labeled* extended node to the AR node at the same postorder
  position (unlabeled inner nodes are skipped in both).
* :func:`ghost_groups` replicates the grouping of ghost nodes by original
  postorder id with root exclusion and the exact group order — order of first
  ghost occurrence in extended-tree postorder (``db_builder.cpp:495-553``).
* :func:`gather_ghost_tensor` assembles the dense [G, S, σ] input of the
  enumeration kernel from the parsed AR posteriors, with ghosts of a group
  adjacent (group-major), replacing the reference's lazy per-node loads
  (``proba_matrix.cpp:31-40``, ``db_builder.cpp:555-574``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..tree import PhyloTree, postorder

__all__ = ["map_nodes", "ghost_groups", "gather_ghost_tensor", "is_ghost"]


def map_nodes(extended_tree: PhyloTree, ar_tree: PhyloTree) -> Dict[str, str]:
    """extended label -> AR label by simultaneous postorder (``ar.cpp:790-834``)."""
    if extended_tree.get_node_count() != ar_tree.get_node_count():
        raise RuntimeError(
            "Error during database construction: extended tree and AR differ "
            f"in the number of nodes: {extended_tree.get_node_count()} vs. "
            f"{ar_tree.get_node_count()}")
    mapping: Dict[str, str] = {}
    for ext_node, ar_node in zip(postorder(extended_tree.root),
                                 postorder(ar_tree.root)):
        if not ext_node.label:
            continue
        mapping[ext_node.label] = ar_node.label
    return mapping


def is_ghost(label: str, strategy: str = "both") -> bool:
    """Ghost-node detection by label suffix, filtered by strategy
    (``db_builder.cpp:495-507``)."""
    if strategy == "inner-only":
        return label.endswith("_X0")
    if strategy == "outer-only":
        return label.endswith("_X1")
    return label.endswith("_X0") or label.endswith("_X1")


def ghost_groups(extended_tree: PhyloTree, original_tree: PhyloTree,
                 ghost_mapping: Dict[str, int], strategy: str = "both",
                 ) -> Tuple[List[List[str]], List[int]]:
    """Group ghost labels by original postorder id.

    Returns (groups, group_postorder_ids). Order = first-ghost occurrence in
    extended-tree postorder; the root's edge is excluded
    (``db_builder.cpp:510-553``). For strategy "both" each group is
    [X1-label, X0-label] in extended-postorder order (X1 is visited first).
    """
    ghost_ids = [n.label for n in postorder(extended_tree.root)
                 if is_ghost(n.label, strategy)]
    groups: List[List[str]] = []
    ids: List[int] = []
    index: Dict[int, int] = {}
    root_pid = original_tree.root.postorder_id
    for label in ghost_ids:
        pid = ghost_mapping[label]
        if pid == root_pid:
            continue
        if pid in index:
            groups[index[pid]].append(label)
        else:
            index[pid] = len(groups)
            groups.append([label])
            ids.append(pid)
    return groups, ids


def gather_ghost_tensor(groups: List[List[str]],
                        ar_mapping: Dict[str, str],
                        label_rows: Dict[str, int],
                        P: np.ndarray) -> np.ndarray:
    """Assemble P_all[G, S, σ] with ghosts of each group adjacent.

    groups must be uniform in size (true for every single strategy: 2 ghosts
    per group for "both", 1 otherwise). Raises if an AR label is missing,
    matching ``get_submatrices`` (``db_builder.cpp:555-574``).
    """
    sizes = {len(g) for g in groups}
    if len(sizes) > 1:
        raise RuntimeError(f"Non-uniform ghost groups: {sorted(sizes)}")
    rows = []
    for group in groups:
        for label in group:
            ar_label = ar_mapping[label]
            if ar_label not in label_rows:
                raise RuntimeError(
                    f"Internal error: could not find {ar_label} node. Make "
                    "sure it is in the ARTree_id_mapping file.")
            rows.append(label_rows[ar_label])
    return P[np.array(rows, dtype=np.int64)]
