"""Rooted phylogenetic trees, newick IO, ghost-node extension, rerooting.

The port's own copy of ``ipk_tpu/tree.py``: only its imports differ,
so numerics, ordering, formats and messages stay those of the reference.

Host-side counterpart of ``i2l::phylo_tree`` (contract inferred from IPK call
sites, SURVEY.md §2.2) plus the IPK tree-extension layer
(``ipk/src/extended_tree.cpp``). Trees are small host objects; the TPU pipeline
only consumes flat arrays derived from them (ghost grouping vectors, branch
ids, tree index).

Semantics replicated exactly (SURVEY.md §7.1 invariants #3, #4, #8):

* Ghost insertion: every non-root edge parent→node is split into
  ``parent—X0—{X1(+X2,X3), node}``; X0 gets half the original branch length,
  X1 the residual (leaf) or a mean-subtree-path formula, X2/X3 get 0.01
  (``extended_tree.cpp:35-73,103-149``).
* Ghost names ``"<counter>_X0"`` … with counter starting at node_count+1,
  assigned in postorder over non-root nodes (``extended_tree.cpp:79-82``).
* ``ghost_mapping``: X0/X1 label → postorder id of the original node
  (``extended_tree.cpp:144-148``).
* Rerooting of a trifurcation ``(a,b,c);`` → ``((b,c),a)added_root;``
  (``extended_tree.cpp:186-205``).
* Tree index entries {num_nodes, subtree_branch_length} in postorder
  (``db_builder.cpp:191-197``).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

__all__ = [
    "PhyloNode",
    "PhyloTree",
    "parse_newick",
    "load_newick",
    "to_newick",
    "save_tree",
    "extend_tree",
    "preprocess_tree",
    "reroot_tree",
]


class PhyloNode:
    """A tree node with parent/children pointers and pre/postorder ids."""

    __slots__ = ("label", "branch_length", "parent", "children",
                 "postorder_id", "preorder_id", "_num_leaves", "_num_nodes")

    def __init__(self, label: str = "", branch_length: float = 0.0,
                 parent: Optional["PhyloNode"] = None):
        self.label = label
        self.branch_length = branch_length
        self.parent = parent
        self.children: List[PhyloNode] = []
        self.postorder_id = -1
        self.preorder_id = -1
        self._num_leaves = 0
        self._num_nodes = 0

    # -- structure ----------------------------------------------------------
    def add_child(self, child: "PhyloNode") -> None:
        child.parent = self
        self.children.append(child)

    def remove_child(self, child: "PhyloNode") -> None:
        self.children.remove(child)
        child.parent = None

    def is_leaf(self) -> bool:
        return not self.children

    def is_root(self) -> bool:
        return self.parent is None

    # -- cached subtree stats (filled by PhyloTree.index) -------------------
    @property
    def num_leaves(self) -> int:
        return self._num_leaves

    @property
    def num_nodes(self) -> int:
        return self._num_nodes

    def subtree_branch_length(self) -> float:
        """Sum of branch lengths of all strict descendants."""
        total = 0.0
        for node in postorder(self):
            if node is not self:
                total += node.branch_length
        return total

    def __repr__(self) -> str:  # pragma: no cover
        return f"PhyloNode({self.label!r}, bl={self.branch_length}, post={self.postorder_id})"


def postorder(root: PhyloNode) -> Iterator[PhyloNode]:
    """Iterative postorder traversal, children in stored order.

    Matches ``i2l::visit_subtree`` default const postorder iteration
    (SURVEY.md §2.2 phylo_tree row).
    """
    stack: List[Tuple[PhyloNode, bool]] = [(root, False)]
    while stack:
        node, expanded = stack.pop()
        if expanded:
            yield node
        else:
            stack.append((node, True))
            for child in reversed(node.children):
                stack.append((child, False))


def preorder(root: PhyloNode) -> Iterator[PhyloNode]:
    stack = [root]
    while stack:
        node = stack.pop()
        yield node
        for child in reversed(node.children):
            stack.append(child)


class PhyloTree:
    """Rooted tree with postorder/preorder indexing."""

    def __init__(self, root: PhyloNode):
        self.root = root
        self._by_postorder: List[PhyloNode] = []
        self.index()

    # -- indexing -----------------------------------------------------------
    def index(self) -> None:
        """(Re)assign postorder/preorder ids and subtree stats.

        Mirrors ``phylo_tree::index()`` (used at ``extended_tree.cpp:95``,
        ``extended_tree.cpp:203``).
        """
        self._by_postorder = list(postorder(self.root))
        for i, node in enumerate(self._by_postorder):
            node.postorder_id = i
            if node.is_leaf():
                node._num_leaves = 1
                node._num_nodes = 1
            else:
                node._num_leaves = sum(c._num_leaves for c in node.children)
                node._num_nodes = 1 + sum(c._num_nodes for c in node.children)
        for i, node in enumerate(preorder(self.root)):
            node.preorder_id = i

    def get_node_count(self) -> int:
        return len(self._by_postorder)

    def get_by_postorder_id(self, pid: int) -> Optional[PhyloNode]:
        if 0 <= pid < len(self._by_postorder):
            return self._by_postorder[pid]
        return None

    def get_by_label(self, label: str) -> Optional[PhyloNode]:
        # lazy O(1) index, rebuilt whenever index() re-ran (thousand-branch
        # trees call this in loops during ghost grouping / node mapping)
        cache = getattr(self, "_label_cache", None)
        if cache is None or cache[0] is not self._by_postorder:
            index = {}
            for node in self._by_postorder:
                if node.label and node.label not in index:
                    index[node.label] = node
            cache = (self._by_postorder, index)
            self._label_cache = cache
        return cache[1].get(label)

    def nodes_postorder(self) -> List[PhyloNode]:
        return list(self._by_postorder)

    def is_rooted(self) -> bool:
        """Rooted = the root is strictly bifurcating (a trifurcation at the
        root is the conventional unrooted-newick representation,
        cf. ``extended_tree.cpp:169-205``)."""
        return len(self.root.children) < 3

    def copy(self) -> "PhyloTree":
        def clone(node: PhyloNode) -> PhyloNode:
            c = PhyloNode(node.label, node.branch_length)
            c.postorder_id = node.postorder_id
            c.preorder_id = node.preorder_id
            for child in node.children:
                cc = clone(child)
                cc.parent = c
                c.children.append(cc)
            return c

        new = PhyloTree.__new__(PhyloTree)
        new.root = clone(self.root)
        # Deliberately do NOT reindex: the reference copies then mutates with
        # stale ids before the final index() (``extended_tree.cpp:86-121``).
        new._by_postorder = list(postorder(new.root))
        return new

    def set_root(self, node: PhyloNode) -> None:
        self.root = node

    def tree_index(self) -> List[Tuple[int, float]]:
        """Per-node {num_nodes, subtree_branch_length} in postorder —
        the EPIK placement index (``db_builder.cpp:191-197``)."""
        out = []
        for node in self._by_postorder:
            out.append((node.num_nodes, node.subtree_branch_length()))
        return out


# ---------------------------------------------------------------------------
# Newick IO
# ---------------------------------------------------------------------------

def _format_branch_length(value: float) -> str:
    """Stable shortest-roundtrip float formatting for newick output."""
    text = repr(float(value))
    if text.endswith(".0"):
        text = text[:-2]
    return text


def parse_newick(text: str) -> PhyloTree:
    """Parse a newick string (labels, branch lengths, quoted labels).

    Counterpart of ``i2l::io::parse_newick`` (used at ``dump.cpp:19``).
    """
    s = text.strip()
    if not s.endswith(";"):
        raise ValueError("Invalid newick: missing terminating ';'")
    s = s[:-1]
    pos = 0
    n = len(s)

    def parse_label_and_length(node: PhyloNode) -> None:
        nonlocal pos
        # label (possibly quoted)
        if pos < n and s[pos] == "'":
            end = s.index("'", pos + 1)
            node.label = s[pos + 1:end]
            pos = end + 1
        else:
            start = pos
            while pos < n and s[pos] not in ",():;":
                pos += 1
            node.label = s[start:pos].strip()
        if pos < n and s[pos] == ":":
            pos += 1
            start = pos
            while pos < n and s[pos] not in ",()":
                pos += 1
            node.branch_length = float(s[start:pos])

    def parse_clade() -> PhyloNode:
        nonlocal pos
        node = PhyloNode()
        if pos < n and s[pos] == "(":
            pos += 1
            while True:
                child = parse_clade()
                child.parent = node
                node.children.append(child)
                if pos >= n:
                    raise ValueError("Invalid newick: unbalanced parentheses")
                if s[pos] == ",":
                    pos += 1
                    continue
                if s[pos] == ")":
                    pos += 1
                    break
        parse_label_and_length(node)
        return node

    root = parse_clade()
    if pos != n:
        raise ValueError(f"Invalid newick: trailing characters at {pos}: {s[pos:]!r}")
    return PhyloTree(root)


def load_newick(filename: str) -> PhyloTree:
    with open(filename) as f:
        return parse_newick(f.read())


def to_newick(tree: PhyloTree, with_branch_lengths: bool = True) -> str:
    """Serialize to newick (counterpart of ``i2l::io::to_newick``,
    used for the DB-embedded tree string at ``db_builder.cpp:174``)."""
    parts: List[str] = []

    def write(node: PhyloNode) -> None:
        if node.children:
            parts.append("(")
            for i, child in enumerate(node.children):
                if i:
                    parts.append(",")
                write(child)
            parts.append(")")
        if node.label:
            parts.append(node.label)
        if with_branch_lengths and node.parent is not None:
            parts.append(":" + _format_branch_length(node.branch_length))

    write(tree.root)
    parts.append(";")
    return "".join(parts)


def save_tree(tree: PhyloTree, filename: str) -> None:
    with open(filename, "w") as f:
        f.write(to_newick(tree) + "\n")


# ---------------------------------------------------------------------------
# Tree extension (ghost nodes)
# ---------------------------------------------------------------------------

GhostMapping = Dict[str, int]


def _total_branch_length(node: PhyloNode) -> float:
    """Leaf-path-weighted subtree length (``extended_tree.cpp:7-32``):
    sum over subtree nodes of bl (leaf) or num_leaves*bl (inner), minus the
    root-of-subtree's own num_leaves*bl contribution."""
    if node.is_leaf():
        return 0.0
    length = 0.0
    for sub in postorder(node):
        if sub.is_leaf():
            length += sub.branch_length
        else:
            length += sub.num_leaves * sub.branch_length
    length -= node.num_leaves * node.branch_length
    return length


def _calc_ghost_branch_lengths(original_node: PhyloNode) -> Tuple[float, float]:
    """Branch lengths for (X0→parent, X1→X0) (``extended_tree.cpp:35-73``)."""
    old = original_node.branch_length
    x0 = old / 2.0
    residual = old - x0
    if original_node.is_leaf():
        x1 = residual
    else:
        total = _total_branch_length(original_node)
        x1 = (total + residual * original_node.num_leaves) / original_node.num_leaves
    return x0, x1


def extend_tree(tree: PhyloTree) -> Tuple[PhyloTree, GhostMapping]:
    """Insert ghost nodes on every non-root edge (``extended_tree.cpp:86-161``).

    Returns the extended tree (reindexed) and the mapping
    ghost label (X0/X1) → original postorder id.
    """
    extended = tree.copy()
    counter = tree.get_node_count() + 1
    mapping: GhostMapping = {}

    def extend_subtree(node: PhyloNode) -> None:
        nonlocal counter
        for child in list(node.children):
            extend_subtree(child)
        if node.parent is None:
            return
        parent = node.parent
        # postorder ids on the copy are still the ORIGINAL ids at this point
        original_node = tree.get_by_postorder_id(node.postorder_id)
        x0_length, x1_length = _calc_ghost_branch_lengths(original_node)

        x0_name = f"{counter}_X0"
        counter += 1
        x0 = PhyloNode(x0_name, x0_length)
        # remove-then-append preserves overall child order because every
        # sibling is processed in sequence (``extended_tree.cpp:126-129``)
        parent.children.remove(node)
        parent.add_child(x0)

        x1_name = f"{counter}_X1"
        counter += 1
        x1 = PhyloNode(x1_name, x1_length)
        x0.add_child(x1)
        node.parent = x0
        x0.children.append(node)
        node.branch_length = node.branch_length - x0_length

        x2 = PhyloNode(f"{counter}_X2", 0.01)
        counter += 1
        x3 = PhyloNode(f"{counter}_X3", 0.01)
        counter += 1
        x1.add_child(x2)
        x1.add_child(x3)

        mapping[x0_name] = node.postorder_id
        mapping[x1_name] = node.postorder_id

    extend_subtree(extended.root)
    extended.index()
    return extended, mapping


def preprocess_tree(filename: str, use_unrooted: bool = False
                    ) -> Tuple[PhyloTree, PhyloTree, GhostMapping]:
    """Load + extend (``extended_tree.cpp:164-184``).

    Returns (original_tree, extended_tree, ghost_mapping).
    """
    tree = load_newick(filename)
    if not tree.is_rooted() and not use_unrooted:
        raise RuntimeError(
            "This reference tree is not rooted. Please provide a rooted tree "
            "or pass --use-unrooted. WARNING: this may impact placement accuracy.")
    extended, mapping = extend_tree(tree)
    original = load_newick(filename)
    return original, extended, mapping


def reroot_tree(tree: PhyloTree) -> None:
    """Resolve a root trifurcation: ``(a,b,c);`` → ``((b,c),a)added_root;``
    (``extended_tree.cpp:186-205``). In-place; reindexes."""
    root = tree.root
    if len(root.children) > 2:
        a = root.children[0]
        new_root = PhyloNode("added_root", 0.0)
        new_root.add_child(root)
        root.children.remove(a)
        new_root.add_child(a)
        tree.set_root(new_root)
        tree.index()
