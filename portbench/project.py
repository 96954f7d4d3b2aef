"""Seeded synthetic IPK projects: a rooted tree, a reference alignment and a
replayable ``--ar-dir`` (raxml-ng's ``.raxml.ancestralTree`` and
``.raxml.ancestralProbs`` for the tree that IPK extends with ghost nodes).

The law, all from ``--seed`` (the configuration's ``model`` gives its
numbers):

* the tree: a random rooted binary topology (the joins of
  ``chip_smoke.random_tree_newick``) with branch lengths drawn from an
  exponential law (``branch_length_mean`` substitutions a site);
* the alignment: sequences evolved from the root down that tree under GTR
  (``exchangeabilities``, ``frequencies``) with discrete-gamma rates across
  sites (``gamma_alpha``, ``gamma_categories``, each site's category drawn
  uniformly); the leaves are the reference alignment, gap-free;
* the posteriors: the exact marginal ancestral posteriors of every inner
  node of IPK's extended tree (ghost branch lengths as
  ``extended_tree.cpp:35-73`` sets them; the ghost leaves X2 and X3 carry no
  data) under the same model, summed over the rate categories: what a
  marginal reconstruction writes when it knows the true model.

So the posteriors are peaked where the tree is sure of a state and spread
where it is not, and correlated along the tree, as a real reconstruction's.
The posteriors are rounded to the 9 decimals the file holds before they are
written, and each node block is formatted in whole arrays.

``make_project`` returns the posteriors as written (float64, each the
decimal in the file), so the plain reference reads exactly what the program
parses, without parsing text.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import numpy as np

DNA_LETTERS = "ACGT"


class Node:
    __slots__ = ("label", "length", "children")

    def __init__(self, label: str = "", length: float = 0.0,
                 children: Optional[List["Node"]] = None):
        self.label = label
        self.length = length
        self.children = children or []


def postorder(root: Node):
    stack = [(root, False)]
    while stack:
        node, expanded = stack.pop()
        if expanded:
            yield node
        else:
            stack.append((node, True))
            for child in reversed(node.children):
                stack.append((child, False))


def _length_text(value: float) -> str:
    text = repr(float(value))
    return text[:-2] if text.endswith(".0") else text


def to_newick(root: Node) -> str:
    parts: List[str] = []

    def write(node: Node, is_root: bool) -> None:
        if node.children:
            parts.append("(")
            for i, child in enumerate(node.children):
                if i:
                    parts.append(",")
                write(child, False)
            parts.append(")")
        parts.append(node.label)
        if not is_root:
            parts.append(":" + _length_text(node.length))

    write(root, True)
    return "".join(parts) + ";"


def random_tree(rng: np.random.Generator, num_leaves: int,
                branch_length_mean: float) -> str:
    """A random rooted binary tree with leaves L0..L{n-1}, as newick: the
    joins of ``chip_smoke.random_tree_newick``, each branch length drawn
    from an exponential law of the given mean, written with 6 decimals."""
    nodes = [f"L{i}:{rng.exponential(branch_length_mean):.6f}"
             for i in range(num_leaves)]
    while len(nodes) > 1:
        a = nodes.pop(rng.integers(0, len(nodes)))
        b = nodes.pop(rng.integers(0, len(nodes)))
        nodes.append(f"({a},{b}):{rng.exponential(branch_length_mean):.6f}")
    return nodes[0].rsplit(":", 1)[0] + "root;"


def parse_newick(text: str) -> Node:
    """The trees this module writes: nested clades, labels, lengths."""
    text = text.strip().rstrip(";")
    pos = 0

    def clade() -> Node:
        nonlocal pos
        node = Node()
        if text[pos] == "(":
            pos += 1
            node.children.append(clade())
            while text[pos] == ",":
                pos += 1
                node.children.append(clade())
            if text[pos] != ")":
                raise ValueError(f"newick: ')' expected at {pos}")
            pos += 1
        start = pos
        while pos < len(text) and text[pos] not in ",():":
            pos += 1
        node.label = text[start:pos]
        if pos < len(text) and text[pos] == ":":
            pos += 1
            start = pos
            while pos < len(text) and text[pos] not in ",()":
                pos += 1
            node.length = float(text[start:pos])
        return node

    root = clade()
    if pos != len(text):
        raise ValueError(f"newick: trailing text at {pos}")
    return root


def extend(root: Node, node_count: int) -> Node:
    """IPK's extended tree (``extended_tree.cpp:86-161``): every non-root
    edge parent-v becomes parent-X0-v with X0 also holding X1, and X1
    holding the leaves X2 and X3; names count up from node_count + 1 in a
    postorder over the original nodes. X0 takes half of v's branch and v the
    rest; X1's branch is that rest for a leaf v, else the rest plus the mean
    path from v down to its leaves (``extended_tree.cpp:7-73``); X2 and X3
    take 0.01."""
    counter = node_count + 1

    def ext(node: Node, is_root: bool):
        """(extended subtree, leaves below, leaf-weighted length below)."""
        nonlocal counter
        got = [ext(child, False) for child in node.children]
        kids = [g[0] for g in got]
        leaves = sum(g[1] for g in got) if got else 1
        below = sum(g[2] + (c.length if not c.children else g[1] * c.length)
                    for c, g in zip(node.children, got))
        x0_len = node.length / 2.0
        rest = node.length - x0_len
        out = Node(node.label, node.length if is_root else rest, kids)
        if is_root:
            return out, leaves, below
        x1_len = rest if not node.children else (below + rest * leaves) / leaves
        x0, x1, x2, x3 = (f"{counter + i}_X{i}" for i in range(4))
        counter += 4
        ghost = Node(x1, x1_len, [Node(x2, 0.01), Node(x3, 0.01)])
        return Node(x0, x0_len, [ghost, out]), leaves, below

    return ext(root, True)[0]


class Model(NamedTuple):
    """GTR with discrete-gamma rates (``make_project``'s law)."""
    frequencies: np.ndarray      # [4] A, C, G, T
    eigvec: np.ndarray           # [4, 4] of the symmetrised generator
    eigval: np.ndarray           # [4]
    rates: np.ndarray            # [C] mean rate of each gamma category

    @classmethod
    def of(cls, spec: dict) -> "Model":
        """``spec``: ``exchangeabilities`` (AC, AG, AT, CG, CT, GT),
        ``frequencies`` (A, C, G, T), ``gamma_alpha``,
        ``gamma_categories``. The generator is scaled to one expected
        substitution a unit of branch length; each category's rate is the
        mean of its quantile slice of Gamma(alpha, alpha) (Yang 1994)."""
        from scipy.special import gammainc, gammaincinv
        pi = np.asarray(spec["frequencies"], dtype=np.float64)
        pi = pi / pi.sum()
        ex = np.zeros((4, 4))
        ex[np.triu_indices(4, 1)] = spec["exchangeabilities"]
        ex = ex + ex.T
        q = ex * pi[None, :]
        q[np.diag_indices(4)] = -q.sum(axis=1)
        q /= -(pi * np.diag(q)).sum()
        root = np.sqrt(pi)
        sym = root[:, None] * q / root[None, :]
        eigval, eigvec = np.linalg.eigh((sym + sym.T) / 2)
        alpha = float(spec["gamma_alpha"])
        n = int(spec["gamma_categories"])
        cuts = gammaincinv(alpha, np.arange(1, n) / n)
        upper = np.concatenate([gammainc(alpha + 1, cuts), [1.0]])
        rates = n * np.diff(np.concatenate([[0.0], upper]))
        return cls(pi, eigvec, eigval, rates)

    def transition(self, length: float) -> np.ndarray:
        """[C, 4, 4] P(x -> y) over ``length`` in each rate category."""
        root = np.sqrt(self.frequencies)
        e = np.exp(self.rates[:, None] * self.eigval[None, :] * length)
        p = np.einsum("xi,ci,yi->cxy", self.eigvec, e, self.eigvec)
        p = p / root[None, :, None] * root[None, None, :]
        return np.clip(p, 0.0, None)


def evolve(rng: np.random.Generator, root: Node, model: Model,
           width: int) -> dict:
    """{leaf label: [width] state codes}: the root drawn from the
    frequencies, each site's rate category uniformly, each child's state
    from its parent's through the branch's transition matrix."""
    cats = rng.integers(0, len(model.rates), size=width)
    leaves = {}
    stack = [(root, rng.choice(4, size=width, p=model.frequencies))]
    while stack:
        node, states = stack.pop()
        if not node.children:
            leaves[node.label] = states
        for child in node.children:
            p = model.transition(child.length)[cats, states]      # [S, 4]
            draw = rng.random(width)[:, None]
            nxt = np.minimum((np.cumsum(p, axis=1) < draw * p.sum(axis=1,
                             keepdims=True)).sum(axis=1), 3)
            stack.append((child, nxt))
    return leaves


def posteriors(ar_root: Node, model: Model, leaf_states: dict,
               width: int) -> np.ndarray:
    """[inner nodes in postorder, width, 4] marginal posteriors of each
    inner node of ``ar_root`` under ``model``, summed over the rate
    categories (each a priori 1/C); leaves not in ``leaf_states`` (the ghost
    leaves) carry no data. Partial likelihoods are rescaled at every node,
    the logs of the scales kept per category and site."""
    C = len(model.rates)
    inner = [n for n in postorder(ar_root) if n.children]
    index = {id(n): i for i, n in enumerate(inner)}
    down = {}          # id -> ([C, S, 4] partials, [C, S] log scale)

    def message(child: Node):
        """([C, S, 4] sum_y P(x -> y) L_child(y), its log scale), or None
        for a leaf without data."""
        p = model.transition(child.length)
        if child.children:
            part, scale = down[id(child)]
            return part @ p.transpose(0, 2, 1), scale
        states = leaf_states.get(child.label)
        if states is None:
            return None
        return np.transpose(p[:, :, states], (0, 2, 1)), 0.0

    for node in inner:
        part = np.ones((C, width, 4))
        scale = np.zeros((C, width))
        for child in node.children:
            m = message(child)
            if m is not None:
                part = part * m[0]
                scale = scale + m[1]
        top = np.maximum(part.max(axis=2), np.finfo(np.float64).tiny)
        down[id(node)] = (part / top[..., None], scale + np.log(top))

    out = np.empty((len(inner), width, 4))
    up = {id(ar_root): (np.broadcast_to(model.frequencies, (C, width, 4)),
                        np.zeros((C, width)))}
    stack = [ar_root]
    while stack:
        node = stack.pop()
        u, u_scale = up.pop(id(node))
        part, d_scale = down.pop(id(node))
        joint = part * u
        total = joint.sum(axis=2)                               # [C, S]
        log_w = d_scale + u_scale + np.log(total)
        w = np.exp(log_w - log_w.max(axis=0, keepdims=True))
        w /= w.sum(axis=0, keepdims=True)
        out[index[id(node)]] = ((w / total)[..., None] * joint).sum(axis=0)
        msgs = [message(c) for c in node.children]
        for j, child in enumerate(node.children):
            if not child.children:
                continue
            o, o_scale = u, u_scale
            for i, m in enumerate(msgs):
                if i != j and m is not None:
                    o = o * m[0]
                    o_scale = o_scale + m[1]
            nu = o @ model.transition(child.length)
            top = np.maximum(nu.max(axis=2), np.finfo(np.float64).tiny)
            up[id(child)] = (nu / top[..., None], o_scale + np.log(top))
            stack.append(child)
    return out


class Project(NamedTuple):
    tree_file: str
    fasta_file: str
    ar_dir: str
    probs: np.ndarray     # [AR inner nodes in postorder, sites, 4] float64


def make_project(directory: str, num_leaves: int, width: int, seed: int,
                 model: dict) -> Project:
    """Write tree.newick, reference.fasta and ar_out/ under ``directory``
    from ``seed`` (any whole number) by the law in the module docstring;
    ``model`` holds ``branch_length_mean`` and ``Model.of``'s keys. The same
    seed and model write the same bytes."""
    rng = np.random.default_rng(seed % (1 << 64))
    os.makedirs(directory, exist_ok=True)
    newick = random_tree(rng, num_leaves, float(model["branch_length_mean"]))
    tree_file = os.path.join(directory, "tree.newick")
    with open(tree_file, "w") as f:
        f.write(newick + "\n")
    root = parse_newick(newick)
    law = Model.of(model)
    states = evolve(rng, root, law, width)
    leaves = [n.label for n in postorder(root) if not n.children]
    table = np.frombuffer(DNA_LETTERS.encode(), dtype=np.uint8)
    fasta_file = os.path.join(directory, "reference.fasta")
    with open(fasta_file, "w") as f:
        for label in leaves:
            f.write(f">{label}\n{table[states[label]].tobytes().decode()}\n")

    node_count = sum(1 for _ in postorder(root))
    ar_root = extend(root, node_count)
    probs = posteriors(ar_root, law, states, width)
    inner = [n for n in postorder(ar_root) if n.children]
    for i, node in enumerate(inner):
        node.label = f"Node{i}"
    ar_dir = os.path.join(directory, "ar_out")
    os.makedirs(ar_dir, exist_ok=True)
    with open(os.path.join(ar_dir, "align.raxml.ancestralTree"), "w") as f:
        f.write(to_newick(ar_root) + "\n")

    probs = np.rint(probs * 1e9) / 1e9
    with open(os.path.join(ar_dir, "align.raxml.ancestralProbs"), "wb") as f:
        f.write(("Node\tSite\tState\t" + "\t".join(
            f"p_{c}" for c in DNA_LETTERS) + "\n").encode())
        _write_blocks(f, probs)
    return Project(tree_file, fasta_file, ar_dir, probs)


def _digits(values: np.ndarray, n: int) -> np.ndarray:
    """The last n decimal digits of each whole number, as ASCII."""
    out = np.empty(values.shape + (n,), dtype=np.uint8)
    for j in range(n - 1, -1, -1):
        out[..., j] = 48 + values % 10
        values = values // 10
    return out


def _write_blocks(f, probs: np.ndarray) -> None:
    """raxml-ng's rows ``Node<i>\t<site>\t<state>\t<p_A>...\t<p_T>``, one
    block a node, each probability with 9 decimals: the bytes that
    ``"%.9f"`` gives, built as arrays of digits (the rows differ in width
    only by the digits of the node's number and of the site's)."""
    nodes, width, _ = probs.shape
    q = np.rint(probs * 1e9).astype(np.int64)
    tail = np.empty((nodes, width, 50), dtype=np.uint8)
    tail[..., 0] = np.frombuffer(DNA_LETTERS.encode(), np.uint8)[
        probs.argmax(axis=2)]
    for c in range(4):
        base = 1 + 12 * c
        tail[..., base] = 9
        tail[..., base + 1] = 48 + q[..., c] // 1_000_000_000
        tail[..., base + 2] = 46
        tail[..., base + 3:base + 12] = _digits(q[..., c] % 1_000_000_000, 9)
    tail[..., 49] = 10
    sites = np.arange(1, width + 1)
    node_ids = np.arange(nodes)
    spans = [(lo, min(hi, width + 1), d) for d, (lo, hi) in enumerate(
        [(1, 10), (10, 100), (100, 1000), (1000, 10000), (10000, 100000)],
        start=1) if lo <= width]
    blocks = {}
    for lw in range(1, len(str(max(nodes - 1, 0))) + 1):
        ids = node_ids[(node_ids >= (10 ** (lw - 1) if lw > 1 else 0))
                       & (node_ids < 10 ** lw)]
        for lo, hi, d in spans:
            rows = hi - lo
            head = np.empty((len(ids), rows, 4 + lw + 1 + d + 1), np.uint8)
            head[..., :4] = np.frombuffer(b"Node", np.uint8)
            head[..., 4:4 + lw] = _digits(ids, lw)[:, None, :]
            head[..., 4 + lw] = 9
            head[..., 5 + lw:5 + lw + d] = _digits(sites[lo - 1:hi - 1], d)
            head[..., 5 + lw + d] = 9
            full = np.concatenate(
                [head, tail[ids, lo - 1:hi - 1]], axis=2)
            for j, i in enumerate(ids):
                blocks[(int(i), lo)] = full[j]
    for i in range(nodes):
        for lo, _, _ in spans:
            f.write(blocks.pop((i, lo)).tobytes())


