"""Plain reference of an IPK database build, and a reader of ``.ipk`` files.

Works the database out again from the files a project holds, by IPK's
definitions (``db_builder.cpp``, ``filter.cpp``), with nothing of the
program under test: it imports only the standard library, NumPy, PyTorch
and this folder's ``project`` (for the newick parser).

* Ghosts: IPK puts two ghost nodes on every non-root edge parent-v of the
  reference tree, X0 (on the edge) and X1 (below X0, beside v). A branch's
  group is [X1(v), X0(v)]; groups are ordered by the first ghost met in a
  postorder of the extended tree, which is the preorder of v; the branch id
  written is v's postorder id in the original tree. The AR tree names its
  inner nodes Node0.. in postorder, so a ghost's posterior block is its
  place among the extended tree's inner nodes in postorder.
* Scores: a k-mer's score on a branch is the largest, over the branch's
  ghosts g and the windows w, of sum_i log10 P[g, w + i, letter_i], summed
  left to right; it is kept where it is above eps = float32(log10((omega /
  sigma)^k)). Keys pack the letters most significant first, 2 bits each.
* mif0 (float64): with lin = min(10^s, 1) over a key's kept entries, N the
  original tree's node count and thr = (omega / sigma)^k,
  S = sum lin + (N - n) thr, H = N sh(thr / S) + sum (sh(lin / S) -
  sh(thr / S)), fv = S (H - log2 N), sh(x) = -x log2 x. Rows are written in
  ascending (fv, key) order; a key's entries in group order.

The scores are computed for a given set of keys at once, in blocks of keys
so that the [ghosts, windows, keys] sums fit, on whatever device the
posteriors are on, in the dtype they are given in (float32 for the
reference, bfloat16 for the control).
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Dict, NamedTuple

import numpy as np
import torch

from portbench.project import parse_newick, postorder

SIGMA = 4
BITS = 2


class Layout(NamedTuple):
    branch_ids: np.ndarray   # [B] postorder id of each group's node, group order
    ghost_rows: np.ndarray   # [B, 2] AR inner-node index of X1(v), X0(v)
    num_nodes: int           # N: the original tree's node count


def layout(tree_text: str) -> Layout:
    """The ghost groups of the tree in ``tree_text`` (module docstring)."""
    root = parse_newick(tree_text)
    post_id = {id(node): i for i, node in enumerate(postorder(root))}
    inner = 0
    rows: Dict[int, list] = {}
    pre = []

    # the extended tree's postorder: X1(v)'s subtree (X2, X3, X1), then v's
    # subtree, then X0(v); only inner nodes take a Node<i> name
    stack = [(root, True, False)]
    while stack:
        node, is_root, after = stack.pop()
        if after:
            inner += 1 if node.children else 0
            if not is_root:
                rows[id(node)].append(inner)
                inner += 1
            continue
        if not is_root:
            pre.append(node)
            rows[id(node)] = [inner]
            inner += 1
        stack.append((node, is_root, True))
        for child in reversed(node.children):
            stack.append((child, False, False))
    return Layout(np.array([post_id[id(v)] for v in pre], dtype=np.int64),
                  np.array([rows[id(v)] for v in pre], dtype=np.int64),
                  len(post_id))


def eps_f32(omega: float, k: int) -> float:
    return float(np.float32(np.log10(threshold(omega, k))))


def threshold(omega: float, k: int) -> float:
    return float((np.float64(omega) / np.float64(SIGMA)) ** k)


def key_letters(keys: np.ndarray, k: int) -> np.ndarray:
    """[K, k] letter codes of each key, most significant first."""
    keys = np.asarray(keys, dtype=np.uint64)
    shifts = np.arange(k - 1, -1, -1, dtype=np.uint64) * np.uint64(BITS)
    return ((keys[:, None] >> shifts[None, :])
            & np.uint64(SIGMA - 1)).astype(np.int64)


def branch_scores(logp: torch.Tensor, lay: Layout, keys: np.ndarray, k: int,
                  block_bytes: int = 1 << 29) -> torch.Tensor:
    """[B, K] best score of each key on each branch, not thresholded (-inf
    where no window has all its letters possible). ``logp`` [AR inner
    nodes, sites, 4] holds log10 posteriors in the dtype to compute in."""
    dev = logp.device
    ghosts = logp[torch.as_tensor(lay.ghost_rows.reshape(-1), device=dev)]
    G, S, _ = ghosts.shape
    W = S - k + 1
    letters = torch.as_tensor(key_letters(keys, k), device=dev)
    K = letters.shape[0]
    per_key = G * W * ghosts.element_size()
    kb = max(1, min(K, block_bytes // per_key))
    out = torch.empty((G, K), dtype=logp.dtype, device=dev)
    for k0 in range(0, K, kb):
        idx = letters[k0:k0 + kb]
        acc = torch.index_select(ghosts[:, 0:W], 2, idx[:, 0])
        for i in range(1, k):
            acc += torch.index_select(ghosts[:, i:i + W], 2, idx[:, i])
        out[:, k0:k0 + kb] = acc.amax(dim=1)
        del acc
    return out.view(len(lay.branch_ids), 2, K).amax(dim=1)


def mif0(scores: torch.Tensor, eps: float, thr: float,
         num_nodes: int) -> torch.Tensor:
    """[K] float64 filter values of the kept entries of ``scores`` [B, K]."""
    s = scores.to(torch.float64)
    keep = s > eps
    lin = torch.where(keep, torch.clamp(torch.pow(10.0, s), max=1.0),
                      torch.zeros_like(s))
    n = keep.sum(dim=0).to(torch.float64)
    N = float(num_nodes)
    total = lin.sum(dim=0) + (N - n) * thr

    def sh(x):
        return -x * torch.log2(x)

    tt = sh(thr / total)
    tv = torch.where(keep, sh(lin / total), torch.zeros_like(s)).sum(dim=0)
    return total * (N * tt + (tv - n * tt) - math.log2(N))


class IpkFile(NamedTuple):
    kmer_size: int
    omega: float
    keys: np.ndarray        # [R] uint64, in file order
    fv: np.ndarray          # [R] float32
    counts: np.ndarray      # [R] uint64
    branches: np.ndarray    # [E] uint32
    scores: np.ndarray      # [E] float32


def read_ipk(path: str) -> IpkFile:
    """Read the program's ``.ipk`` layout (zlib or raw): a boost-style magic,
    u32 version, str sequence type, u64 n + n x (u64, f64) tree index, str
    newick, u64 k, f32 omega, u8 positions flag, u64 kmers, u64 entries,
    then the columns keys u64, fv f32, counts u64, branches u32, scores f32
    (and positions u32), little-endian."""
    with open(path, "rb") as f:
        raw = f.read()
    try:
        data = zlib.decompress(raw)
    except zlib.error:
        data = raw
    del raw
    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > len(data):
            raise ValueError(f"{path}: truncated at {pos}")
        pos += n
        return pos - n

    def u64():
        return struct.unpack_from("<Q", data, take(8))[0]

    def string():
        n = u64()
        return data[take(n):pos].decode()

    if data[take(8):pos] != struct.pack("<Q", 22) or \
            data[take(22):pos] != b"serialization::archive":
        raise ValueError(f"{path}: not an .ipk archive")
    take(2)
    take(4)
    string()
    take(16 * u64())
    string()
    k = u64()
    omega = struct.unpack_from("<f", data, take(4))[0]
    has_positions = data[take(1)]
    rows, entries = u64(), u64()

    def column(dtype, n):
        start = take(np.dtype(dtype).itemsize * n)
        return np.frombuffer(data, dtype=dtype, count=n, offset=start)

    keys = column("<u8", rows)
    fv = column("<f4", rows)
    counts = column("<u8", rows)
    branches = column("<u4", entries)
    scores = column("<f4", entries)
    if has_positions:
        column("<u4", entries)
    if pos != len(data):
        raise ValueError(f"{path}: {len(data) - pos} bytes after the columns")
    return IpkFile(int(k), float(omega), keys, fv, counts, branches, scores)
