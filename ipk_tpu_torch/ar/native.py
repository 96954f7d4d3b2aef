"""Native ancestral reconstruction on a torch device: the counterpart of
``ipk_tpu/ar/native.py`` (Felsenstein pruning and empirical-Bayes marginal
posteriors under GTR + Γ), selected with ``--ar native``.

It writes raxml-ng's ``.raxml.ancestralProbs`` / ``.raxml.ancestralTree``
formats under ``<workdir>/AR/``, so the rest of the pipeline, and an
``--ar-dir`` replay, read its output as they read raxml-ng's.

The numpy/scipy parts (``empirical_frequencies``, ``gtr_eigendecomposition``,
``gamma_category_rates``, ``_encode_leaves``) are copies of ``ipk_tpu``'s,
whose module imports jax. :func:`ancestral_posteriors` runs the same two
passes in float32 on the device: the same einsums, the same per-node
rescaling, and the same order of child and sibling products.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as device_mod
from ..alignment import Alignment
from ..seq import DNA, SeqTraits
from ..tree import PhyloNode, PhyloTree, postorder, to_newick
from .reader import RAXML_AA_ORDER, aa_permutation

__all__ = ["gtr_eigendecomposition", "gamma_category_rates",
           "ancestral_posteriors", "run_native_ar", "empirical_frequencies"]


def empirical_frequencies(align: Alignment, traits: SeqTraits) -> np.ndarray:
    """Empirical (counted) base frequencies — the reference's ``+FC``."""
    lut = traits.codes_lut()
    data = align.as_bytes()
    codes = lut[data]
    counts = np.bincount(codes[codes >= 0], minlength=traits.alphabet_size)
    counts = np.maximum(counts.astype(np.float64), 1.0)
    return counts / counts.sum()


def gtr_eigendecomposition(freqs: np.ndarray,
                           rates: Optional[np.ndarray] = None
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Eigendecomposition of the normalized GTR rate matrix.

    freqs: stationary frequencies π [σ]; rates: upper-triangle
    exchangeabilities (σ(σ-1)/2, row-major), default all ones.
    Returns (eigenvalues [σ], U [σ,σ], U_inv [σ,σ]) with
    Q = U diag(λ) U⁻¹ and Σ_i π_i Q_ii = -1 (expected one substitution per
    unit branch length).
    """
    sigma = len(freqs)
    if rates is None:
        rates = np.ones(sigma * (sigma - 1) // 2)
    R = np.zeros((sigma, sigma))
    iu = np.triu_indices(sigma, k=1)
    R[iu] = rates
    R = R + R.T
    Q = R * freqs[None, :]
    np.fill_diagonal(Q, 0.0)
    np.fill_diagonal(Q, -Q.sum(axis=1))
    # normalize to one expected substitution per unit time
    scale = -(freqs * np.diag(Q)).sum()
    Q = Q / scale
    # symmetrize: B = diag(sqrt(pi)) Q diag(1/sqrt(pi)) is symmetric
    sq = np.sqrt(freqs)
    B = (sq[:, None] * Q) / sq[None, :]
    lam, V = np.linalg.eigh((B + B.T) / 2.0)
    U = (1.0 / sq)[:, None] * V
    U_inv = V.T * sq[None, :]
    return lam, U, U_inv


def gamma_category_rates(alpha: float, categories: int) -> np.ndarray:
    """Mean rates of equal-probability discrete-Γ categories (Yang 1994),
    normalized to mean 1 — raxml-ng's default discretization."""
    if categories <= 1:
        return np.ones(1)
    from scipy.stats import gamma as gamma_dist
    quantiles = gamma_dist.ppf(np.arange(1, categories) / categories,
                               alpha, scale=1.0 / alpha)
    edges = np.concatenate([[0.0], quantiles, [np.inf]])
    # mean within each interval via the incomplete-gamma identity
    upper = gamma_dist.cdf(edges[1:], alpha + 1, scale=1.0 / alpha)
    lower = gamma_dist.cdf(edges[:-1], alpha + 1, scale=1.0 / alpha)
    rates = (upper - lower) * categories
    return rates / rates.mean()


def _encode_leaves(align: Alignment, traits: SeqTraits) -> Dict[str, np.ndarray]:
    """Leaf label -> [sites, σ] one-hot partials (ones for gap/ambiguous)."""
    lut = traits.codes_lut()
    sigma = traits.alphabet_size
    out = {}
    data = align.as_bytes()
    for row, header in enumerate(align.headers):
        codes = lut[data[row]]
        L = np.ones((align.width, sigma), dtype=np.float32)
        known = codes >= 0
        L[known] = 0.0
        L[np.nonzero(known)[0], codes[known]] = 1.0
        out[header] = L
    return out


def _child_message(P_child: torch.Tensor, L_child: torch.Tensor
                   ) -> torch.Tensor:
    # [cat, σ, σ] x [cat, S, σ] -> [cat, S, σ]: sum over child states
    return torch.einsum("cxy,csy->csx", P_child, L_child)


def _normalize(Lv: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(Lv.amax(dim=(0, 2), keepdim=True), min=1e-30)
    return Lv / scale


def ancestral_posteriors(tree: PhyloTree, align: Alignment,
                         traits: SeqTraits = DNA, alpha: float = 1.0,
                         categories: int = 4,
                         rates: Optional[np.ndarray] = None,
                         freqs: Optional[np.ndarray] = None,
                         device: device_mod.DeviceLike = "cuda"
                         ) -> Tuple[List[PhyloNode], np.ndarray]:
    """Marginal posterior state distributions for every internal node, in
    float32 on ``device``.

    Returns (internal nodes in postorder, posteriors [n_internal, sites, σ]).
    """
    dev = device_mod.resolve(device)
    f32 = torch.float32
    sigma = traits.alphabet_size
    if freqs is None:
        freqs = empirical_frequencies(align, traits)
    lam, U, U_inv = gtr_eigendecomposition(freqs, rates)
    cat_rates = gamma_category_rates(alpha, categories)
    n_cat = len(cat_rates)

    nodes = list(postorder(tree.root))
    index = {id(n): i for i, n in enumerate(nodes)}
    leaves = _encode_leaves(align, traits)
    S = align.width

    lam_t = torch.as_tensor(lam, dtype=f32, device=dev)
    U_t = torch.as_tensor(U, dtype=f32, device=dev)
    Ui_t = torch.as_tensor(U_inv, dtype=f32, device=dev)
    pi_t = torch.as_tensor(freqs, dtype=f32, device=dev)

    # P(t) = U diag(exp(λ t)) U⁻¹ for every (node, category): [n, cat, σ, σ]
    bl = np.array([n.branch_length for n in nodes], dtype=np.float32)
    T = torch.from_numpy(
        np.einsum("c,n->nc", cat_rates.astype(np.float32), bl)).to(dev)
    P_mats = torch.matmul(U_t * torch.exp(lam_t * T[:, :, None])[:, :, None, :],
                          Ui_t)
    P_mats = torch.clamp(P_mats, min=0.0)

    # ---- inside (postorder): L[v] [cat, S, σ], rescaled per node ----------
    L: List[Optional[torch.Tensor]] = [None] * len(nodes)
    # each child's message to its parent, kept for the outside pass
    msg: List[Optional[torch.Tensor]] = [None] * len(nodes)
    for v in nodes:
        i = index[id(v)]
        if v.is_leaf():
            leaf = leaves.get(v.label)
            if leaf is None:
                leaf = np.ones((S, sigma), dtype=np.float32)
            L[i] = torch.from_numpy(leaf).to(dev).expand(n_cat, S, sigma)
        else:
            acc = torch.ones((n_cat, S, sigma), dtype=f32, device=dev)
            for ch in v.children:
                j = index[id(ch)]
                msg[j] = _child_message(P_mats[j], L[j])
                acc = acc * msg[j]
            L[i] = _normalize(acc)

    # ---- outside (preorder): the prior π enters once, at the root ---------
    G: List[Optional[torch.Tensor]] = [None] * len(nodes)
    G[index[id(tree.root)]] = pi_t[None, None, :].expand(n_cat, S, sigma)
    for v in nodes[::-1]:           # parents before children
        i = index[id(v)]
        if v.is_leaf():
            continue
        for ch in v.children:
            j = index[id(ch)]
            upper = G[i]
            for sib in v.children:
                if sib is ch:
                    continue
                upper = upper * msg[index[id(sib)]]
            # [cat, S, σ(parent)] through P_child^T -> [cat, S, σ(child)]
            G[j] = _normalize(torch.einsum("cxy,csx->csy", P_mats[j], upper))

    # ---- posteriors -------------------------------------------------------
    internal = [v for v in nodes if not v.is_leaf()]
    posts = []
    for v in internal:
        i = index[id(v)]
        post = (L[i] * G[i]).sum(dim=0)                      # sum categories
        posts.append(post / torch.clamp(post.sum(dim=1, keepdim=True),
                                        min=1e-30))
    return internal, torch.stack(posts).cpu().numpy()


def run_native_ar(extended_tree: PhyloTree, align: Alignment,
                  working_dir: str, traits: SeqTraits = DNA,
                  alpha: float = 1.0, categories: int = 4,
                  optimize: bool = False, opt_steps: int = 200,
                  verbosity: int = 1,
                  device: device_mod.DeviceLike = "cuda") -> Tuple[str, str]:
    """Compute posteriors on ``device`` and write raxml-ng-format artifacts
    under ``<workdir>/AR/`` (probs TSV + labeled tree). Returns their paths.

    With ``optimize=True``, branch lengths, GTR rates and the Γ alpha are
    first fitted by maximum likelihood on the same device
    (:func:`ipk_tpu_torch.ar.optimize.optimize_parameters`); the fitted
    branch lengths go into the ancestralTree artifact, as raxml-ng's do.
    """
    ar_dir = os.path.join(working_dir, "AR")
    os.makedirs(ar_dir, exist_ok=True)

    rates = None
    freqs = None
    source_tree = extended_tree
    if optimize:
        from .optimize import apply_branch_lengths, optimize_parameters
        result = optimize_parameters(
            extended_tree, align, traits, alpha=alpha, categories=categories,
            steps=opt_steps, verbosity=verbosity, device=device)
        source_tree = extended_tree.copy()
        apply_branch_lengths(source_tree, result.branch_lengths)
        rates, freqs, alpha = result.rates, result.freqs, result.alpha

    # AR-view tree: internal nodes labeled NodeN in postorder
    ar_tree = source_tree.copy()
    counter = 0
    for node in postorder(ar_tree.root):
        if not node.is_leaf():
            node.label = f"Node{counter}"
            counter += 1
    ar_tree.index()
    tree_path = os.path.join(ar_dir, "native.raxml.ancestralTree")
    with open(tree_path, "w") as f:
        f.write(to_newick(ar_tree) + "\n")

    internal, posts = ancestral_posteriors(source_tree, align, traits,
                                           alpha, categories, rates=rates,
                                           freqs=freqs, device=device)
    # file columns are in raxml order; the tensors are in i2l order — invert
    # the read-side permutation for amino acids (the reader applies it again)
    if traits.alphabet_size == 20:
        inv = np.argsort(aa_permutation())
        posts_out = posts[:, :, inv]
        letters = RAXML_AA_ORDER
    else:
        posts_out = posts
        letters = traits.letters

    probs_path = os.path.join(ar_dir, "native.raxml.ancestralProbs")
    row_fmt = "\t".join(["%.9f"] * len(letters))
    letter_arr = np.asarray(list(letters))
    with open(probs_path, "w") as f:
        f.write("Node\tSite\tState\t" +
                "\t".join(f"p_{c}" for c in letters) + "\n")
        for vi in range(len(internal)):
            block = posts_out[vi]
            states = letter_arr[block.argmax(axis=1)].tolist()
            f.write("".join(
                f"Node{vi}\t{site + 1}\t{state}\t{row_fmt % tuple(row)}\n"
                for site, (state, row) in enumerate(zip(states,
                                                        block.tolist()))))
    return probs_path, tree_path
