"""Maximum-likelihood fit of branch lengths and model parameters for the
native AR (``--ar native --ar-optimize``): the counterpart of
``ipk_tpu/ar/optimize.py``, with torch autograd in float64 on the build's
device in place of ``jax.grad`` (a TPU emulates f64, so ``ipk_tpu`` pins
this to the host; an H100 computes f64 natively).

* branch lengths: softplus-parameterized, one free scalar per branch;
* GTR exchangeabilities (DNA): log-parameterized, the last (G<->T) pinned;
  off by default for amino acids;
* Γ shape alpha: softplus-parameterized. The discrete-Γ category rates are
  differentiable in alpha through fixed-count Newton iterations on the
  quantile equations ``gammainc(a, y) = q``. ``torch.special.gammainc``
  has no derivative in its shape, so :class:`_GammaInc` supplies both
  partial derivatives (the shape one by its power series);
* frequencies: empirical counts (``+FC``), fixed.

The optimizer is ``torch.optim.Adam`` (b1 0.9, b2 0.999, eps 1e-8) under a
``LambdaLR`` cosine decay, the same update and schedule, step for step, as
``ipk_tpu``'s ``optax.adam(optax.cosine_decay_schedule(lr, steps))``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import device as device_mod
from ..alignment import Alignment
from ..seq import DNA, SeqTraits
from ..tree import PhyloTree, postorder
from .native import _encode_leaves, empirical_frequencies

__all__ = ["gamma_rates", "tree_loglikelihood_fn", "optimize_parameters",
           "OptResult", "apply_branch_lengths"]

F64 = torch.float64


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _softplus_inv(y):
    # inverse of log(1+e^x); y > 0
    y = np.asarray(y, dtype=np.float64)
    return np.where(y > 30.0, y, np.log(np.expm1(np.maximum(y, 1e-12))))


def _gammainc_da(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """d/da of the regularized lower incomplete gamma P(a, x), x > 0, by
    its power series: P = Σ_n t_n with t_n = x^(a+n) e^-x / Γ(a+n+1), so
    dP/da = Σ_n t_n (ln x - ψ(a+n+1)). Terms past n ≈ x + 12 √x + 40 are
    below 1e-18 for the arguments the quantile solve reaches."""
    x_max = float(x.max())
    n = torch.arange(int(math.ceil(x_max + 12.0 * math.sqrt(x_max) + 40.0)),
                     dtype=x.dtype, device=x.device)
    lx = torch.log(x)[..., None]
    an = a[..., None] + n
    log_t = an * lx - x[..., None] - torch.lgamma(an + 1.0)
    return (torch.exp(log_t) * (lx - torch.digamma(an + 1.0))).sum(dim=-1)


class _GammaInc(torch.autograd.Function):
    """``torch.special.gammainc(a, x)`` differentiable in both arguments."""

    @staticmethod
    def forward(ctx, a, x):
        ctx.save_for_backward(a, x)
        return torch.special.gammainc(a, x)

    @staticmethod
    def backward(ctx, grad):
        a, x = ctx.saved_tensors
        a_b, x_b = torch.broadcast_tensors(a, x)
        grad_a = grad_x = None
        if ctx.needs_input_grad[0]:
            grad_a = (grad * _gammainc_da(a_b, x_b)).sum_to_size(a.shape)
        if ctx.needs_input_grad[1]:
            pdf = torch.exp((a_b - 1.0) * torch.log(x_b) - x_b
                            - torch.lgamma(a_b))
            grad_x = (grad * pdf).sum_to_size(x.shape)
        return grad_a, grad_x


def gamma_rates(alpha, categories: int, newton_steps: int = 30
                ) -> torch.Tensor:
    """Mean rates of equal-probability discrete-Γ categories, differentiable
    in ``alpha`` (``ipk_tpu.ar.optimize.gamma_rates_jax``, Yang 1994).

    Solves ``P(alpha, y_q) = q`` for the interior quantiles by Newton steps
    on y (``dP/dy = y^(a-1) e^-y / Γ(a)``) from the Wilson-Hilferty guess,
    then takes the interval means from ``P(alpha + 1, y)``.
    """
    alpha = torch.as_tensor(alpha, dtype=F64)
    if categories <= 1:
        return torch.ones(1, dtype=F64, device=alpha.device) * (alpha / alpha)
    dev = alpha.device
    q = torch.arange(1, categories, dtype=F64, device=dev) / categories

    # Wilson-Hilferty: y_q ≈ a (1 - 1/(9a) + z_q sqrt(1/(9a)))^3 for Γ(a, 1)
    z = math.sqrt(2.0) * torch.special.erfinv(2.0 * q - 1.0)
    y = alpha * (1.0 - 1.0 / (9.0 * alpha)
                 + z * torch.sqrt(1.0 / (9.0 * alpha))) ** 3
    y = torch.maximum(y, torch.tensor(1e-8, dtype=F64, device=dev))
    log_gamma_a = torch.lgamma(alpha)
    tiny = torch.tensor(1e-300, dtype=F64, device=dev)
    for _ in range(newton_steps):
        f = _GammaInc.apply(alpha, y) - q
        log_pdf = (alpha - 1.0) * torch.log(y) - y - log_gamma_a
        step = f / torch.maximum(torch.exp(log_pdf), tiny)
        # damped, stays positive
        y = torch.minimum(torch.maximum(y - step, y * 0.1), y * 10.0)

    # interval means of Γ(alpha, scale=1/alpha), normalized to mean 1
    inner = _GammaInc.apply(alpha + 1.0, y)
    upper = torch.cat([inner, torch.ones(1, dtype=F64, device=dev)])
    lower = torch.cat([torch.zeros(1, dtype=F64, device=dev), inner])
    rates = (upper - lower) * categories
    return rates / rates.mean()


def _expm_fixed(A: torch.Tensor, scalings: int = 12,
                order: int = 12) -> torch.Tensor:
    """Matrix exponential by scaling and squaring with a fixed-order Taylor
    (Horner) core, batched over leading dims: static control flow, so its
    gradient is plain autograd (``ipk_tpu.ar.optimize._expm_fixed``)."""
    A = A / (2.0 ** scalings)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    R = eye + A / order
    for n in range(order - 1, 0, -1):
        R = eye + torch.matmul(A, R) / n
    for _ in range(scalings):
        R = torch.matmul(R, R)
    return R


def _gtr_q(freqs: torch.Tensor, rates: torch.Tensor) -> torch.Tensor:
    """Normalized GTR rate matrix (``native.gtr_eigendecomposition``'s,
    without the eigendecomposition, whose gradient is NaN at the degenerate
    spectrum of unit exchangeabilities)."""
    sigma = freqs.shape[0]
    iu = torch.triu_indices(sigma, sigma, offset=1, device=freqs.device)
    R = torch.zeros((sigma, sigma), dtype=freqs.dtype, device=freqs.device)
    R = R.index_put((iu[0], iu[1]), rates)
    R = R + R.T
    Q = R * freqs[None, :]
    Q = Q - torch.diag(torch.diag(Q))
    Q = Q - torch.diag(Q.sum(dim=1))
    scale = -(freqs * torch.diag(Q)).sum()
    return Q / scale


@dataclasses.dataclass
class _TreeData:
    """Host-side flattening of the tree + alignment for the likelihood."""
    n_nodes: int
    children: List[List[int]]          # per node, child indices (postorder ids)
    is_leaf: List[bool]
    branch_lengths: np.ndarray         # [n_nodes] (root entry unused)
    leaf_partials: Dict[int, np.ndarray]   # node idx -> [S, sigma]
    root_index: int


def _flatten_tree(tree: PhyloTree, align: Alignment,
                  traits: SeqTraits) -> _TreeData:
    nodes = list(postorder(tree.root))
    index = {id(n): i for i, n in enumerate(nodes)}
    leaves = _encode_leaves(align, traits)
    S = align.width
    sigma = traits.alphabet_size
    leaf_partials = {}
    children: List[List[int]] = []
    is_leaf: List[bool] = []
    for n in nodes:
        children.append([index[id(c)] for c in n.children])
        is_leaf.append(n.is_leaf())
        if n.is_leaf():
            leaf_partials[index[id(n)]] = leaves.get(
                n.label, np.ones((S, sigma), dtype=np.float32))
    bl = np.array([max(n.branch_length, 1e-8) for n in nodes],
                  dtype=np.float64)
    return _TreeData(len(nodes), children, is_leaf, bl,
                     leaf_partials, index[id(tree.root)])


def tree_loglikelihood_fn(tree: PhyloTree, align: Alignment,
                          traits: SeqTraits = DNA, categories: int = 4,
                          dtype: torch.dtype = F64,
                          device: device_mod.DeviceLike = "cpu"):
    """Returns (loglik(branch_lengths, rates, alpha, freqs) -> 0-d tensor,
    data).

    ``loglik`` maps model parameters (linear space; tensors or arrays) to
    the total log-likelihood of the alignment under GTR+Γ on ``device``:
    one unrolled Felsenstein pass with per-node rescaling in log space,
    differentiable by autograd.
    """
    dev = device_mod.resolve(device)
    data = _flatten_tree(tree, align, traits)
    leaf_arrays = {i: torch.as_tensor(p, dtype=dtype, device=dev)
                   for i, p in data.leaf_partials.items()}

    def as_t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def loglik(branch_lengths, rates, alpha, freqs):
        branch_lengths, freqs = as_t(branch_lengths), as_t(freqs)
        Q = _gtr_q(freqs, as_t(rates))
        cat_rates = gamma_rates(as_t(alpha), categories).to(dtype)
        n_cat = categories if categories > 1 else 1
        # transition matrices per (node, category) via fixed-shape expm
        t_scaled = branch_lengths[:, None] * cat_rates[None, :]  # [n, cat]
        t_scaled = torch.minimum(torch.maximum(t_scaled, as_t(0.0)),
                                 as_t(100.0))   # expm scaling headroom
        P = _expm_fixed(Q[None, None] * t_scaled[:, :, None, None])
        P = torch.maximum(P, as_t(1e-300))

        partials: List[Optional[torch.Tensor]] = [None] * data.n_nodes
        logscale: List[Optional[torch.Tensor]] = [None] * data.n_nodes
        for i in range(data.n_nodes):
            if data.is_leaf[i]:
                leaf = leaf_arrays[i]
                partials[i] = leaf[None].expand((n_cat,) + leaf.shape)
                logscale[i] = torch.zeros(leaf.shape[0], dtype=dtype,
                                          device=dev)
            else:
                acc = None
                ls = None
                for c in data.children[i]:
                    # [cat, x, y] @ [cat, S, y] -> [cat, S, x]
                    msg = torch.einsum("cxy,csy->csx", P[c], partials[c])
                    acc = msg if acc is None else acc * msg
                    ls = logscale[c] if ls is None else ls + logscale[c]
                m = torch.maximum(acc.amax(dim=(0, 2)), as_t(1e-300))
                partials[i] = acc / m[None, :, None]
                logscale[i] = ls + torch.log(m)
        root = partials[data.root_index]
        site_lik = torch.einsum("csx,x->s", root, freqs) / n_cat
        return (torch.log(torch.maximum(site_lik, as_t(1e-300)))
                + logscale[data.root_index]).sum()

    return loglik, data


@dataclasses.dataclass
class OptResult:
    branch_lengths: np.ndarray     # [n_nodes] postorder (root entry unused)
    rates: np.ndarray              # GTR exchangeabilities (upper triangle)
    alpha: float
    freqs: np.ndarray
    loglik_initial: float
    loglik_final: float
    steps: int


def optimize_parameters(tree: PhyloTree, align: Alignment,
                        traits: SeqTraits = DNA, *, alpha: float = 1.0,
                        categories: int = 4,
                        rates: Optional[np.ndarray] = None,
                        freqs: Optional[np.ndarray] = None,
                        optimize_rates: Optional[bool] = None,
                        optimize_alpha: bool = True,
                        optimize_branch_lengths: bool = True,
                        steps: int = 200, learning_rate: float = 0.02,
                        verbosity: int = 1,
                        device: device_mod.DeviceLike = "cpu") -> OptResult:
    """Gradient-ascent ML fit of branch lengths / GTR rates / Γ alpha in f64
    on ``device`` (the analog of raxml-ng's ``--opt-model on --opt-branches
    on``, ``ipk/src/ar.cpp:684``). ``optimize_rates`` defaults to True for
    DNA and False for amino acids. The best parameters seen are returned;
    a non-finite loss stops the loop there."""
    sigma = traits.alphabet_size
    n_rates = sigma * (sigma - 1) // 2
    if optimize_rates is None:
        optimize_rates = sigma == 4
    if freqs is None:
        freqs = empirical_frequencies(align, traits)
    if rates is None:
        rates = np.ones(n_rates)
    dev = device_mod.resolve(device)
    loglik, data = tree_loglikelihood_fn(tree, align, traits, categories,
                                         device=dev)

    def leaf(x):
        return torch.tensor(np.asarray(x, dtype=np.float64), dtype=F64,
                            device=dev, requires_grad=True)

    params: Dict[str, torch.Tensor] = {}
    if optimize_branch_lengths:
        params["bl_raw"] = leaf(_softplus_inv(data.branch_lengths))
    if optimize_rates:
        # pin the last exchangeability to its initial value (identifiability)
        params["log_rates"] = leaf(np.log(np.asarray(rates[:-1],
                                                     dtype=np.float64)))
    if optimize_alpha and categories > 1:
        params["alpha_raw"] = leaf(_softplus_inv(np.array(alpha)))

    freqs_t = torch.as_tensor(freqs, dtype=F64, device=dev)
    bl0 = torch.as_tensor(data.branch_lengths, dtype=F64, device=dev)
    rates0 = torch.as_tensor(rates, dtype=F64, device=dev)
    alpha0 = torch.as_tensor(alpha, dtype=F64, device=dev)

    def unpack(p):
        bl = _softplus(p["bl_raw"]) if "bl_raw" in p else bl0
        if "log_rates" in p:
            r = torch.cat([torch.exp(p["log_rates"]), rates0[-1:]])
        else:
            r = rates0
        a = _softplus(p["alpha_raw"]) if "alpha_raw" in p else alpha0
        return bl, r, a

    def loss(p) -> torch.Tensor:
        bl, r, a = unpack(p)
        return -loglik(bl, r, a, freqs_t)

    def snapshot(p):
        return {k: v.detach().clone() for k, v in p.items()}

    if not params:  # nothing to optimize
        with torch.no_grad():
            ll = float(-loss({}))
        return OptResult(data.branch_lengths, np.asarray(rates),
                         float(alpha), np.asarray(freqs), ll, ll, 0)
    opt = torch.optim.Adam(list(params.values()), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    schedule = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: 0.5 * (1.0 + math.cos(
            math.pi * min(t, steps) / max(steps, 1))))
    with torch.no_grad():
        value0 = float(loss(params))
    if not np.isfinite(value0):
        raise RuntimeError(
            "native AR optimization: initial log-likelihood is not "
            "finite; check branch lengths and alignment")
    ll0 = -value0
    best = (value0, snapshot(params))
    for i in range(steps):
        value = loss(params)
        grads = torch.autograd.grad(value, list(params.values()))
        value = float(value.detach())
        if not np.isfinite(value):
            if verbosity > 0:
                print(f"  [ar-opt] non-finite loss at step {i}; "
                      "stopping at best-seen parameters")
            break
        if value < best[0]:
            best = (value, snapshot(params))
        for p, g in zip(params.values(), grads):
            p.grad = g
        opt.step()
        schedule.step()
        if verbosity > 1 and i % 25 == 0:
            print(f"  [ar-opt] step {i:4d}  logL = {-value:.4f}")
    with torch.no_grad():
        value = float(loss(params))
    if np.isfinite(value) and value < best[0]:
        best = (value, snapshot(params))
    with torch.no_grad():
        bl, r, a = unpack(best[1])
    result = OptResult(bl.cpu().numpy().astype(np.float64),
                       r.cpu().numpy().astype(np.float64), float(a),
                       np.asarray(freqs), float(ll0), -float(best[0]), steps)
    if verbosity > 0:
        print(f"Native AR parameter optimization: logL "
              f"{result.loglik_initial:.4f} -> {result.loglik_final:.4f} "
              f"({steps} steps, alpha = {result.alpha:.4f})")
    return result


def apply_branch_lengths(tree: PhyloTree, bl: np.ndarray) -> None:
    """Write optimized branch lengths back onto the tree (postorder order,
    matching ``_flatten_tree``). The root's entry is ignored."""
    for i, node in enumerate(postorder(tree.root)):
        if node.parent is not None:
            node.branch_length = float(bl[i])
