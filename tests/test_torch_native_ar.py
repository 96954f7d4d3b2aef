"""ipk_tpu_torch.ar (native AR and its ML fit) against ipk_tpu.ar, on the
CPU.

Tolerances: posteriors are float32 pruning in two frameworks' summation
orders, held within atol 1e-5; databases built from them are compared with
ipk_tpu's tolerant comparator (diff_plain_text, eps 1e-3). The fit is f64:
gamma rates within rtol 1e-8 and their alpha derivative within rtol 1e-6 of
jax.grad; the log-likelihood within rtol 1e-10 and its gradient within
rtol 1e-8; ten Adam steps within rtol 1e-6 of optax's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipk_tpu.alignment import Alignment, extend_alignment
from ipk_tpu.ar import native as jnative
from ipk_tpu.ar import optimize as jopt
from ipk_tpu.ar.reader import read_ancestral_probs
from ipk_tpu.pipeline import BuildParams as JaxParams
from ipk_tpu.pipeline import build_database as jax_build_database
from ipk_tpu.seq import AA, DNA
from ipk_tpu.tools import diff_plain_text
from ipk_tpu.tree import extend_tree, parse_newick
from ipk_tpu.tree import to_newick
from ipk_tpu_torch import alignment as talignment
from ipk_tpu_torch import seq as tseq
from ipk_tpu_torch import tree as ttree
from ipk_tpu_torch.ar import native as tnative
from ipk_tpu_torch.ar import optimize as topt
from ipk_tpu_torch.pipeline import BuildParams, build_database

from fixtures import make_project, random_alignment

torch.set_num_threads(2)

TREE4 = "((a:0.3,b:0.8)x:0.4,(c:0.2,d:1.1)y:0.6)r;"
ALIGN4 = Alignment(["a", "b", "c", "d"], ["ACGTA", "ACGTC", "AGTTA", "A-GTA"])


def port(obj):
    """The port's own object for an ipk_tpu tree, alignment or alphabet,
    made from its newick text, its sequences or its name (the two packages
    share no classes)."""
    if hasattr(obj, "root"):
        return ttree.parse_newick(to_newick(obj))
    if hasattr(obj, "sequences"):
        return talignment.Alignment(obj.headers, obj.sequences)
    return tseq.get_traits(obj.name)


def port_extended(tree, align):
    """The port's extended tree and alignment, made by its own
    extend_tree / extend_alignment from the same newick and sequences."""
    ext, _ = ttree.extend_tree(port(tree))
    return ext, talignment.extend_alignment(port(align), ext)


def aa_case():
    rng = np.random.default_rng(4)
    tree = parse_newick("(((a:0.2,b:0.5)x:0.3,c:0.4)y:0.2,(d:0.6,e:0.1)z:0.3)r;")
    align = random_alignment(rng, ["a", "b", "c", "d", "e"], 12, AA,
                             gap_prob=0.1)
    return tree, align


@pytest.mark.parametrize("categories", [1, 4])
@pytest.mark.parametrize("states", ["dna", "aa"])
def test_ancestral_posteriors_match(states, categories):
    if states == "dna":
        tree, align, traits = parse_newick(TREE4), ALIGN4, DNA
    else:
        (tree, align), traits = aa_case(), AA
    nodes_j, posts_j = jnative.ancestral_posteriors(
        tree, align, traits, alpha=0.7, categories=categories)
    nodes_t, posts_t = tnative.ancestral_posteriors(
        port(tree), port(align), port(traits), alpha=0.7,
        categories=categories, device="cpu")
    assert [n.label for n in nodes_t] == [n.label for n in nodes_j]
    assert posts_t.dtype == np.float32
    np.testing.assert_allclose(posts_t, posts_j, rtol=0, atol=1e-5)


def test_copied_host_helpers_match():
    freqs = jnative.empirical_frequencies(ALIGN4, DNA)
    np.testing.assert_array_equal(
        tnative.empirical_frequencies(port(ALIGN4), port(DNA)), freqs)
    for a, b in zip(tnative.gtr_eigendecomposition(freqs),
                    jnative.gtr_eigendecomposition(freqs)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tnative.gamma_category_rates(0.4, 4),
                                  jnative.gamma_category_rates(0.4, 4))


@pytest.mark.parametrize("traits", [DNA, AA])
def test_run_native_ar_artifacts(tmp_path, traits):
    """The port's artifacts parse back with ipk_tpu's reader to ipk_tpu's
    posteriors (AA columns go through raxml's order and back)."""
    if traits is DNA:
        tree = parse_newick("((a:0.3,b:0.8)x:0.4,c:0.5)r;")
        align = Alignment(["a", "b", "c"], ["ACGTAC", "ACGTAA", "TCGTAC"])
    else:
        tree, align = aa_case()
    ext, _ = extend_tree(tree)
    ext_align = extend_alignment(align, ext)
    text, text_align = port_extended(tree, align)
    out = {}
    for tag, run, args, extra in [
            ("jax", jnative.run_native_ar, (ext, ext_align), {}),
            ("torch", tnative.run_native_ar, (text, text_align),
             {"device": "cpu"})]:
        probs, tree_path = run(*args, str(tmp_path / tag),
                               traits if tag == "jax" else port(traits),
                               **extra)
        assert os.path.basename(probs) == "native.raxml.ancestralProbs"
        out[tag] = (read_ancestral_probs(probs, traits),
                    open(tree_path).read())
    (rows_j, P_j), tree_j = out["jax"]
    (rows_t, P_t), tree_t = out["torch"]
    assert rows_t == rows_j and tree_t == tree_j
    np.testing.assert_allclose(np.power(10.0, P_t.astype(np.float64)),
                               np.power(10.0, P_j.astype(np.float64)),
                               rtol=0, atol=1e-5)


def test_native_ar_build_matches_ipk_tpu(tmp_path):
    """--ar native end to end: the port's database equals ipk_tpu's under
    diff_plain_text, and replaying the port's AR directory rebuilds it."""
    tree_file, fasta_file, _ = make_project(tmp_path, num_leaves=5, width=24,
                                            seed=77)
    outs = {}
    for tag, params_cls, run, extra in [
            ("jax", JaxParams, jax_build_database, {}),
            ("torch", BuildParams, build_database, {"device": "cpu"})]:
        outs[tag] = str(tmp_path / f"DB_{tag}.ipk")
        run(params_cls(refalign=fasta_file, reftree=tree_file,
                       working_dir=str(tmp_path / f"wd_{tag}"),
                       ar_binary="native", kmer_size=4, omega=1.5,
                       output_filename=outs[tag], verbosity=0, **extra))
    assert diff_plain_text(outs["torch"], outs["jax"], eps=1e-3,
                           verbose=False)
    replay = str(tmp_path / "DB_replay.ipk")
    build_database(BuildParams(
        refalign=fasta_file, reftree=tree_file,
        working_dir=str(tmp_path / "wd_replay"),
        ar_dir=str(tmp_path / "wd_torch" / "AR"), kmer_size=4, omega=1.5,
        output_filename=replay, verbosity=0, device="cpu"))
    assert open(replay, "rb").read() == open(outs["torch"], "rb").read()


@pytest.mark.parametrize("alpha", [0.2, 0.5, 1.0, 2.0, 5.0])
def test_gamma_rates_and_alpha_derivative(alpha):
    with jax.enable_x64():
        want = np.asarray(jopt.gamma_rates_jax(alpha, 4))
        dwant = np.asarray(jax.jacrev(
            lambda a: jopt.gamma_rates_jax(a, 4))(alpha))
    a = torch.tensor(alpha, dtype=torch.float64, requires_grad=True)
    got = topt.gamma_rates(a, 4)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-8)
    dgot = np.array([torch.autograd.grad(got[i], a, retain_graph=True)[0]
                     .item() for i in range(4)])
    np.testing.assert_allclose(dgot, dwant, rtol=1e-6)


@pytest.mark.parametrize("categories", [1, 4])
def test_loglikelihood_value_and_gradient(categories):
    tree = parse_newick(TREE4)
    freqs = jnative.empirical_frequencies(ALIGN4, DNA)
    rates = np.array([1.0, 2.0, 0.5, 1.5, 3.0, 1.0])
    with jax.enable_x64():
        ll_j, data = jopt.tree_loglikelihood_fn(tree, ALIGN4, DNA, categories)
        bl = np.asarray(data.branch_lengths)
        args = (jnp.asarray(bl), jnp.asarray(rates), jnp.asarray(0.8),
                jnp.asarray(freqs))
        want = float(ll_j(*args))
        gwant = [np.asarray(g) for g in
                 jax.grad(ll_j, argnums=(0, 1, 2))(*args)]
    ll_t, _ = topt.tree_loglikelihood_fn(port(tree), port(ALIGN4),
                                         port(DNA), categories, device="cpu")
    targs = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
             for x in (bl, rates, 0.8)]
    got = ll_t(*targs, freqs)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-10)
    ggot = torch.autograd.grad(got, targs, allow_unused=True)
    for g, gw in zip(ggot, gwant):
        g = np.zeros_like(gw) if g is None else g.numpy()
        np.testing.assert_allclose(g, gw, rtol=1e-8, atol=1e-12)


def test_ten_adam_steps_match_optax():
    tree = parse_newick("((a:0.9,b:0.9)x:0.9,(c:0.9,d:0.9)y:0.9)r;")
    align = Alignment(["a", "b", "c", "d"],
                      ["ACGTACGTAAC", "ACGTACGTATC",
                       "ACTTACGAATC", "ACTTACCAATG"])
    kw = dict(steps=10, learning_rate=0.05, verbosity=0)
    want = jopt.optimize_parameters(tree, align, DNA, **kw)
    got = topt.optimize_parameters(port(tree), port(align), port(DNA),
                                   device="cpu", **kw)
    assert got.steps == want.steps == 10
    np.testing.assert_allclose(got.branch_lengths, want.branch_lengths,
                               rtol=1e-6)
    np.testing.assert_allclose(got.rates, want.rates, rtol=1e-6)
    np.testing.assert_allclose(got.alpha, want.alpha, rtol=1e-6)
    np.testing.assert_allclose(got.loglik_initial, want.loglik_initial,
                               rtol=1e-10)
    np.testing.assert_allclose(got.loglik_final, want.loglik_final,
                               rtol=1e-6)
    assert got.loglik_final > got.loglik_initial


def test_optimized_native_ar_artifacts(tmp_path):
    """--ar-optimize on the port's native route: fitted branch lengths go
    into the ancestralTree artifact; posteriors stay normalized."""
    from ipk_tpu.tree import load_newick, postorder
    tree = parse_newick("((a:0.3,b:0.8)x:0.4,c:0.5)r;")
    ext, _ = extend_tree(tree)
    align = Alignment(["a", "b", "c"], ["ACGTAC", "ACGTAA", "TCGTAC"])
    text, text_align = port_extended(tree, align)
    probs, tree_path = tnative.run_native_ar(
        text, text_align, str(tmp_path), port(DNA), optimize=True,
        opt_steps=8, verbosity=0, device="cpu")
    _, P = read_ancestral_probs(probs, DNA)
    np.testing.assert_allclose(np.power(10.0, P.astype(np.float64)).sum(2),
                               1.0, atol=1e-5)
    orig = [n.branch_length for n in postorder(ext.root)]
    new = [n.branch_length for n in postorder(load_newick(tree_path).root)]
    assert not np.allclose(orig, new)
