"""Native AR parameter optimization: likelihood correctness vs brute force,
differentiable Γ discretization, and end-to-end improvement."""

import itertools

import jax
import numpy as np
import pytest

from ipk_tpu.alignment import Alignment
from ipk_tpu.ar.native import (empirical_frequencies, gamma_category_rates,
                               gtr_eigendecomposition)
from ipk_tpu.ar.optimize import (gamma_rates_jax, optimize_parameters,
                                 tree_loglikelihood_fn, apply_branch_lengths)
from ipk_tpu.seq import DNA
from ipk_tpu.tree import parse_newick, postorder


def brute_force_loglik(tree, align, freqs, lam, U, U_inv, cat_rates):
    """Total log-likelihood by enumerating internal-state assignments."""
    nodes = list(postorder(tree.root))
    internal = [n for n in nodes if not n.is_leaf()]
    lut = DNA.codes_lut()
    seq_codes = {h: lut[np.frombuffer(s.encode(), np.uint8)]
                 for h, s in zip(align.headers, align.sequences)}
    sigma = len(freqs)
    total_ll = 0.0
    for site in range(align.width):
        site_lik = 0.0
        for cat_rate in cat_rates:
            P = {id(n): (U * np.exp(lam * n.branch_length * cat_rate)) @ U_inv
                 for n in nodes}
            for assign in itertools.product(range(sigma),
                                            repeat=len(internal)):
                state = {id(v): s for v, s in zip(internal, assign)}
                lik = freqs[state[id(tree.root)]]
                for n in nodes:
                    if n.parent is None:
                        continue
                    ps = state[id(n.parent)]
                    if n.is_leaf():
                        code = seq_codes[n.label][site]
                        if code < 0:
                            continue  # gap marginalizes to 1
                        lik *= P[id(n)][ps, code]
                    else:
                        lik *= P[id(n)][ps, state[id(n)]]
                site_lik += lik
        total_ll += np.log(site_lik / len(cat_rates))
    return total_ll


@pytest.mark.parametrize("alpha", [0.3, 1.0, 5.0])
def test_gamma_rates_jax_matches_scipy(alpha):
    with jax.enable_x64():
        got = np.asarray(gamma_rates_jax(alpha, 4))
    expected = gamma_category_rates(alpha, 4)
    np.testing.assert_allclose(got, expected, rtol=1e-6)
    assert abs(got.mean() - 1.0) < 1e-12


def test_gamma_rates_jax_differentiable():
    with jax.enable_x64():
        g = jax.grad(lambda a: gamma_rates_jax(a, 4)[3])(1.0)
    # the top category's rate decreases as alpha grows (less heterogeneity)
    assert np.isfinite(g) and g < 0


@pytest.mark.parametrize("categories", [1, 4])
def test_loglikelihood_matches_brute_force(categories):
    tree = parse_newick("((a:0.3,b:0.8)x:0.4,(c:0.2,d:1.1)y:0.6)r;")
    align = Alignment(["a", "b", "c", "d"],
                      ["ACGTA", "ACGTC", "AGTTA", "A-GTA"])
    freqs = empirical_frequencies(align, DNA)
    lam, U, U_inv = gtr_eigendecomposition(freqs)
    cat_rates = gamma_category_rates(1.0, categories)
    expected = brute_force_loglik(tree, align, freqs, lam, U, U_inv,
                                  cat_rates)
    with jax.enable_x64():
        loglik, data = tree_loglikelihood_fn(tree, align, DNA, categories)
        got = float(loglik(np.asarray(data.branch_lengths),
                           np.ones(6), 1.0, freqs))
    np.testing.assert_allclose(got, expected, rtol=1e-8)


def test_loglikelihood_gradient_matches_finite_differences():
    tree = parse_newick("((a:0.3,b:0.8)x:0.4,c:0.5)r;")
    align = Alignment(["a", "b", "c"], ["ACGTAC", "ACGTAA", "TCGTAC"])
    freqs = empirical_frequencies(align, DNA)
    with jax.enable_x64():
        loglik, data = tree_loglikelihood_fn(tree, align, DNA, 4)
        bl = np.asarray(data.branch_lengths)
        f = lambda b: loglik(b, np.ones(6), 1.0, freqs)
        grad = np.asarray(jax.grad(f)(bl))
        h = 1e-6
        for i in range(len(bl) - 1):  # root entry unused
            e = np.zeros_like(bl)
            e[i] = h
            fd = (float(f(bl + e)) - float(f(bl - e))) / (2 * h)
            np.testing.assert_allclose(grad[i], fd, rtol=1e-4, atol=1e-8)


def test_optimize_improves_loglik():
    tree = parse_newick("((a:0.9,b:0.9)x:0.9,(c:0.9,d:0.9)y:0.9)r;")
    align = Alignment(["a", "b", "c", "d"],
                      ["ACGTACGTAAC", "ACGTACGTATC",
                       "ACTTACGAATC", "ACTTACCAATG"])
    result = optimize_parameters(tree, align, DNA, steps=80,
                                 learning_rate=0.05, verbosity=0)
    assert result.loglik_final >= result.loglik_initial
    assert result.loglik_final - result.loglik_initial > 0.5
    assert (result.branch_lengths > 0).all()
    assert result.alpha > 0
    assert (result.rates > 0).all()
    # apply back: tree gets the optimized lengths in postorder order
    apply_branch_lengths(tree, result.branch_lengths)
    got = [n.branch_length for n in postorder(tree.root)
           if n.parent is not None]
    np.testing.assert_allclose(
        got, [b for i, b in enumerate(result.branch_lengths)
              if i != len(result.branch_lengths) - 1])


def test_optimize_recovers_long_vs_short_branch():
    """Identical sequences on one edge, divergent on another: the optimizer
    should shrink the identical pair's branches below the divergent pair's."""
    tree = parse_newick("((a:0.5,b:0.5)x:0.3,(c:0.5,d:0.5)y:0.3)r;")
    rng = np.random.default_rng(3)
    base = "".join(rng.choice(list("ACGT"), size=60))
    mutated = list(base)
    for i in rng.choice(60, size=25, replace=False):
        mutated[i] = rng.choice([c for c in "ACGT" if c != mutated[i]])
    align = Alignment(["a", "b", "c", "d"],
                      [base, base, base, "".join(mutated)])
    result = optimize_parameters(tree, align, DNA, steps=150,
                                 learning_rate=0.05, verbosity=0,
                                 optimize_rates=False, optimize_alpha=False)
    nodes = [n.label for n in postorder(tree.root)]
    bl = {lbl: result.branch_lengths[i] for i, lbl in enumerate(nodes)}
    assert bl["a"] < 0.05 and bl["b"] < 0.05
    assert bl["d"] > 5 * max(bl["a"], bl["b"])


def test_run_native_ar_optimized_artifacts(tmp_path):
    from ipk_tpu.tree import extend_tree, load_newick
    from ipk_tpu.alignment import extend_alignment
    from ipk_tpu.ar.native import run_native_ar
    from ipk_tpu.ar.reader import read_ancestral_probs

    tree = parse_newick("((a:0.3,b:0.8)x:0.4,c:0.5)r;")
    ext, _ = extend_tree(tree)
    align = Alignment(["a", "b", "c"], ["ACGTAC", "ACGTAA", "TCGTAC"])
    ext_align = extend_alignment(align, ext)
    probs, tree_path = run_native_ar(ext, ext_align, str(tmp_path), DNA,
                                     optimize=True, opt_steps=20,
                                     verbosity=0)
    label_rows, P = read_ancestral_probs(probs, DNA)
    lin = np.power(10.0, P.astype(np.float64))
    np.testing.assert_allclose(lin.sum(axis=2), 1.0, atol=1e-5)
    # the artifact tree carries *optimized* branch lengths: at least one
    # length must differ from the input extended tree's
    opt_tree = load_newick(tree_path)
    orig = np.array([n.branch_length for n in postorder(ext.root)])
    new = np.array([n.branch_length for n in postorder(opt_tree.root)])
    assert not np.allclose(orig, new)
    # caller's extended tree is untouched
    assert np.allclose(
        orig, [n.branch_length for n in postorder(ext.root)])


# ---------------------------------------------------------------------------
# r2: quantitative fitness of the native AR optimizer.
# raxml-ng is not available in this environment, so the anchor is simulation
# recovery: sequences simulated under known GTR+Γ parameters, optimization
# started from perturbed branch lengths must (a) reach at least the true
# parameters' likelihood, (b) recover branch lengths within a quantitative
# budget, and (c) move the posteriors toward the truth-parameter posteriors.
# ---------------------------------------------------------------------------

def _simulate_alignment(tree, freqs, lam, U, U_inv, cat_rates, S, rng):
    from ipk_tpu.tree import postorder
    import numpy as np

    def P_of(t):
        return (U * np.exp(lam * t)[None, :]) @ U_inv

    cats = rng.integers(0, len(cat_rates), size=S)
    nodes = list(postorder(tree.root))
    states = {}
    for site in range(S):
        r = cat_rates[cats[site]]
        # root draw + downward propagation (preorder)
        for n in reversed(nodes):
            if n.parent is None:
                states.setdefault(id(n), []).append(
                    rng.choice(len(freqs), p=freqs))
            else:
                P = P_of(n.branch_length * r)
                parent_state = states[id(n.parent)][site]
                p = np.maximum(P[parent_state], 0)
                p = p / p.sum()
                states.setdefault(id(n), []).append(
                    rng.choice(len(freqs), p=p))
    leaves = [n for n in nodes if n.is_leaf()]
    seqs = {n.label: "".join("ACGT"[s] for s in states[id(n)])
            for n in leaves}
    return seqs


def test_optimizer_recovers_simulated_parameters():
    import numpy as np
    from ipk_tpu.alignment import Alignment
    from ipk_tpu.ar.native import (ancestral_posteriors,
                                   gamma_category_rates,
                                   gtr_eigendecomposition)
    from ipk_tpu.ar.optimize import (apply_branch_lengths,
                                     optimize_parameters,
                                     tree_loglikelihood_fn)
    from ipk_tpu.seq import DNA
    from ipk_tpu.tree import parse_newick, postorder

    rng = np.random.default_rng(17)
    newick = ("((a:0.25,b:0.6)x:0.3,((c:0.15,d:0.45)y:0.2,e:0.7)z:0.35)r;")
    tree = parse_newick(newick)
    freqs = np.array([0.3, 0.2, 0.25, 0.25])
    lam, U, U_inv = gtr_eigendecomposition(freqs)
    cat_rates = gamma_category_rates(1.0, 4)
    S = 3000
    seqs = _simulate_alignment(tree, freqs, lam, U, U_inv, cat_rates, S, rng)
    align = Alignment(list(seqs), [seqs[h] for h in seqs])

    true_bl = {n.label: n.branch_length for n in postorder(tree.root)
               if n.parent is not None}

    # perturb: double every branch length, then optimize
    work = parse_newick(newick)
    for n in postorder(work.root):
        if n.parent is not None:
            n.branch_length *= 2.0
    result = optimize_parameters(work, align, DNA, alpha=1.0, categories=4,
                                 optimize_rates=False, steps=300,
                                 verbosity=0)

    # (a) likelihood at the fit >= likelihood at the simulation truth
    loglik, data = tree_loglikelihood_fn(tree, align, DNA, 4)
    import jax.numpy as jnp
    ll_truth = float(loglik(jnp.asarray(data.branch_lengths, jnp.float64),
                            jnp.ones(6, jnp.float64), jnp.asarray(1.0),
                            jnp.asarray(freqs, jnp.float64)))
    assert result.loglik_final >= ll_truth - 2.0, \
        (result.loglik_final, ll_truth)

    # (b) branch lengths recovered within a quantitative budget
    apply_branch_lengths(work, result.branch_lengths)
    fit_bl = {n.label: n.branch_length for n in postorder(work.root)
              if n.parent is not None}
    rel = [abs(fit_bl[lbl] - true_bl[lbl]) / max(true_bl[lbl], 0.05)
           for lbl in true_bl]
    assert np.mean(rel) < 0.25, (sorted(zip(true_bl, rel)), np.mean(rel))
    assert max(rel) < 0.75, sorted(zip(true_bl, rel))

    # (c) optimized posteriors approach the truth-parameter posteriors
    _, post_truth = ancestral_posteriors(tree, align, DNA, alpha=1.0,
                                         categories=4)
    perturbed = parse_newick(newick)
    for n in postorder(perturbed.root):
        if n.parent is not None:
            n.branch_length *= 2.0
    _, post_bad = ancestral_posteriors(perturbed, align, DNA, alpha=1.0,
                                       categories=4)
    _, post_fit = ancestral_posteriors(work, align, DNA,
                                       alpha=float(result.alpha),
                                       categories=4)
    err_bad = np.abs(post_bad - post_truth).max()
    err_fit = np.abs(post_fit - post_truth).max()
    assert err_fit < err_bad, (err_fit, err_bad)
    # absolute budgets: worst single (node, site, state) and the mean
    assert err_fit < 0.12, err_fit
    assert np.abs(post_fit - post_truth).mean() < 0.01
