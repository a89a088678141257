"""Native ancestral reconstruction on the device: Felsenstein pruning + empirical-Bayes
marginal posteriors in JAX.

The reference shells out to raxml-ng for this step — its only multi-core
portion (``ipk/src/ar.cpp:650-707``; SURVEY.md §3.1 "the expensive ML step")
and an unvendored external dependency (gap G3). This module computes the same
object natively: for every internal node of the extended tree and every
alignment site, the marginal posterior distribution over states, written in
raxml-ng's ``.raxml.ancestralProbs`` / ``.raxml.ancestralTree`` formats so the
rest of the pipeline (and ``--ar-dir`` replay) is agnostic to which AR
produced them. Select with ``--ar native``.

Model: GTR + Γ(categories) with empirical base frequencies (the reference's
``+FC``) and unit exchangeabilities by default (JC/F81-like unless rates are
provided). By default branch lengths and model
parameters are taken as given; ``--ar-optimize`` additionally re-optimizes
them by maximum likelihood (``ipk_tpu/ar/optimize.py``), mirroring
raxml-ng's ``--opt-model on --opt-branches on``. Either way posteriors are
*not* numerically comparable to a raxml-ng run (different optimizer paths),
only structurally.

Computation: standard two-pass algorithm as batched matmuls.
* inside pass (postorder): per-category partial likelihoods
  ``L_v[c, site, state]``, leaves one-hot (all-ones for gaps/ambiguity —
  the reference treats ambiguity as gaps during AR, ``alignment.cpp:217-224``),
  internal ``L_v = Π_children P(t_child r_c) @ L_child``, with per-node
  rescaling to avoid underflow.
* outside pass (preorder): ``G_child = P(t)^T @ (G_v ⊙ Π_siblings ...)``.
* posterior at v: ``Σ_c w_c π ⊙ G_v ⊙ L_v`` normalized per site.

Transition matrices via symmetrized eigendecomposition of the GTR rate
matrix; all per-site work is batched ``[sites, σ] @ [σ, σ]`` matmuls.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..seq import SeqTraits, DNA
from ..tree import PhyloTree, PhyloNode, postorder, to_newick
from ..alignment import Alignment

__all__ = ["gtr_eigendecomposition", "gamma_category_rates",
           "ancestral_posteriors", "run_native_ar", "empirical_frequencies"]

#: f32 matmuls at full precision: a GPU may otherwise multiply in TF32
#: (about three decimal digits), and the posteriors would drift from the
#: CPU's — a survivor set depends on which side of the threshold they fall
_HIGHEST = jax.lax.Precision.HIGHEST


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


def ancestral_posteriors(tree: PhyloTree, align: Alignment,
                         traits: SeqTraits = DNA, alpha: float = 1.0,
                         categories: int = 4,
                         rates: Optional[np.ndarray] = None,
                         freqs: Optional[np.ndarray] = None
                         ) -> Tuple[List[PhyloNode], np.ndarray]:
    """Marginal posterior state distributions for every internal node.

    Returns (internal nodes in postorder, posteriors [n_internal, sites, σ]).
    """
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

    lam_j = jnp.asarray(lam, jnp.float32)
    U_j = jnp.asarray(U, jnp.float32)
    Ui_j = jnp.asarray(U_inv, jnp.float32)
    pi_j = jnp.asarray(freqs, jnp.float32)

    @jax.jit
    def trans(t_scaled):
        """P(t) for one scaled branch length: [σ, σ], rows = from-state."""
        return jnp.matmul(U_j * jnp.exp(lam_j * t_scaled)[None, :], Ui_j,
                          precision=_HIGHEST)

    # transition matrices for every (node, category)
    bl = np.array([n.branch_length for n in nodes], dtype=np.float32)
    T = np.einsum("c,n->nc", cat_rates.astype(np.float32), bl)
    P_mats = jax.vmap(jax.vmap(trans))(jnp.asarray(T))      # [n, cat, σ, σ]
    P_mats = jnp.clip(P_mats, 0.0, None)

    # ---- inside (postorder) ----------------------------------------------
    # L[v]: [cat, S, σ]; rescaled per node
    L: List[jnp.ndarray] = [None] * len(nodes)

    @jax.jit
    def child_message(P_child, L_child):
        # [cat, S, σ] x [cat, σ, σ] -> [cat, S, σ]: sum over child states
        return jnp.einsum("cxy,csy->csx", P_child, L_child,
                          precision=_HIGHEST)

    @jax.jit
    def normalize(Lv):
        scale = jnp.maximum(Lv.max(axis=(0, 2), keepdims=True), 1e-30)
        return Lv / scale

    for v in nodes:
        i = index[id(v)]
        if v.is_leaf():
            leaf = leaves.get(v.label)
            if leaf is None:
                leaf = np.ones((S, sigma), dtype=np.float32)
            L[i] = jnp.broadcast_to(jnp.asarray(leaf), (n_cat, S, sigma))
        else:
            acc = jnp.ones((n_cat, S, sigma), dtype=jnp.float32)
            for ch in v.children:
                j = index[id(ch)]
                acc = acc * child_message(P_mats[j], L[j])
            L[i] = normalize(acc)

    # ---- outside (preorder) ----------------------------------------------
    # the stationary prior π enters exactly once, at the root, and propagates
    # down through the outside messages
    G: List[jnp.ndarray] = [None] * len(nodes)
    G[index[id(tree.root)]] = jnp.broadcast_to(
        pi_j[None, None, :], (n_cat, S, sigma))

    @jax.jit
    def down_message(P_child, upper):
        # [cat, S, σ(parent)] through P_child^T -> [cat, S, σ(child)]
        return jnp.einsum("cxy,csx->csy", P_child, upper,
                          precision=_HIGHEST)

    for v in nodes[::-1]:           # preorder-ish: parents before children
        i = index[id(v)]
        if v.is_leaf():
            continue
        for ch in v.children:
            j = index[id(ch)]
            upper = G[i]
            for sib in v.children:
                if sib is ch:
                    continue
                sj = index[id(sib)]
                upper = upper * child_message(P_mats[sj], L[sj])
            G[j] = normalize(down_message(P_mats[j], upper))

    # ---- posteriors -------------------------------------------------------
    internal = [v for v in nodes if not v.is_leaf()]

    @jax.jit
    def posterior(Lv, Gv):
        post = (Lv * Gv).sum(axis=0)                         # sum categories
        return post / jnp.maximum(post.sum(axis=1, keepdims=True), 1e-30)

    posts = np.stack([np.asarray(posterior(L[index[id(v)]],
                                           G[index[id(v)]]))
                      for v in internal])
    return internal, posts


def run_native_ar(extended_tree: PhyloTree, align: Alignment,
                  working_dir: str, traits: SeqTraits = DNA,
                  alpha: float = 1.0, categories: int = 4,
                  optimize: bool = False, opt_steps: int = 200,
                  verbosity: int = 1) -> Tuple[str, str]:
    """Compute posteriors and write raxml-ng-format artifacts under
    ``<workdir>/AR/`` (probs TSV + labeled tree). Returns their paths.

    With ``optimize=True``, branch lengths / GTR rates / Γ alpha are first
    ML-fitted on device (the native analog of raxml-ng's ``--opt-model on
    --opt-branches on``, ``ar.cpp:684``); the optimized branch lengths are
    written into the ancestralTree artifact, as raxml-ng does.
    """
    from .reader import RAXML_AA_ORDER, aa_permutation

    ar_dir = os.path.join(working_dir, "AR")
    os.makedirs(ar_dir, exist_ok=True)

    rates = None
    freqs = None
    source_tree = extended_tree
    if optimize:
        from .optimize import optimize_parameters, apply_branch_lengths
        result = optimize_parameters(
            extended_tree, align, traits, alpha=alpha, categories=categories,
            steps=opt_steps, verbosity=verbosity)
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
                                           alpha, categories,
                                           rates=rates, freqs=freqs)
    # file columns are in raxml order; our tensors are in i2l order — invert
    # the read-side permutation for amino acids (reader.py applies it again)
    if traits.alphabet_size == 20:
        inv = np.argsort(aa_permutation())
        posts_out = posts[:, :, inv]
        letters = RAXML_AA_ORDER
    else:
        posts_out = posts
        letters = traits.letters

    probs_path = os.path.join(ar_dir, "native.raxml.ancestralProbs")
    with open(probs_path, "w") as f:
        f.write("Node\tSite\tState\t" +
                "\t".join(f"p_{c}" for c in letters) + "\n")
        for vi, node in enumerate(internal):
            block = posts_out[vi]
            states = np.asarray(list(letters))[block.argmax(axis=1)]
            for site in range(block.shape[0]):
                row = "\t".join(f"{p:.9f}" for p in block[site])
                f.write(f"Node{vi}\t{site + 1}\t{states[site]}\t{row}\n")
    return probs_path, tree_path
