"""The Triton dense combine vs the jnp dense path (interpret mode on CPU;
``test_gpu.py`` runs the compiled kernel on the card)."""

import functools

import jax
import numpy as np
import pytest

from ipk_tpu.core import dense
from ipk_tpu.core.pallas_kernels import combine_max


def accumulate_ghosts_fused(P_all, prefix_all, eps, *, k, sigma,
                            with_count=False, **tiles):
    """Halves in XLA, combine in the Triton kernel (interpret mode):
    P_all [G, S, sigma] → A[G, sigma^k] (+ per-ghost tuple counts)."""
    halves = jax.vmap(functools.partial(dense.masked_halves, k=k,
                                        sigma=sigma), in_axes=(0, 0, None))
    L, R = halves(P_all, prefix_all, eps)
    out = combine_max(L, R, eps, with_count=with_count, interpret=True,
                      **tiles)
    G = P_all.shape[0]
    if with_count:
        A, counts = out
        return A.reshape(G, -1), counts
    return out.reshape(G, -1)


def make_inputs(rng, G, S, sigma=4):
    p = rng.dirichlet(np.ones(sigma) * 0.4, size=(G, S)).astype(np.float32)
    P = np.log10(np.maximum(p, 1e-30)).astype(np.float32)
    return P, dense.best_score_prefix(P)


def eps_for(omega, sigma, k):
    return np.float32(np.log10((omega / sigma) ** k))


def test_masked_halves_reconstruct_window_block():
    """L ⊕ R with the constant top threshold == score_window_block."""
    rng = np.random.default_rng(0)
    k, sigma, S = 6, 4, 24
    P, prefix = make_inputs(rng, 1, S)
    P, prefix = P[0], prefix[0]
    eps = eps_for(1.5, sigma, k)
    W = S - k + 1
    L, R = dense.masked_halves(P, prefix, eps, k=k, sigma=sigma)
    L, R = np.asarray(L), np.asarray(R)
    T_ref = np.asarray(dense.score_window_block(
        P, prefix, 0, k=k, sigma=sigma, log_threshold=eps, block_w=W))
    T = (L[:, :, None] + R[:, None, :]).reshape(W, -1)
    T = np.where(T > eps, T, -np.inf)
    np.testing.assert_array_equal(T, T_ref)


@pytest.mark.parametrize("k,block_i", [(4, 4), (6, 8), (7, 16), (8, 64)])
def test_fused_matches_jnp_path(k, block_i):
    rng = np.random.default_rng(k)
    sigma, G, S = 4, 6, 20
    P_all, prefix_all = make_inputs(rng, G, S)
    eps = eps_for(1.5, sigma, k)
    A_ref = np.asarray(dense.accumulate_ghosts(P_all, prefix_all, eps,
                                               k=k, sigma=sigma))
    A = np.asarray(accumulate_ghosts_fused(P_all, prefix_all, eps, k=k,
                                           sigma=sigma, block_i=block_i,
                                           block_j=2 * block_i))
    np.testing.assert_array_equal(A, A_ref)


def test_fused_counts_match():
    rng = np.random.default_rng(42)
    k, sigma, G, S = 5, 4, 4, 18
    P_all, prefix_all = make_inputs(rng, G, S)
    eps = eps_for(1.5, sigma, k)
    _, counts_ref = dense.accumulate_ghosts(P_all, prefix_all, eps, k=k,
                                            sigma=sigma, with_count=True)
    A, counts = accumulate_ghosts_fused(P_all, prefix_all, eps, k=k,
                                        sigma=sigma, block_i=8, block_j=16,
                                        with_count=True)
    np.testing.assert_array_equal(np.asarray(counts, dtype=np.int64),
                                  np.asarray(counts_ref, dtype=np.int64))


def test_fused_aa_alphabet():
    """σ=20: candidate axes (20, 400) are not multiples of the tile and are
    padded with inert -inf columns."""
    rng = np.random.default_rng(3)
    k, sigma, G, S = 3, 20, 2, 12
    P_all, prefix_all = make_inputs(rng, G, S, sigma)
    eps = eps_for(4.0, sigma, k)
    A_ref = np.asarray(dense.accumulate_ghosts(P_all, prefix_all, eps,
                                               k=k, sigma=sigma))
    A = np.asarray(accumulate_ghosts_fused(P_all, prefix_all, eps, k=k,
                                           sigma=sigma))
    np.testing.assert_array_equal(A, A_ref)


def test_combine_max_window_padding():
    """Candidate axes not divisible by the tile (nl=12, nr=20 against
    8x16 tiles): padded columns must not contribute, and an odd window
    count needs no padding at all (the window loop runs in the kernel)."""
    rng = np.random.default_rng(9)
    G, W, nl, nr = 2, 5, 12, 20
    L = rng.normal(size=(G, W, nl)).astype(np.float32)
    R = rng.normal(size=(G, W, nr)).astype(np.float32)
    eps = np.float32(-100.0)
    A, counts = combine_max(L, R, eps, block_i=8, block_j=16,
                            with_count=True, interpret=True)
    expected = (L[:, :, :, None] + R[:, :, None, :]).max(axis=1)
    np.testing.assert_array_equal(np.asarray(A), expected)
    np.testing.assert_array_equal(np.asarray(counts), [W * nl * nr] * G)


def test_combine_max_nr_blocking():
    """A wide candidate-pair space is gridded into many tiles along both
    axes (here a key-batch-like slice of L against a wide R, as the
    key-batched k=10 build produces); values and counts must match the
    plain XLA path."""
    import jax.numpy as jnp
    from ipk_tpu.core.dense import combine_max_jnp

    rng = np.random.default_rng(3)
    k, sigma, G, S = 10, 4, 2, 24
    P_all, prefix_all = make_inputs(rng, G, S)
    eps = eps_for(1.2, sigma, k)
    L, R = [], []
    for g in range(G):
        Lg, Rg = dense.masked_halves(P_all[g], prefix_all[g], eps,
                                     k=k, sigma=sigma)
        L.append(np.asarray(Lg))
        R.append(np.asarray(Rg))
    L, R = jnp.asarray(np.stack(L)), jnp.asarray(np.stack(R))
    # one key batch of four: 256 x 1024 candidates -> a 4 x 8 tile grid
    L = L[:, :, 256:512]
    A_ref = np.asarray(combine_max_jnp(L, R, eps))
    A, counts = combine_max(L, R, eps, block_i=64, block_j=128,
                            with_count=True, interpret=True)
    np.testing.assert_array_equal(np.asarray(A), A_ref)
    count_ref = int((np.asarray(L)[:, :, :, None] + np.asarray(R)[:, :, None, :]
                     > eps).sum())
    assert int(np.asarray(counts).astype(np.int64).sum()) == count_ref
