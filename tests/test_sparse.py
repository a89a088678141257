"""Sparse (capacity-bounded) enumeration vs the dense path and the oracle."""

import numpy as np
import pytest

from ipk_tpu.core import dense
from ipk_tpu.core.sparse import enumerate_sparse, merge_window_lists
from ipk_tpu.seq import DNA, AA, key_to_dense_index

from oracle_dcla import dcla_matrix_max


def make_P(rng, S, sigma=4):
    p = rng.dirichlet(np.ones(sigma) * 0.4, size=S).astype(np.float32)
    P = np.log10(np.maximum(p, 1e-30)).astype(np.float32)
    return P, dense.best_score_prefix(P)


def eps_for(omega, sigma, k):
    return np.float32(np.log10((omega / sigma) ** k))


@pytest.mark.parametrize("k,cap", [(4, 16), (5, 64), (6, 256), (7, 4096)])
def test_sparse_matches_dense(k, cap):
    rng = np.random.default_rng(k)
    sigma, S = 4, 24
    P, prefix = make_P(rng, S, sigma)
    eps = eps_for(1.5, sigma, k)
    codes, scores, overflow = enumerate_sparse(
        P, prefix, eps, k=k, sigma=sigma, bits=2, cap=cap)
    merged_c, merged_s = merge_window_lists(codes, scores)

    A = np.asarray(dense.accumulate_matrix(P, prefix, eps, k=k, sigma=sigma))
    dense_keys = np.flatnonzero(np.isfinite(A)).astype(np.uint64)
    if overflow:
        pytest.skip(f"cap {cap} overflowed for k={k}; covered by other params")
    np.testing.assert_array_equal(merged_c, dense_keys)
    np.testing.assert_array_equal(merged_s, A[dense_keys])


def test_sparse_overflow_detection():
    rng = np.random.default_rng(0)
    P, prefix = make_P(rng, 16)
    # omega tiny -> everything survives -> 4^4=256 survivors > cap=16
    eps = eps_for(1e-6, 4, 4)
    _, _, overflow = enumerate_sparse(P, prefix, eps, k=4, sigma=4, bits=2,
                                      cap=16)
    assert overflow
    # generous cap: no overflow
    _, _, overflow = enumerate_sparse(P, prefix, eps, k=4, sigma=4, bits=2,
                                      cap=256)
    assert not overflow


def test_sparse_vs_oracle_insert_or_max():
    rng = np.random.default_rng(5)
    k, sigma = 6, 4
    P, prefix = make_P(rng, 20, sigma)
    eps = eps_for(1.5, sigma, k)
    codes, scores, overflow = enumerate_sparse(P, prefix, eps, k=k,
                                               sigma=sigma, bits=2, cap=4096)
    assert not overflow
    merged_c, merged_s = merge_window_lists(codes, scores)
    expected = dcla_matrix_max(P, k, eps, bits=2)
    assert {int(c) for c in merged_c} == set(expected)
    for c, s in zip(merged_c, merged_s):
        assert np.float32(expected[int(c)]) == s


def test_sparse_large_k_codes_are_64bit():
    """k=20 DNA needs 40-bit codes: verify no truncation."""
    rng = np.random.default_rng(1)
    k = 20
    P, prefix = make_P(rng, 26)
    # very high omega -> few survivors
    eps = eps_for(3.2, 4, k)
    codes, scores, overflow = enumerate_sparse(P, prefix, eps, k=k, sigma=4,
                                               bits=2, cap=1024)
    assert not overflow
    merged_c, merged_s = merge_window_lists(codes, scores)
    if len(merged_c):
        assert merged_c.dtype == np.uint64
        # the top-scoring k-mer should be the argmax path of some window
        w = 0
        best = int("".join(str(np.argmax(P[w + i])) for i in range(k)), 4)
        # (best survives iff its score > eps; check membership consistently)
        score = np.float32(sum(np.float32(P[w + i].max()) for i in range(k)))
        if score > eps:
            assert best in set(int(c) for c in merged_c)


def test_sparse_aa():
    rng = np.random.default_rng(2)
    k, sigma = 4, 20
    P, prefix = make_P(rng, 12, sigma)
    eps = eps_for(6.0, sigma, k)
    codes, scores, overflow = enumerate_sparse(P, prefix, eps, k=k,
                                               sigma=sigma, bits=5, cap=4096)
    assert not overflow
    merged_c, merged_s = merge_window_lists(codes, scores)
    A = np.asarray(dense.accumulate_matrix(P, prefix, eps, k=k, sigma=sigma))
    dense_idx = np.flatnonzero(np.isfinite(A)).astype(np.uint64)
    got_idx = key_to_dense_index(merged_c, k, AA)
    np.testing.assert_array_equal(np.sort(got_idx), dense_idx)


def test_enumerate_sparse_many_matches_per_ghost():
    from ipk_tpu.core.sparse import enumerate_sparse, enumerate_sparse_many
    from ipk_tpu.core import dense as dense_mod

    rng = np.random.default_rng(5)
    k, sigma, bits, cap = 6, 4, 2, 512
    G, S = 3, 20
    p = rng.dirichlet(np.ones(sigma) * 0.4, size=(G, S)).astype(np.float32)
    P = np.log10(np.maximum(p, 1e-30)).astype(np.float32)
    prefix = dense_mod.best_score_prefix(P)
    eps = np.float32(np.log10((1.5 / sigma) ** k))
    codes_b, scores_b, ovf_b = enumerate_sparse_many(
        P, prefix, eps, k=k, sigma=sigma, bits=bits, cap=cap)
    assert codes_b.shape[0] == G and not ovf_b.any()
    for g in range(G):
        codes, scores, ovf = enumerate_sparse(
            P[g], prefix[g], eps, k=k, sigma=sigma, bits=bits, cap=cap)
        assert not ovf
        # identical survivor sets + scores per window (slot order may differ
        # only when capacities differ; same cap -> same shapes)
        for w in range(scores.shape[0]):
            ref = {(int(c), float(s)) for c, s in
                   zip(codes[w], scores[w]) if np.isfinite(s)}
            got = {(int(c), float(s)) for c, s in
                   zip(codes_b[g, w], scores_b[g, w]) if np.isfinite(s)}
            assert got == ref


def test_skewed_hot_window_bounded_redispatch():
    """One hot window the probe never samples: capacity adaptation must
    re-dispatch a bounded number of times (per-span doublings), not once
    per chunk x span, and the result must stay overflow-free."""
    from ipk_tpu.core import dense as dense_mod
    from ipk_tpu.core.sparse import enumerate_sparse_many, probe_caps, _spans

    k, sigma, bits, cap = 6, 4, 2, 4096
    G, S = 4, 200
    # near-one-hot background: ~1 survivor per window
    P = np.full((G, S, sigma), np.log10(0.01), np.float32)
    P[:, :, 0] = np.log10(np.float32(0.97))
    # hot run on ghost 3 at sites 40..47 (windows ~33-47; the probe samples
    # windows [0, 17, 34, 52, ...] — none fully inside the hot run)
    P[3, 40:48, :] = np.log10(np.float32(0.005))
    P[3, 40:48, 0] = np.log10(np.float32(0.33))
    P[3, 40:48, 1] = np.log10(np.float32(0.33))
    P[3, 40:48, 2] = np.log10(np.float32(0.33))
    prefix = dense_mod.best_score_prefix(P)
    eps = np.float32(np.log10((1.0 / sigma) ** k))

    caps = probe_caps(P, prefix, eps, k=k, sigma=sigma, cap=cap)
    stats = {}
    codes, scores, ovf = enumerate_sparse_many(
        P, prefix, eps, k=k, sigma=sigma, bits=bits, cap=cap, caps=caps,
        stats=stats)
    assert not ovf.any()
    # the fully-hot windows have 3^6 = 729 survivors
    counts = np.isfinite(scores).sum(axis=2)
    assert counts[3].max() >= 729
    # each span can double from its probe cap to the ceiling at most
    # log2(cap/128) times; re-dispatches are bounded by the total doublings
    import math
    bound = len(_spans(k)) * (int(math.log2(cap // 128)) + 1)
    assert 1 <= stats.get("redispatches", 0) <= bound, stats


def test_sparse_rejects_over_wide_half_windows():
    """AA k=13 would need 35-bit half-window codes (and 65-bit keys) —
    the library API must fail loudly, not truncate (the CLI already
    rejects it via seq traits max_kmer_length)."""
    from ipk_tpu.core.sparse import enumerate_sparse_many

    P = np.zeros((1, 20, 20), np.float32)
    prefix = dense.best_score_prefix(P)
    with pytest.raises(ValueError, match="half-window code budget"):
        enumerate_sparse_many(P, prefix, np.float32(-1), k=13, sigma=20,
                              bits=5, cap=128)
