"""External correctness anchor: the C++ clean-room DCLA implementation
(``native/baseline_dcla.cpp``) emits its merged per-group survivor sets and
both device enumeration paths (dense accumulator and sparse capacity-bounded
lists) must agree BIT-EXACTLY — same key sets, same f32 score bits.

This is the gate the reference gets from its golden-DB test
(``tests/test-db-build.sh:52-101``): an implementation-independent oracle,
not the framework checked against itself.
"""

import os

import numpy as np
import pytest

from ipk_tpu.core import dense
from ipk_tpu.core import sparse as sparse_mod
from ipk_tpu.seq import dense_index_to_key, DNA, AA

from cpp_oracle import oracle_full, oracle_survivors


def dense_survivors(P, prefix, k, sigma, eps, traits):
    """Dense path per-group merged survivors as {packed_key: score}."""
    A = dense.accumulate_ghosts(P, prefix, eps, k=k, sigma=sigma, block_w=8)
    A = np.asarray(dense.group_max(A, 2))
    groups = []
    for b in range(A.shape[0]):
        idx = np.flatnonzero(np.isfinite(A[b]))
        keys = dense_index_to_key(idx.astype(np.uint64), k, traits)
        groups.append(dict(zip(keys.tolist(), A[b, idx])))
    return groups


def sparse_survivors(P, prefix, k, sigma, bits, eps, cap=8192):
    codes, scores, overflow = sparse_mod.enumerate_sparse_many(
        P, prefix, eps, k=k, sigma=sigma, bits=bits, cap=cap)
    assert not overflow.any()
    groups = []
    for b in range(P.shape[0] // 2):
        c, s = sparse_mod.merge_window_lists(codes[2 * b:2 * b + 2],
                                             scores[2 * b:2 * b + 2])
        groups.append(dict(zip(c.tolist(), s)))
    return groups


def assert_groups_bitequal(got, expected, tag):
    assert len(got) == len(expected)
    for b, (g, e) in enumerate(zip(got, expected)):
        assert set(g) == set(e), (
            f"{tag} group {b}: key sets differ "
            f"(+{sorted(set(g) - set(e))[:5]} -{sorted(set(e) - set(g))[:5]})")
        for key, score in e.items():
            assert np.float32(g[key]).view(np.uint32) == \
                np.float32(score).view(np.uint32), (
                    f"{tag} group {b} key {key}: "
                    f"{g[key]!r} != {score!r} (bit mismatch)")


@pytest.mark.parametrize("k,sigma,omega,paths", [
    (5, 4, 1.5, ("dense", "sparse")),
    (8, 4, 1.5, ("dense", "sparse")),
    (11, 4, 2.0, ("sparse",)),            # dense 4^11 too large for CPU CI
    (4, 20, 4.0, ("dense", "sparse")),
    (5, 20, 5.0, ("sparse",)),
    (8, 20, 10.0, ("sparse",)),
])
def test_paths_match_cpp_oracle(k, sigma, omega, paths):
    rng = np.random.default_rng(100 + k * 7 + sigma)
    G, S = 4, k + 9                       # 2 groups, 10 windows
    # near-one-hot columns for large (omega, k): flat Dirichlet columns keep
    # zero survivors there (real AR posteriors are peaked)
    conc = 0.05 if omega / sigma * 2 > 0.5 else 0.3
    p = rng.dirichlet(np.ones(sigma) * conc, size=(G, S)).astype(np.float32)
    P = np.log10(np.maximum(p, 1e-30)).astype(np.float32)
    eps = np.float32(np.log10((omega / sigma) ** k))
    prefix = dense.best_score_prefix(P)

    expected, stats = oracle_survivors(P, k, sigma, eps)
    assert sum(len(g) for g in expected) == stats["entries"]
    assert stats["entries"] > 0, "degenerate test workload"

    traits = DNA if sigma == 4 else AA
    if "dense" in paths:
        got = dense_survivors(P, prefix, k, sigma, eps, traits)
        assert_groups_bitequal(got, expected, f"dense k={k} σ={sigma}")
    if "sparse" in paths:
        got = sparse_survivors(P, prefix, k, sigma, traits.bits_per_symbol,
                               eps)
        assert_groups_bitequal(got, expected, f"sparse k={k} σ={sigma}")


# ---------------------------------------------------------------------------
# r5: full-pipeline anchor (verdict item 2) — the oracle's emit=2 mode runs
# stages 1-3 (enumeration + merge + mif0 + (fv, key) ordering) and the
# framework's COMPLETE DB content must match it bit-for-bit, on the dense
# and the sparse production paths alike.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("states,k,omega", [
    ("nucl", 8, 1.5),     # DNA: 2-bit packing
    ("amino", 4, 4.0),    # AA: 5-bit packing + RAPPAS column permutation
                          # (omega 4: the fixture's Dirichlet(0.5) columns
                          # keep ~0 survivors at the reference golden's
                          # omega=10)
])
def test_full_pipeline_matches_cpp_oracle(tmp_path, states, k, omega):
    import pathlib
    from fixtures import make_project
    from ipk_tpu import tree as tr
    from ipk_tpu.ar.mapping import (gather_ghost_tensor, ghost_groups,
                                    map_nodes)
    from ipk_tpu.ar.reader import read_ancestral_probs
    from ipk_tpu.builder import build, log_threshold_f32
    from ipk_tpu.core.filter import score_threshold

    traits = DNA if states == "nucl" else AA
    sigma = traits.alphabet_size
    tree_file, fasta_file, ar_dir = make_project(
        pathlib.Path(tmp_path), num_leaves=6, width=30, seed=31,
        traits=traits)
    original_tree, extended_tree, ghost_mapping = tr.preprocess_tree(
        tree_file, False)
    ar_tree = tr.load_newick(
        os.path.join(ar_dir, "align.raxml.ancestralTree"))
    if original_tree.is_rooted() and not ar_tree.is_rooted():
        tr.reroot_tree(ar_tree)
    ar_mapping = map_nodes(extended_tree, ar_tree)
    label_rows, P = read_ancestral_probs(
        os.path.join(ar_dir, "align.raxml.ancestralProbs"), traits)
    groups, group_ids = ghost_groups(extended_tree, original_tree,
                                     ghost_mapping, "both")
    P_all = np.ascontiguousarray(
        gather_ghost_tensor(groups, ar_mapping, label_rows, P),
        dtype=np.float32)
    eps = log_threshold_f32(omega, sigma, k)
    n_total = original_tree.get_node_count()
    thr = score_threshold(omega, sigma, k)

    rows, stats = oracle_full(P_all, k, sigma, eps, n_total, thr, group_ids)
    assert stats["entries"] > 0

    for sparse in (False, True):
        result = build(
            original_tree, extended_tree, ghost_mapping, ar_mapping,
            label_rows, P, traits=traits, kmer_size=k, omega=omega,
            sparse=sparse, verbose=0)
        db = result.db
        assert result.num_explored == stats["tuples"]
        tag = "sparse" if sparse else "dense"
        assert db.size() == len(rows), tag
        o_keys = np.array([r[0] for r in rows], np.uint64)
        np.testing.assert_array_equal(db.keys, o_keys, err_msg=tag)
        # filter values: the DB's f32 column vs the oracle's f64 mif0 after
        # the f32 cast. numpy's SIMD pow/log2 round differently from libm in
        # the last f64 bit (documented in native/mif0_filter.cpp and bounded
        # by tests/test_filter.py); for ~1e-5 of keys that straddles an f32
        # rounding boundary, so the column gate allows <=2 f32 ulp. The ROW
        # ORDER (sorted on the f64 values) matched exactly above, which is
        # the stronger check.
        o_fv = np.array([r[1] for r in rows]).astype(np.float32)
        ulp = np.abs(db.filter_values.view(np.uint32).astype(np.int64)
                     - o_fv.view(np.uint32).astype(np.int64))
        assert ulp.max() <= 2, f"{tag}: fv off by {ulp.max()} ulp"
        assert (ulp > 0).mean() < 1e-3, \
            f"{tag}: {(ulp > 0).sum()} fv values differ"
        counts = np.diff(db.offsets)
        np.testing.assert_array_equal(
            counts, [len(r[2]) for r in rows], err_msg=tag)
        o_br = np.concatenate([[e[0] for e in r[2]] for r in rows])
        o_sc = np.concatenate([[e[1] for e in r[2]] for r in rows])
        np.testing.assert_array_equal(db.branches, o_br.astype(np.uint32),
                                      err_msg=tag)
        np.testing.assert_array_equal(db.scores.view(np.uint32),
                                      o_sc.astype(np.uint32), err_msg=tag)
