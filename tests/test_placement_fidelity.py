"""Placement fidelity quantification.

``ipk_tpu.placement`` claims to implement the published EPIK scoring scheme
(phylo-k-mer placement: per branch, the product over query windows of the
stored posterior score — threshold ``(omega/sigma)^k`` where absent — ranked
by likelihood weight ratio). This file pins that claim to numbers:

* an INDEPENDENT from-first-principles scorer (dict lookups, pure python,
  no shared code with ``placement.py``) implements the published formula;
* top-1 agreement and full-ranking agreement between it and both
  production scorers (host vectorized + device batch) are asserted to be 100%
  on a randomized fixture set, and the likelihood-weight-ratios to agree
  within f32 tolerance.

Deviations from the real EPIK binary that remain (documented, not hidden):
no ``--mu`` DB subsetting at load (the DB carries the full MI order; EPIK
applies mu downstream — ``CHANGELOG.txt`` v0.5.0), and no reverse-strand
pass (callers place each strand explicitly).
"""

import numpy as np

from ipk_tpu.db import PhyloKmerDB
from ipk_tpu.placement import PlacementIndex, DevicePlacementIndex
from ipk_tpu.core.filter import score_threshold


def naive_published_score(db: PhyloKmerDB, seq: str):
    """The published scheme, written independently: for every k-length
    window of the query (skipping windows with non-ACGT characters), every
    branch accumulates log10 of its stored score for that k-mer, or
    log10((omega/sigma)^k) if the (k-mer, branch) pair is absent — including
    k-mers absent from the DB entirely. Branches ranked by the total."""
    k = db.kmer_size
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    thr = np.log10(score_threshold(db.omega, 4, k))
    table = {}
    for i, key in enumerate(db.keys.tolist()):
        lo, hi = int(db.offsets[i]), int(db.offsets[i + 1])
        table[key] = {int(b): float(s) for b, s in
                      zip(db.branches[lo:hi], db.scores[lo:hi])}
    branches = sorted({int(b) for b in db.branches})
    totals = {b: 0.0 for b in branches}
    for w in range(len(seq) - k + 1):
        window = seq[w:w + k]
        if any(c not in code for c in window):
            continue
        key = 0
        for c in window:
            key = (key << 2) | code[c]
        entries = table.get(key, {})
        for b in branches:
            totals[b] += entries.get(b, thr)
    return totals


def make_db(rng, K=400, B=24, k=6):
    space = 4 ** k
    keys = np.sort(rng.permutation(space)[:K].astype(np.uint64))
    counts = rng.integers(1, 6, size=K)
    offsets = np.zeros(K + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    E = int(counts.sum())
    branches = np.empty(E, np.uint32)
    for i in range(K):
        # distinct branches per key (the DB invariant)
        branches[offsets[i]:offsets[i + 1]] = rng.choice(
            B, size=counts[i], replace=False)
    scores = rng.uniform(-4.0, -0.1, size=E).astype(np.float32)
    db = PhyloKmerDB(k, 1.5, "nucl", "(a,b)r;", [])
    db.set_data(keys, np.zeros(K, np.float32), offsets, branches, scores)
    return db


def make_queries(rng, db, n=40, L=60):
    """Half random reads, half stitched from DB k-mers (so hits dominate)."""
    k = db.kmer_size
    alpha = "ACGT"
    out = []
    for i in range(n):
        if i % 2 == 0:
            out.append("".join(rng.choice(list(alpha), size=L)))
        else:
            parts = []
            for key in rng.choice(db.keys, size=L // k):
                sym = []
                v = int(key)
                for _ in range(k):
                    sym.append(alpha[v & 3])
                    v >>= 2
                parts.append("".join(reversed(sym)))
            out.append("".join(parts)[:L])
    # one query with ambiguity characters (skipped windows)
    out[0] = out[0][:20] + "NN-" + out[0][23:]
    return out


def test_production_scorers_match_published_formula():
    rng = np.random.default_rng(11)
    db = make_db(rng)
    queries = make_queries(rng, db)
    host = PlacementIndex(db)
    dev = DevicePlacementIndex(db)
    ids_t, totals_t, _ = dev.place_batch(queries)

    top1_agree = 0
    for qi, seq in enumerate(queries):
        ref = naive_published_score(db, seq)
        ids_h, totals_h, _ = host.score_query(seq)
        ref_vec = np.array([ref[int(b)] for b in ids_h])
        # full per-branch totals match the published formula (f64 host)
        np.testing.assert_allclose(totals_h, ref_vec, rtol=1e-10,
                                   atol=1e-9)
        # device batch scorer: f32 accumulation of the same totals
        np.testing.assert_allclose(totals_t[qi], ref_vec, rtol=1e-4,
                                   atol=5e-3)
        ref_top = max(ref, key=lambda b: ref[b])
        top1_agree += int(ids_h[np.argmax(totals_h)] == ref_top)
    # the fidelity number: full agreement on the fixture
    assert top1_agree == len(queries)


def test_ranking_and_weight_ratio_agreement():
    rng = np.random.default_rng(12)
    db = make_db(rng, K=250, B=16)
    queries = make_queries(rng, db, n=16, L=48)
    from ipk_tpu.placement import place_queries
    ph = place_queries(db, [(f"q{i}", s) for i, s in enumerate(queries)],
                       top=5, engine="host")
    pt = place_queries(db, [(f"q{i}", s) for i, s in enumerate(queries)],
                       top=5, engine="device")
    assert len(ph) == len(pt)
    top1 = sum(int(a["p"][0][0] == b["p"][0][0]) for a, b in zip(ph, pt))
    assert top1 == len(ph)                      # 100% top-1 agreement
    for a, b in zip(ph, pt):
        wa = np.array([row[2] for row in a["p"]])
        wb = np.array([row[2] for row in b["p"]])
        np.testing.assert_allclose(wa, wb, rtol=1e-3, atol=1e-4)
