"""Phylogenetic placement of query sequences against a phylo-k-mer DB.

A compact, self-contained consumer of the databases this framework builds —
the role EPIK plays downstream of the reference (``README.md:6-12`` of the
reference points IPK output at EPIK/SHERPAS). IPK itself does not place;
this module exists so built DBs can be validated end-to-end (the BASELINE.json
pod-scale config calls for "validated by EPIK placement on the merged DB")
and so users have a native query path.

Scoring model (EPIK's published weighted-ratio scheme): for a query, every
k-mer window that decodes cleanly (no ambiguity) contributes its stored
log10 score for each branch where present, and ``log10((omega/sigma)^k)`` for
branches where absent. Branches are ranked by total log score; output is
jplace v3 with edge numbers = original-tree postorder ids.

Fidelity is quantified, not asserted:
``tests/test_placement_fidelity.py`` checks both scorers below against an
independent from-first-principles implementation of the published formula —
100% top-1 agreement on the fixture set, host totals exact to f64, device
totals within f32 accumulation tolerance. Remaining deviations from the
EPIK binary, documented there: no ``--mu`` DB subsetting at load (EPIK
applies mu downstream; the DB carries the full MI order) and no implicit
reverse-strand pass.
"""

from __future__ import annotations

import functools
import json
from typing import Dict, Iterable, List, Tuple

import numpy as np

from .db import PhyloKmerDB
from .seq import get_traits
from .core.filter import score_threshold

__all__ = ["PlacementIndex", "place_queries", "write_jplace"]


class PlacementIndex:
    """Key-sorted view of a DB for vectorized batch lookups."""

    def __init__(self, db: PhyloKmerDB):
        self.db = db
        traits = get_traits(db.sequence_type)
        self.traits = traits
        self.k = db.kmer_size
        order = np.argsort(db.keys, kind="stable")
        self.sorted_keys = db.keys[order]
        # entries flattened in key-sorted order
        counts = np.diff(db.offsets)[order]
        self.entry_offsets = np.zeros(len(order) + 1, dtype=np.int64)
        np.cumsum(counts, out=self.entry_offsets[1:])
        gather = np.concatenate(
            [np.arange(db.offsets[i], db.offsets[i + 1]) for i in order]
        ) if len(order) else np.zeros(0, np.int64)
        self.entry_branches = db.branches[gather]
        self.entry_scores = db.scores[gather].astype(np.float64)
        # branch id -> dense column
        self.branch_ids = np.unique(db.branches)
        self.branch_col = {int(b): i for i, b in enumerate(self.branch_ids)}
        self._col_lut = np.zeros(int(self.branch_ids.max()) + 1
                                 if len(self.branch_ids) else 1,
                                 dtype=np.int64)
        self._col_lut[self.branch_ids] = np.arange(len(self.branch_ids))
        self._entry_cols = self._col_lut[self.entry_branches]
        self.log_threshold = np.log10(
            score_threshold(db.omega, traits.alphabet_size, db.kmer_size))

    def query_kmers(self, sequence: str) -> np.ndarray:
        """Packed keys of all clean k-length windows of the query."""
        lut = self.traits.codes_lut()
        codes = lut[np.frombuffer(sequence.encode("ascii"), np.uint8)]
        k = self.k
        if len(codes) < k:
            return np.zeros(0, dtype=np.uint64)
        win = np.lib.stride_tricks.sliding_window_view(codes, k)
        clean = (win >= 0).all(axis=1)
        win = win[clean].astype(np.uint64)
        bits = np.uint64(self.traits.bits_per_symbol)
        keys = np.zeros(len(win), dtype=np.uint64)
        for i in range(k):
            keys = (keys << bits) | win[:, i]
        return keys

    def score_query(self, sequence: str) -> Tuple[np.ndarray, np.ndarray, int]:
        """Per-branch total log10 score for one query.

        Returns (branch_ids, scores, num_query_kmers). Branches never seen in
        the DB keep the all-absent baseline.
        """
        keys = self.query_kmers(sequence)
        n_branch = len(self.branch_ids)
        total = np.full(n_branch, self.log_threshold * len(keys),
                        dtype=np.float64)
        if len(keys) == 0:
            return self.branch_ids, total, 0
        pos = np.searchsorted(self.sorted_keys, keys)
        pos = np.clip(pos, 0, len(self.sorted_keys) - 1)
        hit_pos = pos[self.sorted_keys[pos] == keys]
        if len(hit_pos):
            # expand [lo, hi) entry ranges of all hits without a Python loop
            lo = self.entry_offsets[hit_pos]
            lens = self.entry_offsets[hit_pos + 1] - lo
            starts = np.repeat(lo, lens)
            offs = (np.arange(lens.sum())
                    - np.repeat(np.cumsum(lens) - lens, lens))
            flat = starts + offs
            np.add.at(total, self._entry_cols[flat],
                      self.entry_scores[flat] - self.log_threshold)
        return self.branch_ids, total, len(keys)


class DevicePlacementIndex:
    """Device-resident placement index for batch serving.

    The DB becomes a dense score matrix ``M[K+2, B]`` in HBM: row r<K holds
    the r-th key's per-branch log scores with the threshold imputed for
    absent branches; row K is the all-threshold sentinel (k-mer not in the
    DB); row K+1 is all-zero (invalid window — ambiguity/gap — contributing
    nothing, matching the host scorer which skips such windows). Scoring a
    batch of queries is then one ``searchsorted`` + one gather + a window
    reduction on device — the serving-scale path (~10^5-10^6 reads per call).
    """

    def __init__(self, db: PhyloKmerDB):
        import jax
        import jax.numpy as jnp
        self._jnp = jnp
        self.host = PlacementIndex(db)
        h = self.host
        K = len(h.sorted_keys)
        B = len(h.branch_ids)
        M = np.full((K + 2, B), h.log_threshold, dtype=np.float32)
        rows = np.repeat(np.arange(K),
                         np.diff(h.entry_offsets).astype(np.int64))
        M[rows, h._entry_cols] = h.entry_scores.astype(np.float32)
        M[K + 1] = 0.0
        self.K = K
        self._M = jax.device_put(M)
        # dense key -> row LUT when the key space is small enough (DNA
        # k <= 13): one fancy-index gather replaces searchsorted, which is
        # the serving path's host bottleneck otherwise
        space = h.traits.alphabet_size ** h.k
        if space <= (1 << 26):
            self._row_lut = np.full(space, K, dtype=np.int32)
            self._row_lut[h.sorted_keys.astype(np.int64)] = np.arange(
                K, dtype=np.int32)
        else:
            self._row_lut = None

        @jax.jit
        def score(M_dev, rows):
            # rows [Q, W] int32 into M (K = miss sentinel, K+1 = invalid);
            # M must be an argument, not a closure capture — captured device
            # arrays are baked into the compile payload as constants
            return M_dev[rows].sum(axis=1)      # [Q, W, B] -> [Q, B]

        self._score = lambda rows: score(self._M, rows)

        @functools.partial(jax.jit, static_argnames=("top",))
        def score_topk(M_dev, rows, top):
            # rank on device and ship only the top-k (serving transfers
            # collapse from [Q, B] to [Q, top] — the difference between
            # being transfer-bound and memory-bound)
            totals = M_dev[rows].sum(axis=1)
            vals, idx = jax.lax.top_k(totals, top)
            return vals, idx

        self._score_topk = (
            lambda rows, top: score_topk(self._M, rows, top))

    def _rows(self, keys_pad: np.ndarray, valid_pad: np.ndarray) -> np.ndarray:
        """Map packed window keys to M rows (K = miss, K+1 = invalid)."""
        h = self.host
        if self._row_lut is not None:
            found = self._row_lut[keys_pad.astype(np.int64)]
            return np.where(valid_pad, found,
                            np.int32(self.K + 1)).astype(np.int32)
        pos = np.searchsorted(h.sorted_keys, keys_pad).clip(0, self.K - 1)
        hit = (h.sorted_keys[pos] == keys_pad) & valid_pad
        return np.where(hit, pos,
                        np.where(valid_pad, self.K, self.K + 1)
                        ).astype(np.int32)

    def _window_keys(self, sequences: List[str]):
        """Vectorized [Q, Wmax] packed keys + validity for a batch."""
        h = self.host
        k = h.k
        lut = h.traits.codes_lut()
        bits = np.uint64(h.traits.bits_per_symbol)
        Lmax = max((len(s) for s in sequences), default=k)
        Lmax = max(Lmax, k)
        if sequences and all(len(s) == Lmax for s in sequences):
            # uniform read length (the common serving case): one big decode
            buf = np.frombuffer("".join(sequences).encode("ascii"),
                                np.uint8).reshape(len(sequences), Lmax)
        else:
            # ragged: pad to Lmax with an invalid byte
            buf = np.full((len(sequences), Lmax), ord("-"), dtype=np.uint8)
            for qi, s in enumerate(sequences):
                buf[qi, :len(s)] = np.frombuffer(s.encode("ascii"), np.uint8)
        codes = lut[buf]                                    # [Q, Lmax]
        Q, W = len(sequences), Lmax - k + 1
        # validity via a cumulative bad-count (contiguous ops; the strided
        # sliding_window_view reduction is ~20x slower at serving scale)
        bad_count = np.zeros((Q, Lmax + 1), dtype=np.int32)
        np.cumsum(codes < 0, axis=1, out=bad_count[:, 1:])
        valid = (bad_count[:, k:] - bad_count[:, :-k]) == 0  # [Q, W]
        # rolling MSB-first packing: O(L) passes over [Q] columns
        cu = np.where(codes < 0, 0, codes).astype(np.uint64)
        mask = np.uint64((1 << (int(bits) * k)) - 1)
        acc = np.zeros(Q, dtype=np.uint64)
        keys = np.empty((Q, W), dtype=np.uint64)
        for j in range(Lmax):
            acc = ((acc << bits) | cu[:, j]) & mask
            if j >= k - 1:
                keys[:, j - k + 1] = acc
        return keys, valid

    def place_batch(self, sequences: List[str], device_batch: int = 2048):
        """Per-branch totals for a batch of query sequences.

        Returns (branch_ids [B], totals [Q, B] f32, kmer counts [Q]).
        Device calls use fixed [device_batch, W] shapes (padded) so the
        scorer compiles once per read length, not per call.
        """
        h = self.host
        Q = len(sequences)
        keys_pad, valid_pad = self._window_keys(sequences)
        # key lookup on host (uint64 keys need 64-bit arithmetic, which stays
        # off the device); the device does the expensive [Q, W, B] gather + reduction
        rows = self._rows(keys_pad, valid_pad)
        totals = np.empty((Q, len(h.branch_ids)), dtype=np.float32)
        bq = min(device_batch, max(Q, 1))
        # dispatch every chunk before any host transfer: device work and
        # per-transfer round-trip latency overlap across chunks
        pending = []
        for start in range(0, Q, bq):
            chunk = rows[start:start + bq]
            if len(chunk) < bq:  # pad to the fixed shape; K+1 row is zero
                fill = np.full((bq - len(chunk), rows.shape[1]), self.K + 1,
                               dtype=np.int32)
                chunk = np.concatenate([chunk, fill])
            pending.append((start, self._score(chunk)))
        for start, out_dev in pending:
            out = np.asarray(out_dev, dtype=np.float32)
            totals[start:start + bq] = out[:Q - start]
        # padded invalid slots contributed 0; absent-branch baseline for the
        # invalid windows is already excluded (matching the host scorer)
        return h.branch_ids, totals, valid_pad.sum(axis=1)

    def place_batch_topk(self, sequences: List[str], top: int = 7,
                         device_batch: int = 2048):
        """Device-ranked serving path: per-query top-``top`` branches only.

        Returns (branch_ids [Q, top], scores [Q, top] f32, kmer counts [Q]).
        Same totals as :meth:`place_batch`, but the [Q, B] score matrix never
        leaves the device — only the ranked head does, which is what the
        jplace output needs.
        """
        h = self.host
        Q = len(sequences)
        top = min(top, len(h.branch_ids))
        keys_pad, valid_pad = self._window_keys(sequences)
        rows = self._rows(keys_pad, valid_pad)
        scores = np.empty((Q, top), dtype=np.float32)
        cols = np.empty((Q, top), dtype=np.int64)
        bq = min(device_batch, max(Q, 1))
        # dispatch every chunk before any host transfer (latency overlap)
        pending = []
        for start in range(0, Q, bq):
            chunk = rows[start:start + bq]
            if len(chunk) < bq:
                fill = np.full((bq - len(chunk), rows.shape[1]), self.K + 1,
                               dtype=np.int32)
                chunk = np.concatenate([chunk, fill])
            pending.append((start, self._score_topk(chunk, top)))
        for start, (vals, idx) in pending:
            n = min(bq, Q - start)
            scores[start:start + n] = np.asarray(vals)[:n]
            cols[start:start + n] = np.asarray(idx)[:n]
        return h.branch_ids[cols], scores, valid_pad.sum(axis=1)


def _rank(name: str, branch_ids: np.ndarray, totals: np.ndarray,
          top: int) -> Dict:
    order = np.argsort(-totals.astype(np.float64), kind="stable")[:top]
    sel = totals[order].astype(np.float64)
    weights = np.power(10.0, sel - sel.max())
    weights /= weights.sum()
    return {"p": [[int(branch_ids[i]), float(totals[i]), float(w)]
                  for i, w in zip(order, weights)],
            "n": [name]}


def place_queries(db: PhyloKmerDB, queries: Iterable[Tuple[str, str]],
                  top: int = 7, engine: str = "auto",
                  batch_size: int = 4096) -> List[Dict]:
    """Rank branches for each (name, sequence) query. Returns jplace-style
    placement dicts.

    engine: "host" (per-query numpy), "device" (device batch scorer), or
    "auto"
    (device for large query sets). Both produce the same totals.
    """
    queries = list(queries)
    if engine == "auto":
        engine = "device" if len(queries) >= 64 else "host"
    placements = []
    if engine == "host":
        index = PlacementIndex(db)
        for name, seq in queries:
            branch_ids, totals, _ = index.score_query(seq)
            if len(branch_ids) == 0:
                continue
            placements.append(_rank(name, branch_ids,
                                    totals.astype(np.float32), top))
        return placements
    index = DevicePlacementIndex(db)
    for start in range(0, len(queries), batch_size):
        chunk = queries[start:start + batch_size]
        ids, scores, _ = index.place_batch_topk([s for _, s in chunk], top=top)
        if ids.shape[1] == 0:
            continue
        for qi, (name, _) in enumerate(chunk):
            sel = scores[qi].astype(np.float64)
            weights = np.power(10.0, sel - sel.max())
            weights /= weights.sum()
            placements.append(
                {"p": [[int(b), float(s), float(w)]
                       for b, s, w in zip(ids[qi], scores[qi], weights)],
                 "n": [name]})
    return placements


def write_jplace(db: PhyloKmerDB, placements: List[Dict], path: str) -> None:
    """jplace v3 container; edge numbers are original-tree postorder ids,
    annotated into the tree string as {N}."""
    from .tree import parse_newick, PhyloNode

    tree = parse_newick(db.tree)

    def annotate(node: PhyloNode) -> str:
        if node.children:
            inner = ",".join(annotate(c) for c in node.children)
            body = f"({inner}){node.label}"
        else:
            body = node.label
        if node.parent is not None:
            return f"{body}:{node.branch_length}{{{node.postorder_id}}}"
        return body

    doc = {
        "version": 3,
        "tree": annotate(tree.root) + ";",
        "placements": placements,
        "fields": ["edge_num", "likelihood", "like_weight_ratio"],
        "metadata": {"software": "ipk-tpu"},
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
