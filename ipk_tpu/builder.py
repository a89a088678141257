"""Database build orchestrator: the accelerator-native ``db_builder``.

Counterpart of ``ipk/src/db_builder.cpp`` (layer L3, SURVEY.md §1/§3). The
reference's three stages map as follows:

* stage 1 (``explore_kmers``/``explore_group``: per-branch windows → DCLA →
  hash maps) → one batched device computation: masked half-window tensors
  (``dense.masked_halves``) + the fused combine/max kernel
  (``pallas_kernels.combine_max`` on GPU, ``dense.combine_max_jnp`` on CPU),
  producing the dense per-branch accumulator A[B, σ^k].
* k-mer-space batching (the reference's ``key % 32`` hash-map spill,
  ``branch_group.cpp:104-107``, ``db_builder.cpp:137``) → contiguous slices of
  the half-tensor's prefix axis: batch b covers dense keys
  [lo·σ^hr, hi·σ^hr). This bounds device and host memory for large k.
* stage 2 (filtering) → vectorized mif0/random filter per batch
  (``ipk_tpu.core.filter``; per-key math is batch-independent).
* stage 3 (serialization) → in-RAM: global ascending (fv, key) sort and one
  streaming write; ``--on-disk``: per-batch sorted temp DBs under
  ``<workdir>/hashmaps/`` + a heap k-way merge into the output archive
  (mirroring ``merge_stage1``/``merge_stage2``, ``db_builder.cpp:340-458``),
  with the temp dir removed afterwards (``db_builder.cpp:213``).

Semantic invariants honored (SURVEY.md §7.1): strict ``score > (ω/σ)^k`` in
log10; per-(k-mer, branch) max over ghosts and windows; branch ids = original
postorder ids (root excluded); entry order per k-mer = group processing order
(first-ghost extended-postorder); DB sorted ascending by filter value; aa-pos
variant stores the best window's start position with earliest-window
tie-breaking (``branch_group.cpp:73-86``).
"""

from __future__ import annotations

import functools
import os
import shutil
import time
from typing import Dict, Iterator, List, Optional

import jax
import numpy as np

from .seq import SeqTraits, dense_index_to_key
from .tree import PhyloTree, to_newick
from .db import PhyloKmerDB
from .core import dense
from .core import sparse as sparse_mod
from .core.filter import (RandomFilterStream, mif0_filter_values_entries,
                          score_threshold)
from .ar.mapping import gather_ghost_tensor, ghost_groups
from . import serialize

__all__ = ["build", "BuildResult", "log_threshold_f32", "choose_backend"]


def log_threshold_f32(omega: float, sigma: int, k: int) -> np.float32:
    """log10((omega/sigma)^k) as f32 — the eps passed to the enumeration DP
    (``db_builder.cpp:640``)."""
    return np.float32(np.log10(score_threshold(omega, sigma, k)))


def choose_backend() -> str:
    """Dense combine backend: 'triton' (the Pallas kernel) on a GPU, 'jnp'
    (plain XLA) elsewhere."""
    return "triton" if jax.devices()[0].platform == "gpu" else "jnp"


def pick_key_batches(B: int, nl: int, nr: int,
                     budget_bytes: int = 2 << 30) -> int:
    """Number of equal prefix-axis batches so each A batch fits the
    host/device memory budget and stays below the int32 flat-index range of
    the device compaction."""
    total = B * nl * nr * 4
    batches = max(1, -(-total // budget_bytes),
                  -(-(B * nl * nr) // ((1 << 31) - 1)))
    while batches < nl and nl % batches != 0:
        batches += 1  # contiguous equal slices of the prefix axis
    return min(batches, nl)


class _Progress:
    """Per-unit stage-1 progress at verbosity >= 1: the reference shows
    indicators::ProgressBar per branch group (``db_builder.cpp:588-600``);
    here stage 1 is batched, so the unit is a key batch / ghost chunk.
    In-place bar on a TTY, one line per update otherwise."""

    def __init__(self, label: str, total: int, enabled: bool):
        import sys
        self.label, self.total = label, total
        self.enabled = enabled and total > 0
        self.tty = sys.stderr.isatty()
        self.done = 0
        if self.enabled:
            self._draw()

    def step(self, n: int = 1) -> None:
        if not self.enabled:
            return
        self.done += n
        self._draw()

    def _draw(self) -> None:
        import sys
        frac = self.done / self.total
        if self.tty:
            width = 30
            fill = int(width * frac)
            sys.stderr.write(f"\r{self.label} [{'#' * fill}"
                             f"{'.' * (width - fill)}] "
                             f"{self.done}/{self.total}")
            if self.done >= self.total:
                sys.stderr.write("\n")
            sys.stderr.flush()
        else:
            print(f"{self.label}: {self.done}/{self.total}", flush=True)


class BuildResult:
    def __init__(self, db: PhyloKmerDB, num_explored: int,
                 timings: Dict[str, float]):
        self.db = db
        self.num_explored = num_explored
        self.timings = timings


def _prefetch(gen: Iterator, depth: int = 1) -> Iterator:
    """Run the batch generator one step ahead in a worker thread so the
    next batch's device dispatch + device→host transfer overlap with the
    main thread's extraction (the transfer releases the GIL)."""
    import queue
    import threading
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()

    def worker():
        try:
            for item in gen:
                q.put(item)
            q.put(sentinel)
        except BaseException as e:          # surfaced in the consumer
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


# ---------------------------------------------------------------------------
# stage 1: enumeration (batched over the key space)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _halves_fn(k: int, sigma: int):
    return jax.jit(jax.vmap(
        functools.partial(dense.masked_halves, k=k, sigma=sigma),
        in_axes=(0, 0, None)))


def _enumerate_batches(P_all: np.ndarray, prefix_all: np.ndarray, *,
                       k: int, sigma: int, eps: np.float32,
                       ghosts_per_group: int, key_batches: int,
                       backend: str, block_w: int, keep_positions: bool,
                       mesh=None, stats: Optional[Dict] = None
                       ) -> Iterator[tuple]:
    """Yield per key batch:
    ("dense", lo, A[B, chunk], pos[B, chunk] or None, count) for positions
    builds, ("compact", lo, B, chunk, flat_idx, scores, count) otherwise —
    survivors are compacted on device so only they cross to the host.
    ``count`` is the batch's explored-tuple total, the reference's
    per-window ``num_tuples`` (``db_builder.cpp:576-626``).

    With ``mesh``, every key batch's combine runs branch-data-parallel via
    ``shard_map`` over the mesh's "branch" axis (the loop the reference left
    as a commented-out OpenMP pragma, ``db_builder.cpp:602-605``); ghosts are
    padded to the mesh in whole groups and trimmed from the outputs.
    Enumeration has no cross-branch arithmetic, so the result is
    bit-identical to the single-device path.

    ``stats`` (optional dict) accumulates the measured wall-time breakdown:
    ``device_compute`` (dispatch + on-device work, ended by the small count
    transfer that the host needs anyway), ``transfer`` and
    ``transfer_bytes`` (device→host materialization of the
    batch payloads; done HERE, in the prefetch worker thread, so batch N+1's
    transfer overlaps the main thread's extraction of batch N).
    """
    if stats is None:
        stats = {}
    stats.setdefault("device_compute", 0.0)
    stats.setdefault("transfer", 0.0)
    stats.setdefault("transfer_bytes", 0)
    hl = k // 2
    hr = k - hl
    nl, nr = sigma ** hl, sigma ** hr
    B0 = P_all.shape[0] // ghosts_per_group
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as PS
        from .parallel.build_sharded import pad_ghosts
        P_all, prefix_all, _ = pad_ghosts(
            np.asarray(P_all, np.float32), np.asarray(prefix_all, np.float32),
            mesh.shape["branch"] * ghosts_per_group)
        sh = NamedSharding(mesh, PS("branch"))
        P_all = jax.device_put(P_all, sh)
        prefix_all = jax.device_put(prefix_all, sh)
    t_dev = time.monotonic()
    halves = _halves_fn(k, sigma)
    L, R = halves(P_all, prefix_all, eps)
    L, R = jax.block_until_ready((L, R))
    stats["device_compute"] += time.monotonic() - t_dev

    def combine(Lb, Rl):
        if keep_positions:
            A_g, pos_g, cnt = dense.combine_max_with_positions(
                Lb, Rl, eps, block_w=block_w, with_count=True)
            A_g = A_g.reshape(A_g.shape[0], -1)
            pos_g = pos_g.reshape(pos_g.shape[0], -1)
            A, pos = dense.group_max_with_positions(A_g, pos_g,
                                                    ghosts_per_group)
            return A, pos, cnt
        if backend == "triton":
            from .core.pallas_kernels import combine_max
            A_g, cnt = combine_max(Lb, Rl, eps, with_count=True)
        else:
            A_g, cnt = dense.combine_max_jnp(Lb, Rl, eps, block_w=block_w,
                                             with_count=True)
        A = dense.group_max(A_g.reshape(A_g.shape[0], -1), ghosts_per_group)
        return A, cnt

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as PS
        # multi-host: replicate the outputs on device (an XLA all-gather) so
        # every process can fetch them — a branch-sharded array
        # spans non-addressable devices and np.asarray would fail
        out_sh = (NamedSharding(mesh, PS()) if jax.process_count() > 1
                  else None)
        # check_vma=False: a Pallas call does not type the mesh axes its
        # outputs vary over; each shard's combine is independent anyway
        combine = jax.jit(jax.shard_map(
            combine, mesh=mesh, in_specs=(PS("branch"), PS("branch")),
            out_specs=PS("branch"), check_vma=backend != "triton"),
            out_shardings=out_sh)

    step = nl // key_batches
    for b in range(key_batches):
        t_dev = time.monotonic()
        Lb = jax.lax.slice_in_dim(L, b * step, (b + 1) * step, axis=2)
        if keep_positions:
            A, pos, cnt = combine(Lb, R)
            count = int(np.asarray(cnt).sum())
            stats["device_compute"] += time.monotonic() - t_dev
            t_tr = time.monotonic()
            A_np, pos_np = np.asarray(A[:B0]), np.asarray(pos[:B0])
            stats["transfer"] += time.monotonic() - t_tr
            stats["transfer_bytes"] += A_np.nbytes + pos_np.nbytes
            yield ("dense", b * step * nr, A_np, pos_np, count)
        else:
            A, cnt = combine(Lb, R)
            count = int(np.asarray(cnt).sum())
            # survivor density decides the transfer representation: pick
            # whichever costs the fewest device→host bytes:
            #   compact (idx, score):     8 B/survivor   (sparse, <~3%)
            #   bitmask + packed scores:  cells/8 + 4 B/survivor
            #   raw dense tensor:         4 B/cell       (only near-total)
            import jax.numpy as jnp
            n_surv = int(np.asarray(jnp.isfinite(A[:B0]).sum()))
            cells = A[:B0].size
            idx_bytes = 8 * n_surv
            bm_bytes = cells // 8 + 4 * n_surv
            dense_bytes = 4 * cells
            rep = os.environ.get("IPK_TPU_TRANSFER", "auto")
            if rep == "auto":
                rep = ("idx" if idx_bytes <= min(bm_bytes, dense_bytes)
                       else "bitmask" if bm_bytes < dense_bytes
                       else "dense")
            if rep == "dense":
                stats["device_compute"] += time.monotonic() - t_dev
                t_tr = time.monotonic()
                A_np = np.asarray(A[:B0])
                stats["transfer"] += time.monotonic() - t_tr
                stats["transfer_bytes"] += A_np.nbytes
                yield ("dense", b * step * nr, A_np, None, count)
                continue
            # both compacted forms flatten the TRANSPOSED accumulator:
            # row-major flat order over [chunk, B] is key-major with groups
            # ascending within a key — exactly the DB's required entry
            # order, so the host extraction skips its O(n log n) lexsort
            if rep == "bitmask":
                packed_dev, sc_dev, n = dense.bitmask_survivors(A[:B0].T)
                stats["device_compute"] += time.monotonic() - t_dev
                t_tr = time.monotonic()
                packed = np.asarray(packed_dev)
                scores = np.asarray(sc_dev[:n], dtype=np.float32)
                stats["transfer"] += time.monotonic() - t_tr
                stats["transfer_bytes"] += packed.nbytes + scores.nbytes
                yield ("bitmask", b * step * nr, B0, step * nr, packed,
                       scores, count)
                continue
            idx_dev, sc_dev, n = dense.compact_survivors(A[:B0].T,
                                                         materialize=False)
            stats["device_compute"] += time.monotonic() - t_dev
            # materialize HERE (prefetch worker): overlaps the main
            # thread's extraction of the previous batch
            t_tr = time.monotonic()
            flat_idx = np.asarray(idx_dev[:n], dtype=np.int32)
            scores = np.asarray(sc_dev[:n], dtype=np.float32)
            stats["transfer"] += time.monotonic() - t_tr
            stats["transfer_bytes"] += flat_idx.nbytes + scores.nbytes
            yield ("compact", b * step * nr, B0, step * nr, flat_idx,
                   scores, count)


#: Candidate spaces at or above this size switch from the dense accumulator
#: to the sparse capacity-bounded path (DNA k≥12, AA k≥6): at these sizes
#: pruning leaves <0.1% survivors and paying σ^k per window loses to the
#: staircase. The crossover is not yet measured on the GPU.
MAX_DENSE_KEYSPACE = 1 << 24


def _enumerate_sparse_branches(P_all: np.ndarray, prefix_all: np.ndarray, *,
                               k: int, sigma: int, bits: int, eps: np.float32,
                               ghosts_per_group: int, cap: int, mesh=None,
                               verbose: int = 0):
    """Large-k stage 1: per-branch merged survivor lists.

    Survivor-list capacities adapt per span of the split tree: a cheap
    host probe samples windows to size each span's list
    (``sparse.probe_caps``), overflowing spans are doubled automatically
    inside :func:`sparse.enumerate_sparse_many`, and only the user ceiling
    ``cap`` fails loudly (silent truncation would drop valid k-mers).
    """
    G = P_all.shape[0]
    per_branch = []
    explored = 0
    stats: Dict = {}
    caps = sparse_mod.probe_caps(P_all, prefix_all, eps, k=k, sigma=sigma,
                                 cap=cap)
    # ghosts are batched (vmapped) so each window block costs one device
    # dispatch + one host transfer for the whole chunk, not one per ghost
    chunk_groups = max(1, 32 // ghosts_per_group)
    n_chunks = -(-(G // ghosts_per_group) // chunk_groups)
    bar = _Progress("Computing phylo-k-mers", n_chunks, verbose >= 1)
    for b0 in range(0, G // ghosts_per_group, chunk_groups):
        nb = min(chunk_groups, G // ghosts_per_group - b0)
        i0 = b0 * ghosts_per_group
        i1 = (b0 + nb) * ghosts_per_group
        codes, scores, overflow = sparse_mod.enumerate_sparse_many(
            P_all[i0:i1], prefix_all[i0:i1], eps, k=k, sigma=sigma,
            bits=bits, cap=cap, caps=caps, mesh=mesh, stats=stats)
        if overflow.any():
            raise RuntimeError(
                f"Survivor-list capacity {cap} exceeded (ghost rows "
                f"{i0}-{i1}). Increase --max-candidates or raise "
                "--omega.")
        explored += int(np.isfinite(scores).sum())
        for b in range(nb):
            g0 = b * ghosts_per_group
            merged_c, merged_s = sparse_mod.merge_window_lists(
                codes[g0:g0 + ghosts_per_group],
                scores[g0:g0 + ghosts_per_group])
            per_branch.append((merged_c, merged_s))
        bar.step()
    if verbose > 0:
        # probe-miss telemetry: how often a span cap
        # doubled mid-build (forcing a chunk re-dispatch) and where the
        # capacities settled
        redisp = stats.get("redispatches", 0)
        caps_str = ", ".join(f"{s}:{c}" for s, c in
                             sorted(stats.get("final_caps", {}).items()))
        print(f"Sparse telemetry: {redisp} chunk re-dispatch(es) "
              f"(probe misses); settled caps {{{caps_str}}}")
    return per_branch, explored


#: working-set ceiling for the single-dispatch device key merge; above this
#: the chunked host merge takes over (same budget the sparse chunker uses)
_DEVICE_MERGE_BUDGET_BYTES = 4 << 30


def _sparse_device_merge(P_all, prefix_all, *, k: int, sigma: int, bits: int,
                         eps, ghosts_per_group: int, cap: int, mesh,
                         verbose: int = 0):
    """Stage 1 + stage 2 merge entirely on device:
    enumerate all ghosts in one sharded dispatch, then run the cross-shard
    key merge (sort → segment-max → all-to-all by key range) of
    ``parallel.key_merge``. Returns ((keys, border, scores), explored) — a
    (key, group)-sorted entry stream — or (None, reason) when the workload
    doesn't fit the single-dispatch budget or a bucket overflows (callers
    fall back to the chunked host merge)."""
    from .parallel.key_merge import KeyMergeOverflow, device_key_merge
    from .parallel.build_sharded import pad_ghosts
    caps = sparse_mod.probe_caps(P_all, prefix_all, eps, k=k, sigma=sigma,
                                 cap=cap)
    G0 = P_all.shape[0]
    # GROUP-ALIGNED padding: each device must hold whole ghost groups for
    # the merge's group indexing (the enumeration alone is happy with any
    # split — _prepare_batch pads to n_dev only)
    P_all, prefix_all, _ = pad_ghosts(
        np.asarray(P_all, np.float32), np.asarray(prefix_all, np.float32),
        mesh.shape["branch"] * ghosts_per_group)
    G, S = P_all.shape[0], P_all.shape[1]
    W = S - k + 1
    def over_budget(c):
        top_cap = min(cap, max(list(c.values()) + [128]))
        return G * W * top_cap * 48 > _DEVICE_MERGE_BUDGET_BYTES

    if over_budget(caps):
        return None, "working set exceeds the single-dispatch budget"
    while True:
        pend = sparse_mod.enumerate_pairs_deferred(
            P_all, prefix_all, np.float32(eps), k=k, sigma=sigma, bits=bits,
            caps=caps, mesh=mesh)
        done, result, caps = sparse_mod.resolve_deferred(
            pend, k=k, sigma=sigma, cap=cap, caps=caps)
        if done:
            break
        # cap adaptation can double the working set past the budget the
        # probe-derived caps satisfied; re-check so the graceful host-merge
        # fallback fires instead of a device OOM
        if over_budget(caps):
            return None, ("working set exceeds the single-dispatch budget "
                          "after capacity adaptation")
    if result[3].any():
        raise RuntimeError(
            f"Survivor-list capacity {cap} exceeded. Increase "
            "--max-candidates or raise --omega.")
    # the PADDED per-window lists stay on device; padding ghosts are all
    # -inf and contribute no tuples
    cl_full, cr_full, scores_full = pend[1][0], pend[1][1], pend[1][2]
    import jax.numpy as jnp
    explored = int(np.asarray(jnp.isfinite(scores_full).sum()))
    try:
        # nl bounds the cl CODE space for the key-range binning. Codes are
        # BIT-packed (bits per symbol), so the space is 2^(bits·hl), NOT
        # sigma^hl — for non-power-of-two alphabets (AA: sigma 20, 5 bits)
        # codes above sigma^hl exist and sigma^hl as the bound silently
        # dropped them from every bucket (caught by the AA full-pipeline
        # oracle gate; DNA is dense-packed, 4^hl == 2^(2·hl), so it never
        # triggered).
        keys, border, scores = device_key_merge(
            mesh, cl_full, cr_full, scores_full,
            ghosts_per_group=ghosts_per_group,
            nl=1 << (bits * (k // 2)), bits=bits, k=k)
    except KeyMergeOverflow as e:
        # a merge bucket overflowed, but stage 1 is DONE and correct —
        # reuse the enumerated survivor lists and merge on host instead of
        # discarding and re-running the whole enumeration
        if verbose > 0:
            print(f"Note: device key merge fell back to the host merge "
                  f"({e}); reusing the completed enumeration.")
        codes_h = sparse_mod._pack_host(np.asarray(cl_full),
                                        np.asarray(cr_full), k=k, bits=bits)
        scores_h = np.asarray(scores_full)
        per_branch = []
        for bi in range(G0 // ghosts_per_group):
            i0, i1 = bi * ghosts_per_group, (bi + 1) * ghosts_per_group
            per_branch.append(sparse_mod.merge_window_lists(
                codes_h[i0:i1], scores_h[i0:i1]))
        return ("lists", per_branch), explored
    if verbose > 0:
        print(f"Device key merge: {len(keys)} entries "
              f"({mesh.shape['branch']} shards, all-to-all by key range)")
    return ("stream", (keys, border, scores)), explored


def _extract_from_lists(per_branch, group_ids, total_num_groups: int,
                        threshold: float, filter_type: str,
                        rng_stream: Optional[RandomFilterStream],
                        merge_branches: bool):
    """Per-branch sparse lists → unsorted DB arrays (keys, fv, counts,
    branches, scores, positions=None). Entry order per key = group order."""
    if not per_branch:
        z = np.zeros(0)
        return (z.astype(np.uint64), z, z.astype(np.int64),
                z.astype(np.uint32), z.astype(np.float32), None)
    all_keys = np.concatenate([c for c, _ in per_branch])
    all_scores = np.concatenate([s for _, s in per_branch])
    all_border = np.concatenate(
        [np.full(len(c), bi, dtype=np.int64)
         for bi, (c, _) in enumerate(per_branch)])
    order = np.lexsort((all_border, all_keys))  # key-major, group order
    all_keys, all_scores, all_border = (all_keys[order], all_scores[order],
                                        all_border[order])
    return _extract_sorted_stream(all_keys, all_border, all_scores,
                                  group_ids, total_num_groups, threshold,
                                  filter_type, rng_stream, merge_branches)


def _extract_sorted_stream(all_keys, all_border, all_scores, group_ids,
                           total_num_groups: int, threshold: float,
                           filter_type: str,
                           rng_stream: Optional[RandomFilterStream],
                           merge_branches: bool):
    """(key, group)-sorted entry stream (per-pair max scores) → unsorted DB
    arrays. Shared tail of the host lexsort path and the device key merge
    (``parallel.key_merge``), which produces this stream directly."""
    if merge_branches:
        # keep only the best-scoring entry per key (earliest group on ties)
        sub = np.lexsort((all_border, -all_scores.astype(np.float64),
                          all_keys))
        ks, ss, bs = all_keys[sub], all_scores[sub], all_border[sub]
        first = np.ones(len(ks), dtype=bool)
        first[1:] = ks[1:] != ks[:-1]
        all_keys, all_scores, all_border = ks[first], ss[first], bs[first]

    first = np.ones(len(all_keys), dtype=bool)
    first[1:] = all_keys[1:] != all_keys[:-1]
    bounds = np.flatnonzero(first)
    offsets = np.append(bounds, len(all_keys)).astype(np.int64)
    keys = all_keys[bounds]
    counts = np.diff(offsets)
    branches = np.asarray(group_ids, dtype=np.uint32)[all_border]

    if filter_type == "mif0":
        fv = mif0_filter_values_entries(all_scores, None, len(keys),
                                        total_num_groups, threshold,
                                        offsets=offsets)
    elif filter_type == "random":
        fv = rng_stream.take(len(keys)).astype(np.float64)
    else:
        raise RuntimeError("Error: Unsupported filter type.")
    return keys, fv, counts, branches, np.asarray(all_scores, np.float32), None


# ---------------------------------------------------------------------------
# stage 2: extraction + filtering (per batch)
# ---------------------------------------------------------------------------

def _extract_batch(A: np.ndarray, lo: int, pos: Optional[np.ndarray],
                   group_ids: List[int], k: int, traits: SeqTraits,
                   total_num_groups: int, threshold: float,
                   filter_type: str, rng_stream: Optional[RandomFilterStream],
                   merge_branches: bool, fv_override=None):
    """Dense batch → (keys, fv, counts, branches, scores, positions)."""
    mask = np.isfinite(A)
    if merge_branches:
        best_b = A.argmax(axis=0)
        cols_any = mask.any(axis=0)
        best_mask = np.zeros_like(mask)
        best_mask[best_b[cols_any], np.flatnonzero(cols_any)] = True
        mask = best_mask

    present = mask.any(axis=0)
    cols = np.flatnonzero(present)
    keys = dense_index_to_key(cols.astype(np.uint64) + np.uint64(lo),
                              k, traits)

    # LINEAR masked compressions instead of np.nonzero + 8M-wide fancy
    # gathers: at full-build scale the old double-index path was the single
    # hottest host stage (profiled 5.5 s of an 11 s warm build)
    MT = np.ascontiguousarray(mask[:, cols].T)   # [K', B]
    flat = MT.ravel()
    counts = MT.sum(axis=1)
    branches = np.broadcast_to(
        np.asarray(group_ids, dtype=np.uint32), MT.shape).ravel()[flat]
    scores = np.ascontiguousarray(A[:, cols].T).ravel()[flat]
    positions = (np.ascontiguousarray(pos[:, cols].T).ravel()[flat]
                 .astype(np.uint32) if pos is not None else None)

    if fv_override is not None:
        # distributed device MI (f32): values per dense key index
        fv = fv_override[cols + lo].astype(np.float64)
    elif filter_type == "mif0":
        # entries-based filter: the single mif0 implementation shared by the
        # dense, compacted and sparse paths (identical f64 summation order →
        # identical filter values and therefore identical DB ordering)
        offsets = np.zeros(len(cols) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        fv = mif0_filter_values_entries(scores, None, len(cols),
                                        total_num_groups, threshold,
                                        offsets=offsets)
    elif filter_type == "random":
        fv = rng_stream.take(len(cols)).astype(np.float64)
    else:
        raise RuntimeError("Error: Unsupported filter type.")
    return keys, fv, counts, branches, scores, positions


def _extract_compact(flat_idx: np.ndarray, scores: np.ndarray, B: int,
                     chunk: int, lo: int, group_ids, k: int,
                     traits: SeqTraits, total_num_groups: int,
                     threshold: float, filter_type: str,
                     rng_stream: Optional[RandomFilterStream],
                     merge_branches: bool):
    """Device-compacted batch → unsorted DB arrays (same contract as
    :func:`_extract_batch`). flat_idx is row-major over the TRANSPOSED
    accumulator [chunk, B] — ascending flat index is already key-major with
    groups ascending within a key (the DB's entry order), so no host sort
    is needed on this path."""
    # materialize ONCE: every numpy op on a still-on-device jax array
    # triggers a fresh device→host transfer of the whole column
    flat_idx = np.asarray(flat_idx)
    scores = np.asarray(scores, dtype=np.float32)
    # flat_idx stays int32 (pick_key_batches guarantees chunk*B < 2^31);
    # divmod in one pass, no int64 upcast copies
    key_local, b_rows = np.divmod(flat_idx, np.int32(B))
    if merge_branches:
        # best entry per key (ties -> lowest group row); the key-primary sort
        # leaves the deduped keys already in ascending order
        sub = np.lexsort((b_rows, -scores.astype(np.float64), key_local))
        ks, ss, bs = key_local[sub], scores[sub], b_rows[sub]
        first = np.ones(len(ks), dtype=bool)
        first[1:] = ks[1:] != ks[:-1]
        key_local, scores, b_rows = ks[first], ss[first], bs[first]

    first = np.ones(len(key_local), dtype=bool)
    if len(key_local):
        first[1:] = key_local[1:] != key_local[:-1]
    # group boundaries instead of an 8M-element cumsum+bincount: the entry
    # stream is key-major, so offsets are just the True positions of `first`
    bounds = np.flatnonzero(first)
    offsets = np.append(bounds, len(key_local)).astype(np.int64)
    uniq = key_local[bounds]
    keys = dense_index_to_key(uniq.astype(np.uint64) + np.uint64(lo), k,
                              traits)
    counts = np.diff(offsets)
    branches = np.asarray(group_ids, dtype=np.uint32)[b_rows]

    if filter_type == "mif0":
        fv = mif0_filter_values_entries(scores, None, len(uniq),
                                        total_num_groups, threshold,
                                        offsets=offsets)
    elif filter_type == "random":
        fv = rng_stream.take(len(uniq)).astype(np.float64)
    else:
        raise RuntimeError("Error: Unsupported filter type.")
    return keys, fv, counts, branches, np.asarray(scores, np.float32), None


def _sort_batch(keys, fv, counts, branches, scores, positions):
    """Reorder one batch's arrays ascending by (fv, key)."""
    order = np.lexsort((keys, fv))
    offsets = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    new_offsets, branches, scores, positions = _apply_range_gather(
        offsets, np.asarray(counts, dtype=np.int64), order, branches, scores,
        positions)
    return (keys[order], fv[order], new_offsets, branches, scores, positions)


def _apply_range_gather(offs, counts, order, branches, scores, positions):
    """Concatenate entry ranges [offs[i], offs[i]+counts[i]) for i in
    ``order``, applied to the entry columns. Threaded native implementation
    (``native/mif0_filter.cpp::ipk_range_gather_apply``) with a numpy
    fallback; this is the entry permutation behind the global (fv, key) sort
    — pure memory movement, the reference pays the equivalent inside
    std::sort over records (``db_builder.cpp:284``)."""
    import ctypes
    from .core.filter import _load_native
    new_offsets = np.zeros(len(order) + 1, dtype=np.int64)
    np.cumsum(counts[order], out=new_offsets[1:])
    lib = _load_native()
    if lib is not None and hasattr(lib, "ipk_range_gather_apply"):
        i64p = ctypes.POINTER(ctypes.c_int64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        f32p = ctypes.POINTER(ctypes.c_float)
        offs = np.ascontiguousarray(offs, np.int64)
        counts = np.ascontiguousarray(counts, np.int64)
        order = np.ascontiguousarray(order, np.int64)
        branches = np.ascontiguousarray(branches, np.uint32)
        scores = np.ascontiguousarray(scores, np.float32)
        br_out = np.empty_like(branches)
        sc_out = np.empty_like(scores)
        if positions is not None:
            positions = np.ascontiguousarray(positions, np.uint32)
            pos_out = np.empty_like(positions)
            pos_in_p = positions.ctypes.data_as(u32p)
            pos_out_p = pos_out.ctypes.data_as(u32p)
        else:
            pos_out, pos_in_p, pos_out_p = None, u32p(), u32p()
        from .utils.threads import host_threads
        nthreads = host_threads("IPK_TPU_FILTER_THREADS")
        lib.ipk_range_gather_apply(
            offs.ctypes.data_as(i64p), counts.ctypes.data_as(i64p),
            order.ctypes.data_as(i64p), new_offsets.ctypes.data_as(i64p),
            np.int64(len(order)), branches.ctypes.data_as(u32p),
            scores.ctypes.data_as(f32p), pos_in_p,
            br_out.ctypes.data_as(u32p), sc_out.ctypes.data_as(f32p),
            pos_out_p, np.int32(nthreads))
        return new_offsets, br_out, sc_out, pos_out
    gather = _range_gather(offs, counts, order)
    return (new_offsets, branches[gather], scores[gather],
            None if positions is None else positions[gather])


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def build(original_tree: PhyloTree,
          extended_tree: PhyloTree,
          ghost_mapping: Dict[str, int],
          ar_mapping: Dict[str, str],
          label_rows: Dict[str, int],
          P: np.ndarray,
          *,
          traits: SeqTraits,
          kmer_size: int,
          omega: float,
          filter_type: str = "mif0",
          ghost_strategy: str = "both",
          merge_branches: bool = False,
          keep_positions: bool = False,
          output_filename: Optional[str] = None,
          uncompressed: bool = False,
          on_disk: bool = False,
          working_dir: str = "",
          key_batches: Optional[int] = None,
          backend: Optional[str] = None,
          block_w: int = 32,
          sparse: Optional[bool] = None,
          sparse_cap: int = 4096,
          device_mi: bool = False,
          verbose: int = 1) -> BuildResult:
    """Run the full stage-1..3 build (cf. ``db_builder::run``,
    ``db_builder.cpp:182-218``)."""
    from .utils.malloc_tune import retain_heap
    retain_heap()   # keep freed big buffers in the heap (see module)
    sigma = traits.alphabet_size
    if kmer_size > traits.max_kmer_length:
        raise RuntimeError(
            f"Maximum k-mer size allowed: {traits.max_kmer_length}")
    if on_disk and keep_positions:
        # parity with the reference (throw_if_positions, db_builder.cpp:247-252)
        raise RuntimeError("Positions are not supported in this version")
    backend = backend or choose_backend()
    timings: Dict[str, float] = {}

    if verbose > 0:
        print("Computation parameters:")
        print(f"\tsequence type: {traits.name}")
        print(f"\tk: {kmer_size}")
        print(f"\tomega: {omega}")
        print(f"\ton disk: {on_disk}")
        print(f"\tkeep positions: {keep_positions}")
        dev = jax.devices()[0]
        print(f"\tbackend: {backend}")
        print(f"\tdevice: {dev.platform} ({dev.device_kind}) x "
              f"{jax.device_count()}\n")

    db = PhyloKmerDB(kmer_size, omega, traits.name, to_newick(original_tree),
                     original_tree.tree_index())

    # ---- stage 1 inputs ---------------------------------------------------
    t0 = time.monotonic()
    groups, group_ids = ghost_groups(extended_tree, original_tree,
                                     ghost_mapping, ghost_strategy)
    P_all = gather_ghost_tensor(groups, ar_mapping, label_rows, P)
    P_all = np.asarray(P_all, dtype=np.float32)
    prefix_all = dense.best_score_prefix(P_all)
    eps = log_threshold_f32(omega, sigma, kmer_size)
    ghosts_per_group = len(groups[0]) if groups else 1

    hl = kmer_size // 2
    nl, nr = sigma ** hl, sigma ** (kmer_size - hl)
    if key_batches is None:
        key_batches = pick_key_batches(len(groups), nl, nr)
        # transfer/extract pipelining (see _prefetch): split big dense
        # accumulators into a few batches even when memory alone would not
        # require it, so the next batch's device→host transfer overlaps
        # the current batch's host extraction
        if (not keep_positions
                and len(groups) * nl * nr * 4 > (16 << 20)):
            for cand in (4, 2):
                if key_batches < cand and nl % cand == 0:
                    key_batches = cand
                    break
    threshold = score_threshold(omega, sigma, kmer_size)
    rng_stream = RandomFilterStream() if filter_type == "random" else None

    use_sparse = sparse if sparse is not None else (
        sigma ** kmer_size >= MAX_DENSE_KEYSPACE)
    if use_sparse and keep_positions:
        raise RuntimeError(
            "--keep-positions is not supported on the sparse (large-k) path")

    # every production path shards branch-data-parallel when the mesh has
    # more than one device (dense, batched, positions, and sparse alike)
    n_devices = jax.device_count()
    mesh = None
    if n_devices > 1 and os.environ.get("IPK_TPU_NO_SHARD") != "1":
        from .parallel.mesh import make_mesh
        mesh = make_mesh(n_branch=n_devices, n_key=1)
    num_explored = 0
    fv_override = None
    use_device_mi = (device_mi and mesh is not None and not use_sparse
                     and not keep_positions and filter_type == "mif0")
    if device_mi and not use_device_mi and verbose > 0:
        print("Note: --device-mi needs a multi-device mesh, the dense "
              "path and the mif0 filter; falling back to the host f64 "
              "filter.")
    if use_device_mi:
        # pod-scale path: enumeration AND the mutual-information reduction
        # stay on device (two psum collectives over the branch axis,
        # build_sharded._mi_reduce); filter values come back f32. The
        # host-f64 path remains the canonical ordering (SURVEY.md §7.1/#6);
        # this trades the last bits of fv rounding for never gathering the
        # full entry set onto one host. mif0 is per-key separable, so the
        # reduction runs per KEY BATCH with identical values — the r3
        # key_batches == 1 gate is gone.
        from .parallel.build_sharded import (pad_ghosts,
                                             sharded_batched_build_step)
        G0 = P_all.shape[0]
        B0 = G0 // ghosts_per_group
        P_pad, pre_pad, _ = pad_ghosts(
            P_all, prefix_all, mesh.shape["branch"] * ghosts_per_group)
        halves_fn, batch_fn, step_l = sharded_batched_build_step(
            mesh, k=kmer_size, sigma=sigma,
            ghosts_per_group=ghosts_per_group,
            total_num_groups=original_tree.get_node_count(),
            threshold=threshold, key_batches=key_batches, block_w=block_w)
        fv_override = np.empty(nl * nr, dtype=np.float32)

        def device_mi_batches():
            timings.setdefault("device_compute", 0.0)
            timings.setdefault("transfer", 0.0)
            timings.setdefault("transfer_bytes", 0)
            t_dev = time.monotonic()
            L, R = halves_fn(P_pad, pre_pad, eps)
            for b in range(key_batches):
                A_b, fv_b, counts = batch_fn(L, R, eps, b * step_l)
                lo = b * step_l * nr
                count = int(np.asarray(counts)[:G0].astype(np.int64).sum())
                timings["device_compute"] += time.monotonic() - t_dev
                t_tr = time.monotonic()
                fv_np = np.asarray(fv_b)
                A_np = np.asarray(A_b)[:B0]
                timings["transfer"] += time.monotonic() - t_tr
                timings["transfer_bytes"] += fv_np.nbytes + A_np.nbytes
                fv_override[lo:lo + step_l * nr] = fv_np
                yield ("dense", lo, A_np, None, count)
                t_dev = time.monotonic()

        batches = device_mi_batches()
    elif use_sparse:
        stream = None
        if mesh is not None and os.environ.get(
                "IPK_TPU_NO_DEVICE_MERGE") != "1":
            # stage-2 merge on device (sort → segment-max → all-to-all by
            # key range over the mesh); byte-equal to the host merge
            stream, info = _sparse_device_merge(
                P_all, prefix_all, k=kmer_size, sigma=sigma,
                bits=traits.bits_per_symbol, eps=eps,
                ghosts_per_group=ghosts_per_group, cap=sparse_cap,
                mesh=mesh, verbose=verbose)
            if stream is None and verbose > 0:
                print(f"Note: device key merge fell back to the host merge "
                      f"({info}).")
        if stream is not None and stream[0] == "stream":
            (keys_s, border_s, scores_s), num_explored = stream[1], info
            sparse_part = _extract_sorted_stream(
                keys_s, border_s, scores_s, group_ids,
                original_tree.get_node_count(), threshold, filter_type,
                rng_stream, merge_branches)
        elif stream is not None and stream[0] == "lists":
            # bucket-overflow fallback: the enumeration was kept
            per_branch, num_explored = stream[1], info
            sparse_part = _extract_from_lists(
                per_branch, group_ids, original_tree.get_node_count(),
                threshold, filter_type, rng_stream, merge_branches)
        else:
            per_branch, num_explored = _enumerate_sparse_branches(
                P_all, prefix_all, k=kmer_size, sigma=sigma,
                bits=traits.bits_per_symbol, eps=eps,
                ghosts_per_group=ghosts_per_group, cap=sparse_cap, mesh=mesh,
                verbose=verbose)
            sparse_part = _extract_from_lists(
                per_branch, group_ids, original_tree.get_node_count(),
                threshold, filter_type, rng_stream, merge_branches)
        batches = iter(())
    else:
        batches = _enumerate_batches(
            P_all, prefix_all, k=kmer_size, sigma=sigma, eps=eps,
            ghosts_per_group=ghosts_per_group, key_batches=key_batches,
            backend=backend, block_w=block_w, keep_positions=keep_positions,
            mesh=mesh, stats=timings)

    # ---- stages 2+3 -------------------------------------------------------
    parts = []
    temp_files: List[str] = []
    hashmaps_dir = os.path.join(working_dir or ".", "hashmaps")
    if on_disk:
        os.makedirs(hashmaps_dir, exist_ok=True)

    def handle_part(batch_idx, part):
        if on_disk:
            keys, fv, offsets, branches, scores, positions = _sort_batch(*part)
            temp_db = PhyloKmerDB(kmer_size, omega, traits.name, "", [])
            temp_db.set_data(keys, fv.astype(np.float32), offsets, branches,
                             scores, positions)
            name = os.path.join(hashmaps_dir, f"{batch_idx}.ipk")
            serialize.save(temp_db, name, compressed=False)
            temp_files.append(name)
        else:
            parts.append(part)

    if use_sparse:
        handle_part(0, sparse_part)
    bar = _Progress("Computing phylo-k-mers",
                    0 if use_sparse else key_batches, verbose >= 1)
    timings.setdefault("host_extract", 0.0)
    for batch_idx, batch in enumerate(_prefetch(batches)):
        t_x = time.monotonic()
        if batch[0] == "dense":
            _, lo, A, pos, count = batch
            num_explored += count
            part = _extract_batch(
                A, lo, pos, group_ids, kmer_size, traits,
                original_tree.get_node_count(), threshold,
                filter_type, rng_stream, merge_branches,
                fv_override=fv_override)
        else:
            _, lo, B, chunk, flat_idx, scores, count = batch
            num_explored += count
            if batch[0] == "bitmask":
                # unpack the survivor membership back to flat indices:
                # unpackbits is MSB-first, matching the device packer
                flat = np.unpackbits(flat_idx)[:B * chunk]
                flat_idx = np.flatnonzero(flat).astype(np.int32)
            part = _extract_compact(
                flat_idx, scores, B, chunk, lo, group_ids, kmer_size, traits,
                original_tree.get_node_count(), threshold,
                filter_type, rng_stream, merge_branches)
        handle_part(batch_idx, part)
        timings["host_extract"] += time.monotonic() - t_x
        bar.step()
    timings["computation"] = time.monotonic() - t0
    if verbose > 0:
        print(f"Computation time: {timings['computation']*1e3:.0f} ms")

    t0 = time.monotonic()
    if on_disk:
        # RAM-bounded: the result stays on disk (the reference likewise
        # never re-reads the merged DB, db_builder.cpp:467-493); callers
        # needing arrays must serialize.load() the output explicitly
        _merge_on_disk(db, temp_files, output_filename, uncompressed)
        shutil.rmtree(hashmaps_dir, ignore_errors=True)
    else:
        keys = np.concatenate([p[0] for p in parts]) if parts else np.zeros(0, np.uint64)
        fv = np.concatenate([p[1] for p in parts]) if parts else np.zeros(0)
        counts = np.concatenate([p[2] for p in parts]) if parts else np.zeros(0, np.int64)
        branches = np.concatenate([p[3] for p in parts]) if parts else np.zeros(0, np.uint32)
        scores = np.concatenate([p[4] for p in parts]) if parts else np.zeros(0, np.float32)
        positions = (np.concatenate([p[5] for p in parts])
                     if parts and parts[0][5] is not None else None)
        keys, fv, offsets, branches, scores, positions = _sort_batch(
            keys, fv, counts, branches, scores, positions)
        db.set_data(keys, fv.astype(np.float32), offsets, branches, scores,
                    positions)
        timings["sort"] = time.monotonic() - t0
        if output_filename:
            t_s = time.monotonic()
            serialize.save(db, output_filename, compressed=not uncompressed)
            timings["serialize"] = time.monotonic() - t_s
    timings["filter_merge"] = time.monotonic() - t0

    if verbose > 0:
        print(f"Filtering and merge time: {timings['filter_merge']*1e3:.0f} ms")
        print("Building database: Done.")
        if output_filename:
            print(f"Output: {output_filename}")
    return BuildResult(db, num_explored, timings)


class _MergeBuffer:
    """One loader's resident rows during the out-of-core merge."""

    def __init__(self, loader: "serialize.BatchLoader", block_rows: int):
        self.loader = loader
        self.block_rows = block_rows
        self.cols: Optional[tuple] = None    # (keys, fvs, counts, br, sc, po)

    def fill(self) -> None:
        if self.cols is None:
            block = self.loader.read_block(self.block_rows)
            if block is not None:
                self.cols = block

    @property
    def rows(self) -> int:
        return 0 if self.cols is None else len(self.cols[0])

    def bound(self):
        """(fv, key) of the last resident row — rows still on disk all sort
        at or after it (the batch file is sorted ascending)."""
        keys, fvs = self.cols[0], self.cols[1]
        return (fvs[-1], keys[-1])

    def take_upto(self, cut) -> Optional[tuple]:
        """Split off the prefix with (fv, key) <= cut (None keeps all)."""
        keys, fvs, counts, br, sc, po = self.cols
        if cut is None:
            m = len(keys)
        else:
            cut_fv, cut_key = cut
            mask = (fvs < cut_fv) | ((fvs == cut_fv) & (keys <= cut_key))
            m = int(mask.sum())     # sorted buffer: the mask is a prefix
        if m == 0:
            return None
        ne = int(counts[:m].sum())
        taken = (keys[:m], fvs[:m], counts[:m], br[:ne], sc[:ne],
                 None if po is None else po[:ne])
        if m == len(keys):
            self.cols = None
        else:
            self.cols = (keys[m:], fvs[m:], counts[m:], br[ne:], sc[ne:],
                         None if po is None else po[ne:])
        return taken


def _merge_on_disk(db: PhyloKmerDB, temp_files: List[str],
                   output_filename: Optional[str], uncompressed: bool,
                   positions: bool = False,
                   block_rows: int = 1 << 16) -> None:
    """Out-of-core k-way merge of sorted batch DBs into the output archive
    (``merge_stage2``, ``db_builder.cpp:392-458``).

    Batches are key-disjoint and internally sorted ascending by (fv, key), so
    a streaming merge yields the global order. The reference advances one
    record at a time through a priority queue of lazy cursors; the vectorized
    equivalent advances one *block* at a time: refill every buffer, cut at
    the smallest last-resident (fv, key) among loaders that still have rows
    on disk (rows beyond a cut cannot interleave before it), lexsort the cut
    prefix, spill the five columns to temp section files, and finally stream
    the sections through the compressor. Peak memory is
    O(block_rows · num_batches), independent of database size.
    """
    if not output_filename:
        raise RuntimeError("--on-disk requires an output filename")
    loaders = [serialize.BatchLoader(f, block_rows=block_rows)
               for f in temp_files]
    total_kmers = sum(l.get_num_kmers() for l in loaders)
    total_entries = sum(l.num_entries for l in loaders)
    buffers = [_MergeBuffer(l, block_rows) for l in loaders]

    spill_names = ["keys", "fvs", "counts", "branches", "scores"]
    if positions:
        spill_names.append("positions")
    spill_dir = output_filename + ".merge"
    os.makedirs(spill_dir, exist_ok=True)
    spills = {n: open(os.path.join(spill_dir, n + ".bin"), "wb")
              for n in spill_names}
    try:
        while True:
            for b in buffers:
                b.fill()
            live = [b for b in buffers if b.rows]
            if not live:
                break
            bounding = [b.bound() for b in live if b.loader.rows_left() > 0]
            cut = min(bounding) if bounding else None
            taken = [t for b in live if (t := b.take_upto(cut)) is not None]
            if not taken:       # all resident rows sort after the cut
                continue
            keys = np.concatenate([t[0] for t in taken])
            fvs = np.concatenate([t[1] for t in taken])
            counts = np.concatenate([t[2] for t in taken])
            order = np.lexsort((keys, fvs))
            offs = np.zeros(len(keys) + 1, dtype=np.int64)
            np.cumsum(counts, out=offs[1:])
            gather = _range_gather(offs, counts, order)
            spills["keys"].write(
                np.ascontiguousarray(keys[order], "<u8").tobytes())
            spills["fvs"].write(
                np.ascontiguousarray(fvs[order], "<f4").tobytes())
            spills["counts"].write(
                np.ascontiguousarray(counts[order], "<u8").tobytes())
            br = np.concatenate([t[3] for t in taken])
            sc = np.concatenate([t[4] for t in taken])
            spills["branches"].write(
                np.ascontiguousarray(br[gather], "<u4").tobytes())
            spills["scores"].write(
                np.ascontiguousarray(sc[gather], "<f4").tobytes())
            if positions:
                po = np.concatenate([t[5] for t in taken])
                spills["positions"].write(
                    np.ascontiguousarray(po[gather], "<u4").tobytes())
    finally:
        for f in spills.values():
            f.close()
        for l in loaders:
            l.close()

    with serialize.IpkWriter(output_filename,
                             compressed=not uncompressed) as w:
        w.write_header(db, total_kmers, total_entries)
        for name in spill_names:
            path = os.path.join(spill_dir, name + ".bin")
            with open(path, "rb") as f:
                while chunk := f.read(1 << 22):
                    w.write_raw(chunk)
    shutil.rmtree(spill_dir, ignore_errors=True)


def _range_gather(offs: np.ndarray, counts: np.ndarray,
                  order: np.ndarray) -> np.ndarray:
    """Entry-gather permutation for reordering variable-length entry runs:
    concatenation of ranges [offs[i], offs[i]+counts[i]) for i in order."""
    reps = counts[order]
    total = int(reps.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = offs[order]
    out_offs = np.zeros(len(order) + 1, dtype=np.int64)
    np.cumsum(reps, out=out_offs[1:])
    idx = np.arange(total, dtype=np.int64)
    # run id per output slot by O(n) repeat (measured ~10x faster than the
    # searchsorted formulation at ~10M entries)
    run = np.repeat(np.arange(len(order), dtype=np.int64), reps)
    return starts[run] + (idx - out_offs[run])
