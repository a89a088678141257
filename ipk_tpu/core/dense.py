"""Dense phylo-k-mer enumeration: the accelerator-native replacement for DCLA.

The reference enumerates surviving k-mers per window with a recursive
divide-and-conquer over sorted survivor lists (``ipk/src/pk_compute.cpp:42-114``)
and merges them into per-branch hash maps with insert-or-max
(``ipk/src/branch_group.cpp:88-102``). Data-dependent list sizes and hash
tables are hostile to XLA; instead we compute, for every window, the scores of
*all* σ^k candidates as a level-wise "kron-sum" over the candidate space, with
per-level threshold masking, and fold windows together with a running
element-wise max into a dense per-ghost accumulator ``A[σ^h]``:

* The combine tree follows the reference's exact split ``(h/2, h - h/2)``
  (``pk_compute.cpp:54-58``), so every surviving score is produced by the same
  f32 summation tree and is bit-identical to the reference's float arithmetic.
* Per-level thresholds replicate ``eps_l = eps - range_max(right)`` /
  ``eps_r = eps - range_max(left)`` using the same prefix-sum bound oracle
  (``window.cpp:16-27,69-72``) in f32. Candidates pruned at any level become
  ``-inf`` and stay pruned (x + -inf = -inf), exactly mirroring the recursion's
  survivor-list semantics: a candidate survives iff its sub-score is strictly
  greater than the level's eps at *every* level (``pk_compute.cpp:19-21,90-94``).
* The per-branch hash map + ``put`` insert-or-max becomes
  ``A = max(A, window_scores)`` — associative, so windows/ghosts parallelize
  freely and the result is independent of processing order.

Everything is static-shaped: all AR matrices in a build share the same width
S, every ghost yields W = S - k + 1 windows, and the accumulator has σ^k
entries (mixed-radix base-σ index; converted to the reference's bit-packed key
at extraction time, see ``ipk_tpu.seq.dense_index_to_key``).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "split_tree",
    "compute_eps",
    "score_window_block",
    "accumulate_matrix",
    "accumulate_ghosts",
    "group_max",
    "best_score_prefix",
    "NEG_INF",
]

NEG_INF = np.float32(-np.inf)


def split_tree(k: int) -> List[Tuple[int, int]]:
    """Sub-window spans (j, h) of the DCLA recursion, children before parents.

    Matches the recursion ``DC(j, h) -> DC(j, h/2), DC(j + h/2, h - h/2)``
    (``pk_compute.cpp:54-58``); the returned order is safe for bottom-up
    evaluation.
    """
    order: List[Tuple[int, int]] = []

    def build(j: int, h: int) -> None:
        if h > 1:
            hl = h // 2
            build(j, hl)
            build(j + hl, h - hl)
        order.append((j, h))

    build(0, k)
    return order


def best_score_prefix(P: np.ndarray) -> np.ndarray:
    """Sequential f32 prefix sums of per-column max log-scores.

    The branch-and-bound bound oracle: ``range_max_sum(start, len) =
    prefix[start+len] - prefix[start]`` (``window.cpp:16-27,69-72``). Computed
    host-side with numpy's sequential cumsum so the f32 accumulation order
    matches the reference's left-to-right loop.

    P: [..., S, sigma] log10 scores. Returns [..., S+1] f32.
    """
    P = np.asarray(P, dtype=np.float32)
    best = P.max(axis=-1)
    prefix = np.zeros(P.shape[:-2] + (P.shape[-2] + 1,), dtype=np.float32)
    np.cumsum(best, axis=-1, dtype=np.float32, out=prefix[..., 1:])
    return prefix


def compute_eps(prefix: jnp.ndarray, k: int, log_threshold, w0,
                block_w: int) -> Dict[Tuple[int, int], jnp.ndarray]:
    """Per-span, per-window pruning thresholds for a block of windows.

    prefix: [S+1] f32 bound-oracle prefix sums for one ghost matrix.
    Returns {(j, h): eps[block_w]} with the top span's eps equal to
    ``log_threshold`` and children derived by the reference's exact f32
    subtraction chain (``pk_compute.cpp:54-55``).
    """
    eps: Dict[Tuple[int, int], jnp.ndarray] = {}
    eps[(0, k)] = jnp.full((block_w,), log_threshold, dtype=jnp.float32)

    def range_max(start_rel: int, length: int) -> jnp.ndarray:
        hi = jax.lax.dynamic_slice(prefix, (w0 + start_rel + length,), (block_w,))
        lo = jax.lax.dynamic_slice(prefix, (w0 + start_rel,), (block_w,))
        return hi - lo

    def descend(j: int, h: int) -> None:
        if h <= 1:
            return
        hl = h // 2
        hr = h - hl
        parent = eps[(j, h)]
        eps[(j, hl)] = parent - range_max(j + hl, hr)
        eps[(j + hl, hr)] = parent - range_max(j, hl)
        descend(j, hl)
        descend(j + hl, hr)

    descend(0, k)
    return eps


def score_window_block(P: jnp.ndarray, prefix: jnp.ndarray, w0, *, k: int,
                       sigma: int, log_threshold, block_w: int) -> jnp.ndarray:
    """Scores of all sigma^k candidates for windows [w0, w0+block_w).

    P: [S, sigma] f32 log10 posteriors of one ghost matrix.
    Returns [block_w, sigma^k] f32; pruned candidates are -inf.
    """
    eps = compute_eps(prefix, k, log_threshold, w0, block_w)
    scores: Dict[Tuple[int, int], jnp.ndarray] = {}
    for (j, h) in split_tree(k):
        e = eps[(j, h)][:, None]
        if h == 1:
            T = jax.lax.dynamic_slice(P, (w0 + j, 0), (block_w, sigma))
        else:
            hl = h // 2
            hr = h - hl
            Tl = scores.pop((j, hl))
            Tr = scores.pop((j + hl, hr))
            T = (Tl[:, :, None] + Tr[:, None, :]).reshape(block_w, -1)
        scores[(j, h)] = jnp.where(T > e, T, NEG_INF)
    return scores[(0, k)]


def masked_span_scores(P: jnp.ndarray, prefix: jnp.ndarray, j: int, h: int,
                       eps: jnp.ndarray, *, k: int, sigma: int) -> jnp.ndarray:
    """Masked sub-window scores for span (j, h) at every window offset.

    P: [S, sigma]; eps: [W] per-window thresholds for this span (threaded down
    the split tree exactly as ``pk_compute.cpp:54-55``). Returns [W, sigma^h]
    f32 with pruned candidates at -inf. The recursion matches DCLA's split
    (h//2, h-h//2) so sums are bit-identical.
    """
    W = P.shape[0] - k + 1

    def range_max(start_rel: int, length: int) -> jnp.ndarray:
        return (jax.lax.dynamic_slice(prefix, (start_rel + length,), (W,))
                - jax.lax.dynamic_slice(prefix, (start_rel,), (W,)))

    if h == 1:
        T = jax.lax.dynamic_slice(P, (j, 0), (W, sigma))
    else:
        hl = h // 2
        hr = h - hl
        eps_l = eps - range_max(j + hl, hr)
        eps_r = eps - range_max(j, hl)
        Tl = masked_span_scores(P, prefix, j, hl, eps_l, k=k, sigma=sigma)
        Tr = masked_span_scores(P, prefix, j + hl, hr, eps_r, k=k, sigma=sigma)
        T = (Tl[:, :, None] + Tr[:, None, :]).reshape(W, -1)
    return jnp.where(T > eps[:, None], T, NEG_INF)


@functools.partial(jax.jit, static_argnames=("k", "sigma"))
def masked_halves(P: jnp.ndarray, prefix: jnp.ndarray, log_threshold,
                  *, k: int, sigma: int):
    """Masked half-window scores (L[W, sigma^(k//2)], R[W, sigma^(k-k//2)]).

    The top-level combine ``score = L + R`` with the *constant* threshold
    ``log_threshold`` then yields exactly :func:`score_window_block`'s output —
    per-window eps variation exists only below the halves. This factorization
    is what the combine exploits: the O(sigma^k) combine reads only these two
    small tensors.
    """
    W = P.shape[0] - k + 1
    hl = k // 2
    hr = k - hl
    eps_top = jnp.full((W,), log_threshold, dtype=jnp.float32)

    def range_max(start_rel, length):
        return (jax.lax.dynamic_slice(prefix, (start_rel + length,), (W,))
                - jax.lax.dynamic_slice(prefix, (start_rel,), (W,)))

    if k == 1:
        L = masked_span_scores(P, prefix, 0, 1, eps_top, k=k, sigma=sigma)
        return L, jnp.zeros((W, 1), dtype=jnp.float32)
    eps_l = eps_top - range_max(hl, hr)
    eps_r = eps_top - range_max(0, hl)
    L = masked_span_scores(P, prefix, 0, hl, eps_l, k=k, sigma=sigma)
    R = masked_span_scores(P, prefix, hl, hr, eps_r, k=k, sigma=sigma)
    return L, R


@functools.partial(jax.jit,
                   static_argnames=("k", "sigma", "block_w", "with_count"))
def accumulate_matrix(P: jnp.ndarray, prefix: jnp.ndarray, log_threshold,
                      *, k: int, sigma: int, block_w: int = 32,
                      with_count: bool = False):
    """Max-over-windows accumulator for one ghost matrix.

    Replaces the per-group hash map + ``put`` insert-or-max
    (``db_builder.cpp:645-665``, ``branch_group.cpp:88-102``): returns
    ``A[sigma^k]`` with A[c] = max over windows of the candidate's score, or
    -inf if pruned in every window. Tail windows are handled by overlapping the
    last block (re-scoring a window is a no-op under max).

    with_count=True additionally returns the number of surviving
    (window, k-mer) tuples — the reference's explored-tuple counter
    (``db_builder.cpp:576-626``) used for the k-mers/sec benchmark metric;
    overlapped tail windows are counted once.
    """
    S = P.shape[0]
    W = S - k + 1
    if W <= 0:
        A = jnp.full((sigma ** k,), NEG_INF, dtype=jnp.float32)
        return (A, jnp.zeros((), jnp.int32)) if with_count else A
    bw = min(block_w, W)
    num_blocks = -(-W // bw)

    def body(i, carry):
        A, count = carry
        w0 = jnp.minimum(i * bw, W - bw)
        T = score_window_block(P, prefix, w0, k=k, sigma=sigma,
                               log_threshold=log_threshold, block_w=bw)
        if with_count:
            fresh = (w0 + jnp.arange(bw)) >= i * bw  # exclude overlap re-scores
            # per-GHOST int32 counter (x64 is off under jit): safe through
            # DNA k=10 (W * sigma^k < 2^31); callers sum ghosts in int64
            per_window = jnp.isfinite(T).sum(axis=1, dtype=jnp.int32)
            count = count + jnp.where(fresh, per_window, 0).sum()
        return jnp.maximum(A, T.max(axis=0)), count

    # the data-derived zero keeps the carry's varying-axes (shard_map vma)
    # consistent with the body output when this runs inside shard_map
    zero = P[:0, 0].sum().astype(jnp.float32)
    A0 = jnp.full((sigma ** k,), NEG_INF, dtype=jnp.float32) + zero
    c0 = jnp.zeros((), jnp.int32) + zero.astype(jnp.int32)
    A, count = jax.lax.fori_loop(0, num_blocks, body, (A0, c0))
    return (A, count) if with_count else A


@functools.partial(jax.jit,
                   static_argnames=("k", "sigma", "block_w", "with_count"))
def accumulate_ghosts(P_all: jnp.ndarray, prefix_all: jnp.ndarray,
                      log_threshold, *, k: int, sigma: int,
                      block_w: int = 32, with_count: bool = False):
    """vmapped :func:`accumulate_matrix` over the ghost axis.

    P_all: [G, S, sigma], prefix_all: [G, S+1] → [G, sigma^k]
    (plus per-ghost tuple counts when with_count).
    """
    fn = functools.partial(accumulate_matrix, k=k, sigma=sigma,
                           block_w=block_w, with_count=with_count)
    return jax.vmap(fn, in_axes=(0, 0, None))(P_all, prefix_all, log_threshold)


@functools.partial(jax.jit, static_argnames=("block_w", "with_count"))
def combine_max_jnp(L: jnp.ndarray, R: jnp.ndarray, log_threshold,
                    *, block_w: int = 16, with_count: bool = False):
    """Plain XLA version of the dense combine, and the reference of the
    Triton kernel (``pallas_kernels.combine_max``, same contract):
    A[g] = max_w mask(L[g,w] ⊕ R[g,w]).

    L: [G, W, nl], R: [G, W, nr] → [G, nl, nr]. Used off the GPU (a key
    batch is a slice of L's last axis).
    with_count additionally returns per-ghost explored-tuple counts (the
    reference's per-window ``num_tuples``, ``db_builder.cpp:576-626``).
    """
    G, W, nl = L.shape
    nr = R.shape[2]
    bw = min(block_w, W)
    num_blocks = -(-W // bw)
    eps = jnp.asarray(log_threshold, dtype=jnp.float32)

    def per_ghost(Lg, Rg):
        def body(i, carry):
            A, cnt = carry
            w0 = jnp.minimum(i * bw, W - bw)
            Lb = jax.lax.dynamic_slice(Lg, (w0, 0), (bw, nl))
            Rb = jax.lax.dynamic_slice(Rg, (w0, 0), (bw, nr))
            T = Lb[:, :, None] + Rb[:, None, :]
            alive = T > eps
            T = jnp.where(alive, T, NEG_INF)
            if with_count:
                # the clamped final block revisits earlier windows; count
                # each window once (rows with global index >= i*bw are new)
                fresh = (w0 + jnp.arange(bw)) >= i * bw
                cnt = cnt + jnp.where(fresh[:, None, None], alive, False
                                      ).sum(dtype=jnp.int32)
            return jnp.maximum(A, T.max(axis=0)), cnt

        zero = Lg[:0, 0].sum()          # ties inits to the input's
        A0 = jnp.full((nl, nr), NEG_INF, dtype=jnp.float32) + zero
        c0 = zero.astype(jnp.int32)     # shard_map varying axes
        A, cnt = jax.lax.fori_loop(0, num_blocks, body, (A0, c0))
        return (A, cnt) if with_count else A

    return jax.vmap(per_ghost)(L, R)


@functools.partial(jax.jit, static_argnames=("block_w", "with_count"))
def combine_max_with_positions(L: jnp.ndarray, R: jnp.ndarray, log_threshold,
                               *, block_w: int = 16,
                               with_count: bool = False):
    """Like :func:`combine_max_jnp` but also tracks the window start position
    of each candidate's best score (the aa-pos variant: the reference stores
    ``window.get_position()``, ``db_builder.cpp:655-659``).

    Tie-breaking matches ``put`` (``branch_group.cpp:73-86``): strictly
    greater replaces, so the earliest window wins ties (windows ascending).
    Returns (A[G, nl, nr], pos[G, nl, nr] int32[, counts[G] int32]).
    """
    G, W, nl = L.shape
    nr = R.shape[2]
    bw = min(block_w, W)
    num_blocks = -(-W // bw)
    eps = jnp.asarray(log_threshold, dtype=jnp.float32)

    def per_ghost(Lg, Rg):
        def body(i, carry):
            A, pos, cnt = carry
            w0 = jnp.minimum(i * bw, W - bw)
            Lb = jax.lax.dynamic_slice(Lg, (w0, 0), (bw, nl))
            Rb = jax.lax.dynamic_slice(Rg, (w0, 0), (bw, nr))
            T = Lb[:, :, None] + Rb[:, None, :]
            alive = T > eps
            T = jnp.where(alive, T, NEG_INF)
            if with_count:
                fresh = (w0 + jnp.arange(bw)) >= i * bw
                cnt = cnt + jnp.where(fresh[:, None, None], alive, False
                                      ).sum(dtype=jnp.int32)
            # overlap windows (clamped tail) rescore identically; argmax picks
            # the first occurrence, preserving earliest-window tie-breaking
            Tmax = T.max(axis=0)
            Targ = (w0 + T.argmax(axis=0)).astype(jnp.int32)
            better = Tmax > A
            return (jnp.where(better, Tmax, A),
                    jnp.where(better, Targ, pos), cnt)

        zero = Lg[:0, 0].sum().astype(jnp.float32)
        A0 = jnp.full((nl, nr), NEG_INF, dtype=jnp.float32) + zero
        p0 = jnp.zeros((nl, nr), dtype=jnp.int32) + zero.astype(jnp.int32)
        A, pos, cnt = jax.lax.fori_loop(
            0, num_blocks, body, (A0, p0, zero.astype(jnp.int32)))
        return (A, pos, cnt) if with_count else (A, pos)

    return jax.vmap(per_ghost)(L, R)


def group_max_with_positions(A_ghost: jnp.ndarray, pos_ghost: jnp.ndarray,
                             ghosts_per_group: int):
    """Ghost merge with strict-greater position tie-breaking: the first ghost
    in group order (X1 before X0, extended postorder) wins ties."""
    G, K = A_ghost.shape
    B = G // ghosts_per_group
    A = A_ghost.reshape(B, ghosts_per_group, K)
    pos = pos_ghost.reshape(B, ghosts_per_group, K)
    best_A, best_pos = A[:, 0], pos[:, 0]
    for g in range(1, ghosts_per_group):
        better = A[:, g] > best_A
        best_A = jnp.where(better, A[:, g], best_A)
        best_pos = jnp.where(better, pos[:, g], best_pos)
    return best_A, best_pos


def compact_survivors(A, materialize: bool = True):
    """Device-side survivor compaction: (flat row-major indices, scores).

    Transfers only surviving entries to the host instead of the dense
    accumulator (at DNA k≥10 the dense [B, σ^k] tensor reaches GBs while
    survivors are typically 100-1000× fewer). The padded-size nonzero keeps
    shapes static per power-of-two bucket. Caller must ensure A.size < 2^31
    (indices are int32 without x64); the key-batch picker enforces this.

    With ``materialize=False`` the padded DEVICE arrays and the survivor
    count are returned instead — the builder uses this to time the
    device→host transfer separately from the on-device compaction.
    """
    A = A if isinstance(A, jnp.ndarray) else jnp.asarray(A)
    if A.size >= (1 << 31):
        raise ValueError(
            f"compact_survivors: accumulator batch of {A.size} elements "
            "exceeds int32 index range; increase key_batches")
    flat = A.ravel()
    mask = jnp.isfinite(flat)
    count = int(mask.sum())
    if count == 0:
        empty = (np.zeros(0, np.int32), np.zeros(0, np.float32))
        return empty if materialize else (*empty, 0)
    size = 1 << (count - 1).bit_length()
    idx = jnp.nonzero(mask, size=size, fill_value=0)[0]
    scores = flat[idx]
    if not materialize:
        return idx, scores, count
    # int32 indices + f32 scores, transferred exactly once
    return (np.asarray(idx[:count], dtype=np.int32),
            np.asarray(scores[:count], dtype=np.float32))


def bitmask_survivors(A):
    """Device-side survivor compaction for HIGH densities: (packed survivor
    bitmask, packed scores, count).

    The compact (idx, score) stream costs 8 B/survivor; past ~3% density the
    int32 indices dominate the transfer. Here the membership is shipped as a
    bitmask over the flattened accumulator (1 bit/cell, MSB-first to match
    ``np.unpackbits``) plus the surviving scores in flat order — cells/8 +
    4 B/survivor, which beats the raw dense tensor (4 B/cell) at every
    density below ~97%. Returns device arrays + the count; the caller
    materializes (and times) the transfer.
    """
    A = A if isinstance(A, jnp.ndarray) else jnp.asarray(A)
    flat = A.ravel()
    mask = jnp.isfinite(flat)
    count = int(mask.sum())
    pad = (-flat.size) % 8
    mbits = jnp.pad(mask, (0, pad)).reshape(-1, 8).astype(jnp.uint8)
    weights = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.uint8)
    packed = (mbits * weights).sum(axis=1).astype(jnp.uint8)
    if count == 0:
        return packed, np.zeros(0, np.float32), 0
    size = 1 << (count - 1).bit_length()
    idx = jnp.nonzero(mask, size=size, fill_value=0)[0]
    return packed, flat[idx], count


def group_max(A_ghost: jnp.ndarray, ghosts_per_group: int) -> jnp.ndarray:
    """Merge ghosts of the same original branch by max.

    A_ghost [G, sigma^k] with ghosts of a group adjacent → [B, sigma^k].
    Replicates the X0/X1 merge of ``explore_group`` (``db_builder.cpp:641-665``).
    """
    G, Kspace = A_ghost.shape
    B = G // ghosts_per_group
    return A_ghost.reshape(B, ghosts_per_group, Kspace).max(axis=1)
