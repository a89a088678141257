"""Multi-chip sharded build step: branch-data-parallel enumeration +
distributed mutual-information reduction.

This is the device-native equivalent of the checklist in SURVEY.md §2.3: the
branch loop the reference left as a commented-out OpenMP pragma
(``db_builder.cpp:602-605``) becomes ``shard_map`` over the "branch" mesh
axis; the mif0 filter pass (``filter.cpp:60-119``) becomes two XLA collective
reductions (``psum`` over the branch axis) on the dense accumulator.

Numerical note: the distributed filter runs in f32 on device (fast path for
pod-scale builds); the canonical serialization path recomputes filter values
in f64 on host (``ipk_tpu.core.filter``) so that DB ordering is exact. The
enumeration itself is bit-exact in both paths.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import dense

__all__ = ["sharded_build_step", "pad_ghosts", "PAD_LOG_SCORE"]

#: Padding value for dummy ghost matrices (branch-axis padding): a large
#: negative *finite* log-score so eps-chain arithmetic stays NaN-free while
#: every padded candidate is pruned to -inf by the threshold masks.
PAD_LOG_SCORE = np.float32(-1e9)


def pad_ghosts(P_all: np.ndarray, prefix_all: np.ndarray, multiple: int):
    """Pad the ghost axis to a multiple (whole groups at a time)."""
    G = P_all.shape[0]
    target = -(-G // multiple) * multiple
    if target == G:
        return P_all, prefix_all, G
    pad = target - G
    P_pad = np.full((pad,) + P_all.shape[1:], PAD_LOG_SCORE, dtype=np.float32)
    pref_pad = dense.best_score_prefix(P_pad)
    return (np.concatenate([P_all, P_pad]),
            np.concatenate([prefix_all, pref_pad]), G)


def _shannon(x):
    return -x * jnp.log2(x)


def _mi_reduce(A_loc, *, total_num_groups, threshold):
    """Collective mif0 over a branch-sharded accumulator slice
    (``filter.cpp:60-119`` as two psums over the branch axis). Exact per
    key — mutual information depends only on that key's entries — so it is
    valid on ANY contiguous key slice, which is what makes the key-batched
    device-MI path possible. Returns fv over this
    device's key-axis shard of the slice."""
    mask = jnp.isfinite(A_loc)
    lin = jnp.where(mask, jnp.minimum(10.0 ** A_loc.astype(jnp.float32), 1.0),
                    0.0)
    cnt = jax.lax.psum(mask.sum(axis=0).astype(jnp.float32), "branch")
    lin_sum = jax.lax.psum(lin.sum(axis=0), "branch")

    N = jnp.float32(total_num_groups)
    thr = jnp.float32(threshold)
    score_sum = lin_sum + (N - cnt) * thr
    tv = jnp.where(mask, _shannon(lin / score_sum[None, :]), 0.0)
    tv_sum = jax.lax.psum(tv.sum(axis=0), "branch")

    # key-axis sharding of the filter-value tail: each key-shard finishes its
    # contiguous k-mer range (the device-resident analog of the reference's
    # k-mer-space batching, branch_group.cpp:104-107)
    n_key = jax.lax.axis_size("key")
    K = score_sum.shape[0]
    chunk = K // n_key
    start = jax.lax.axis_index("key") * chunk
    ss = jax.lax.dynamic_slice(score_sum, (start,), (chunk,))
    cnt_k = jax.lax.dynamic_slice(cnt, (start,), (chunk,))
    tv_k = jax.lax.dynamic_slice(tv_sum, (start,), (chunk,))
    tt = _shannon(thr / ss)
    HcBw1 = N * tt + (tv_k - cnt_k * tt)
    return ss * (HcBw1 - jnp.log2(N))


def _local_step(P_loc, prefix_loc, log_threshold, *, k, sigma,
                ghosts_per_group, total_num_groups, threshold, block_w):
    """Per-device: enumerate local ghosts, then join the collective MI pass."""
    A_ghost, counts = dense.accumulate_ghosts(P_loc, prefix_loc,
                                              log_threshold, k=k,
                                              sigma=sigma, block_w=block_w,
                                              with_count=True)
    A_loc = dense.group_max(A_ghost, ghosts_per_group)        # [B_loc, K]
    fv = _mi_reduce(A_loc, total_num_groups=total_num_groups,
                    threshold=threshold)
    return A_loc, fv, counts


def sharded_enumerate(mesh: Mesh, P_all: np.ndarray, prefix_all: np.ndarray,
                      log_threshold, *, k: int, sigma: int,
                      ghosts_per_group: int, block_w: int = 32) -> np.ndarray:
    """Branch-data-parallel stage 1 only: A[B, σ^k] over the mesh.

    Pads the ghost axis to the mesh (padded groups yield no survivors) and
    returns the unpadded accumulator. Bit-identical to the single-device
    path (enumeration has no cross-branch arithmetic).
    """
    n_branch = mesh.shape["branch"]
    P_pad, prefix_pad, G = pad_ghosts(np.asarray(P_all, np.float32),
                                      np.asarray(prefix_all, np.float32),
                                      n_branch * ghosts_per_group)

    def local(P_loc, prefix_loc):
        A_ghost = dense.accumulate_ghosts(P_loc, prefix_loc, log_threshold,
                                          k=k, sigma=sigma, block_w=block_w)
        return dense.group_max(A_ghost, ghosts_per_group)

    mapped = jax.jit(jax.shard_map(local, mesh=mesh,
                                   in_specs=(P("branch"), P("branch")),
                                   out_specs=P("branch")))
    A = mapped(P_pad, prefix_pad)
    return np.asarray(A)[:G // ghosts_per_group]


def sharded_build_step(mesh: Mesh, *, k: int, sigma: int, ghosts_per_group: int,
                       total_num_groups: int, threshold: float,
                       block_w: int = 32):
    """Build the jitted sharded step: (P_all, prefix_all, log_threshold) →
    (A[B, σ^k] branch-sharded, fv[σ^k] f32 key-sharded,
    counts[G] branch-sharded explored-tuple totals).

    P_all's ghost axis must be divisible by mesh branch size × group size
    (use :func:`pad_ghosts`).
    """
    local = functools.partial(
        _local_step, k=k, sigma=sigma, ghosts_per_group=ghosts_per_group,
        total_num_groups=total_num_groups, threshold=threshold,
        block_w=block_w)
    n_key = mesh.shape.get("key", 1)
    if (sigma ** k) % n_key != 0:
        raise ValueError(f"key-axis size {n_key} must divide sigma^k")
    mapped = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("branch"), P("branch"), P()),
        out_specs=(P("branch"), P("key"), P("branch")))

    @jax.jit
    def step(P_all, prefix_all, log_threshold):
        P_all = jax.lax.with_sharding_constraint(
            P_all, NamedSharding(mesh, P("branch")))
        prefix_all = jax.lax.with_sharding_constraint(
            prefix_all, NamedSharding(mesh, P("branch")))
        return mapped(P_all, prefix_all, log_threshold)

    return step


def sharded_batched_build_step(mesh: Mesh, *, k: int, sigma: int,
                               ghosts_per_group: int, total_num_groups: int,
                               threshold: float, key_batches: int,
                               block_w: int = 32):
    """Key-batched device-MI build step: enumeration AND
    the mutual-information reduction stay on device even when the dense
    accumulator does not fit HBM in one piece.

    The key space is split along the LEFT half-window axis into
    ``key_batches`` contiguous slices (the builder's usual batching); mif0
    is per-key separable, so running :func:`_mi_reduce` on each slice gives
    exactly the values the unbatched step computes. Halves are built once
    per call (cheap, [G, W, σ^⌈k/2⌉]); only the [B, chunk] accumulator
    slice ever exists.

    Returns ``(halves_fn, batch_fn, step_l)``:
      halves_fn(P_pad, prefix_pad, eps) -> (L, R) branch-sharded
      batch_fn(L, R, eps, lo_l) -> (A_b [B, step_l·nr], fv_b, counts_b)
    with ``lo_l`` the left-index offset (traced — one compile for all
    batches).
    """
    hl = k // 2
    nl = sigma ** hl
    if nl % key_batches != 0:
        raise ValueError(f"key_batches {key_batches} must divide {nl}")
    step_l = nl // key_batches
    n_key = mesh.shape.get("key", 1)

    def halves_local(P_loc, prefix_loc, log_threshold):
        return jax.vmap(
            functools.partial(dense.masked_halves, k=k, sigma=sigma),
            in_axes=(0, 0, None))(P_loc, prefix_loc, log_threshold)

    halves_fn = jax.jit(jax.shard_map(
        halves_local, mesh=mesh,
        in_specs=(P("branch"), P("branch"), P()),
        out_specs=P("branch")))

    def batch_local(L_loc, R_loc, log_threshold, lo_l):
        Lb = jax.lax.dynamic_slice_in_dim(L_loc, lo_l, step_l, axis=2)
        A_ghost, counts = dense.combine_max_jnp(Lb, R_loc, log_threshold,
                                                block_w=block_w,
                                                with_count=True)
        A_loc = dense.group_max(
            A_ghost.reshape(A_ghost.shape[0], -1), ghosts_per_group)
        fv = _mi_reduce(A_loc, total_num_groups=total_num_groups,
                        threshold=threshold)
        return A_loc, fv, counts

    if (step_l * (sigma ** (k - hl))) % n_key != 0:
        raise ValueError(f"key-axis size {n_key} must divide the batch")
    batch_fn = jax.jit(jax.shard_map(
        batch_local, mesh=mesh,
        in_specs=(P("branch"), P("branch"), P(), P()),
        out_specs=(P("branch"), P("key"), P("branch"))))
    return halves_fn, batch_fn, step_l
