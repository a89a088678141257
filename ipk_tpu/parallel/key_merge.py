"""Device-resident cross-shard key merge (blueprint SURVEY.md §7.2 item 4).

The reference aggregates stage-1 survivors through per-branch hash maps and a
``key % 32`` spill/merge (``branch_group.cpp:88-107``, ``db_builder.cpp:
340-458``). The device-native equivalent implemented here keeps the whole merge
on device:

    per branch shard:  (cl, cr, score) survivor tuples over local groups
      1. sort by (cl, cr, group) with max-score-first within a run
      2. segment-max: keep the first tuple of each (key, group) run —
         the insert-or-max ``put`` (``branch_group.cpp:88-102``) over
         windows and ghosts at once
      3. compact survivors to the front (stable sort on the keep flag)
      4. bin by contiguous key range (dst = cl·n_dev // nl with
         nl = 2^(bits·hl), the BIT-packed cl code space — the
         contiguous-range analog of ``kmer_batch``'s ``key % n``; σ^hl is
         WRONG for non-power-of-two alphabets, whose packed codes exceed
         it — AA codes above σ^hl would silently fall outside every
         bucket)
      5. all_to_all over the mesh axis: device d receives every shard's
         tuples for key range d
      6. final sort by (cl, cr, group) → a key-major, group-ascending
         entry stream per key range

The host then concatenates the per-device streams in mesh order (ascending
key ranges) and packs (cl, cr) into uint64 keys — no host lexsort over the
entry set. Scores are exact maxima (no arithmetic), so the resulting DB is
byte-equal to the host merge path (asserted by tests/test_key_merge.py and
the multichip dryrun).

Static shapes: each (src, dst) bucket is capacity-bounded; a skewed key
distribution overflows loudly and the caller falls back to the host merge
(telemetry counts this). All device data stays uint32/f32 — keys are packed
to uint64 only on host (``pk_compute.cpp:96-105``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["device_key_merge", "KeyMergeOverflow"]

_INVALID_CODE = np.uint32(0xFFFFFFFF)
_NEG_INF = np.float32(-np.inf)


class KeyMergeOverflow(Exception):
    """A (src, dst) bucket exceeded its capacity (skewed key distribution)."""


def _local_merge_and_exchange(cl, cr, scores, *, groups_per_dev: int,
                              ghosts_per_group: int, nl: int, bucket_cap: int,
                              axis: str):
    """shard_map body. cl/cr: [G_loc, W, C] uint32, scores f32. Returns
    (cl_out, cr_out, b_out, s_out [n_dev*bucket_cap], n_valid[1],
    overflow[1])."""
    n_dev = jax.lax.axis_size(axis)
    dev = jax.lax.axis_index(axis)
    G_loc, W, C = cl.shape
    n_groups_loc = G_loc // ghosts_per_group

    # flatten to one local tuple list; branch = GLOBAL group index
    group_local = jax.lax.broadcasted_iota(
        jnp.uint32, (G_loc, W, C), 0) // np.uint32(ghosts_per_group)
    b = (group_local + dev.astype(jnp.uint32)
         * np.uint32(n_groups_loc)).reshape(-1)
    cl = cl.reshape(-1)
    cr = cr.reshape(-1)
    s = scores.reshape(-1)
    valid = jnp.isfinite(s)
    cl = jnp.where(valid, cl, _INVALID_CODE)
    cr = jnp.where(valid, cr, _INVALID_CODE)

    # (1) sort by (cl, cr, b, -s): within one (key, group) run the max score
    # comes first; invalid tuples (cl = MAX) sink to the end. -s is only a
    # sort KEY — s rides along untouched so byte patterns (e.g. -0.0)
    # survive exactly
    cl, cr, b, _, s = jax.lax.sort((cl, cr, b, -s, s), num_keys=4)

    # (2) insert-or-max: keep only the first tuple of each (cl, cr, b) run
    first = jnp.ones_like(cl, dtype=bool)
    same = ((cl[1:] == cl[:-1]) & (cr[1:] == cr[:-1]) & (b[1:] == b[:-1]))
    first = first.at[1:].set(~same)
    keep = first & jnp.isfinite(s)
    n_valid = keep.sum(dtype=jnp.int32)

    # (3) stable-compact kept tuples to the front (they stay key-sorted)
    cl = jnp.where(keep, cl, _INVALID_CODE)
    cr = jnp.where(keep, cr, _INVALID_CODE)
    s = jnp.where(keep, s, _NEG_INF)
    flag = (~keep).astype(jnp.uint32)
    flag, cl, cr, b, s = jax.lax.sort((flag, cl, cr, b, s), num_keys=1,
                                      is_stable=True)

    # (4) contiguous key-range binning on the high half: dst(cl) is
    # non-decreasing along the sorted list, so bucket d is the slice
    # [starts[d], starts[d+1]) — counts by vectorized range comparison
    bounds = jnp.asarray(
        [(d * nl + n_dev - 1) // n_dev for d in range(n_dev + 1)],
        dtype=jnp.uint32)                                  # [n_dev+1]
    live_cl = jnp.where(jnp.arange(cl.shape[0]) < n_valid, cl, _INVALID_CODE)
    starts = (live_cl[None, :] < bounds[:, None]).sum(
        axis=1, dtype=jnp.int32)                            # [n_dev+1]
    counts = starts[1:] - starts[:-1]
    overflow = (counts > bucket_cap).any()

    # pad so every dynamic_slice is in range, then gather each bucket
    pad = bucket_cap
    cl_p = jnp.concatenate([cl, jnp.full((pad,), _INVALID_CODE, jnp.uint32)])
    cr_p = jnp.concatenate([cr, jnp.full((pad,), _INVALID_CODE, jnp.uint32)])
    b_p = jnp.concatenate([b, jnp.zeros((pad,), jnp.uint32)])
    s_p = jnp.concatenate([s, jnp.full((pad,), _NEG_INF, jnp.float32)])
    lane = jnp.arange(bucket_cap, dtype=jnp.int32)

    def bucket(d):
        st = starts[d]
        cnt = jnp.minimum(counts[d], bucket_cap)
        m = lane < cnt
        return (jnp.where(m, jax.lax.dynamic_slice(cl_p, (st,), (bucket_cap,)),
                          _INVALID_CODE),
                jnp.where(m, jax.lax.dynamic_slice(cr_p, (st,), (bucket_cap,)),
                          _INVALID_CODE),
                jnp.where(m, jax.lax.dynamic_slice(b_p, (st,), (bucket_cap,)),
                          0),
                jnp.where(m, jax.lax.dynamic_slice(s_p, (st,), (bucket_cap,)),
                          _NEG_INF))

    outs = [bucket(d) for d in range(n_dev)]               # n_dev is static
    cl_b = jnp.stack([o[0] for o in outs])                 # [n_dev, cap]
    cr_b = jnp.stack([o[1] for o in outs])
    b_b = jnp.stack([o[2] for o in outs])
    s_b = jnp.stack([o[3] for o in outs])

    # (5) exchange: row d goes to device d; we receive one row per source
    cl_r = jax.lax.all_to_all(cl_b, axis, split_axis=0, concat_axis=0)
    cr_r = jax.lax.all_to_all(cr_b, axis, split_axis=0, concat_axis=0)
    b_r = jax.lax.all_to_all(b_b, axis, split_axis=0, concat_axis=0)
    s_r = jax.lax.all_to_all(s_b, axis, split_axis=0, concat_axis=0)

    # (6) final order inside this device's key range
    cl_o, cr_o, b_o, s_o = jax.lax.sort(
        (cl_r.reshape(-1), cr_r.reshape(-1), b_r.reshape(-1),
         s_r.reshape(-1)), num_keys=3)
    n_out = jnp.isfinite(s_o).sum(dtype=jnp.int32)
    return (cl_o, cr_o, b_o, s_o, n_out[None],
            overflow[None])


@functools.lru_cache(maxsize=32)
def _merge_fn(mesh: Mesh, groups_per_dev: int, ghosts_per_group: int,
              nl: int, bucket_cap: int, multiprocess: bool):
    local = functools.partial(
        _local_merge_and_exchange, groups_per_dev=groups_per_dev,
        ghosts_per_group=ghosts_per_group, nl=nl, bucket_cap=bucket_cap,
        axis="branch")
    out_sh = NamedSharding(mesh, P()) if multiprocess else None
    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("branch"), P("branch"), P("branch")),
        out_specs=(P("branch"), P("branch"), P("branch"), P("branch"),
                   P("branch"), P("branch"))), out_shardings=out_sh)


def device_key_merge(mesh: Mesh, cl: np.ndarray, cr: np.ndarray,
                     scores: np.ndarray, *, ghosts_per_group: int,
                     nl: int, bits: int, k: int,
                     bucket_cap: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge branch-sharded survivor tuples into a key-major entry stream.

    cl/cr: [G, W, C] uint32 half-codes (G divisible by the mesh's branch
    size × ghosts_per_group — callers pad with inert ghosts), scores [G, W,
    C] f32 (-inf = empty slot). Returns host arrays (keys uint64, group_idx
    int64, scores f32) sorted by (key, group) with per-(key, group) max
    scores — exactly the stream ``_extract_from_lists`` otherwise builds
    with a host lexsort. Raises :class:`KeyMergeOverflow` when a key-range
    bucket exceeds ``bucket_cap`` (callers fall back to the host merge).
    """
    n_dev = mesh.shape["branch"]
    G, W, C = cl.shape
    G_loc = G // n_dev
    n_groups_loc = G_loc // ghosts_per_group
    if bucket_cap is None:
        T_loc = G_loc * W * C
        bucket_cap = min(T_loc, 4 * (T_loc // max(1, n_dev)) + 1024)
    bucket_cap = int(-(-bucket_cap // 128) * 128)

    sh = NamedSharding(mesh, P("branch"))
    fn = _merge_fn(mesh, n_groups_loc, ghosts_per_group, int(nl),
                   int(bucket_cap), jax.process_count() > 1)

    def put(x, dtype):
        # device-resident inputs (the enumeration's own outputs) re-shard
        # without a host round-trip; host arrays transfer once
        if isinstance(x, jax.Array):
            return jax.device_put(x, sh)
        return jax.device_put(np.ascontiguousarray(x, dtype), sh)

    cl_o, cr_o, b_o, s_o, n_out, ovf = fn(
        put(cl, np.uint32), put(cr, np.uint32), put(scores, np.float32))
    ovf = np.asarray(ovf)
    if ovf.any():
        raise KeyMergeOverflow(
            f"device key merge bucket capacity {bucket_cap} exceeded on "
            f"{int(ovf.sum())} device(s)")
    n_out = np.asarray(n_out)
    cl_h = np.asarray(cl_o)
    cr_h = np.asarray(cr_o)
    b_h = np.asarray(b_o)
    s_h = np.asarray(s_o)
    N_out = cl_h.shape[0] // n_dev
    shift = np.uint64(bits * (k - k // 2))
    keys_parts, b_parts, s_parts = [], [], []
    for d in range(n_dev):
        m = int(n_out[d])
        lo = d * N_out
        keys_parts.append(
            (cl_h[lo:lo + m].astype(np.uint64) << shift)
            | cr_h[lo:lo + m].astype(np.uint64))
        b_parts.append(b_h[lo:lo + m].astype(np.int64))
        s_parts.append(s_h[lo:lo + m])
    return (np.concatenate(keys_parts), np.concatenate(b_parts),
            np.concatenate(s_parts))
