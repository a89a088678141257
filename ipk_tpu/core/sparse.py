"""Capacity-bounded sparse enumeration for large k.

The dense path (``dense.py``) scores all σ^k candidates, which is optimal for
small keyspaces but grows as σ^k regardless of pruning. The reference handles
large k with recursive survivor lists whose sizes adapt to the data
(``pk_compute.cpp:42-114``); data-dependent sizes are hostile to XLA, so this
module uses the statically-shaped equivalent flagged in SURVEY.md §7.4:
**capacity-bounded survivor lists with overflow detection**, with one crucial
refinement over a single global bound: capacities are **per span of the DCLA
split tree** and sized from the data.

At realistic (ω, k) the per-span survivor counts are minuscule compared to
the candidate space (measured on AR-like posteriors: DNA k=12 ω=2 keeps ≤
~256 of 4096 half-window candidates; AA k=6 ω=4 keeps ≤ ~256 of 8000 at
h=3), so a cheap host-side probe (:func:`probe_caps`) samples a few windows,
runs the exact recursion on variable-length numpy lists, and snaps each
span's capacity to a small padded bound. The device computation is then
O(Σ_span W·cap_L·cap_R) instead of O(W·σ^k) — the same data-dependent win
the reference's recursion gets, with static shapes. Overflow (a window
exceeding a span's cap) is detected per span and the affected span's cap is
doubled and the chunk re-run (compile cache per cap tuple), failing loudly
only at the user ceiling — silent truncation would drop valid k-mers.

Per span (j, h), survivors are combined as a **staircase**: with the right
operand sorted by (score desc, code asc), the surviving j for each row i
form a prefix in j (f32 addition is monotone), so the survivor region is
fully described by per-row counts. Mirroring the reference's own trick
(``pk_compute.cpp:61-70``), the SMALLER child is routed to the sorted side
and the bigger child stays in its given order — the sort is the one
O(C log C) step. The combine+select is plain XLA (``_staircase_xla``): an
XLA sort by the two-key order, per-row counts by a binary search on the
sorted right list, offsets by a cumsum, and each output slot's (row, column) by a rank query
(binary search) on the monotone offsets followed by gathers — the
vectorized equivalent of DCLA's sort-the-smaller-side + early-break pairwise
loop (``pk_compute.cpp:61-110``). The emission order (row-major over the
sorted views) is deterministic, so every backend emits identical slots.

Scores follow the identical f32 summation tree, so values are bit-equal to
the dense path. Codes stay ``uint32`` on device (every half-window needs ≤
32 bits for the supported k ranges); the host packs the final
(prefix, suffix) pairs into reference-layout ``uint64`` keys
(``pk_compute.cpp:96-105``) — no 64-bit emulation in the hot path.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .dense import NEG_INF, split_tree

__all__ = ["enumerate_sparse", "enumerate_sparse_many",
           "enumerate_pairs_device", "merge_window_lists", "probe_caps",
           "default_caps", "normalize_caps"]

#: spans with σ^h at or below this stay complete (no selection, no overflow).
#: Capacity-bounding wider products compacts the staircase children
#: alive-first, which shrinks every downstream span. Not yet re-tuned on the
#: GPU.
COMPLETE_LIMIT = 256

#: batch same-shape spans into one staircase — an experiment knob, off by
#: default; its effect on the GPU is not measured
GROUP_SPANS = False


# ---------------------------------------------------------------------------
# capacity plans
# ---------------------------------------------------------------------------

def _spans(k: int) -> List[Tuple[int, int]]:
    """Non-leaf spans of the split tree, children before parents (top last)."""
    return [(j, h) for (j, h) in split_tree(k) if h > 1]


def _natural_size(j: int, h: int, sigma: int,
                  caps: Dict[Tuple[int, int], int]) -> int:
    """List size of span (j, h) given the caps of its children."""
    if h == 1:
        return sigma
    hl = h // 2
    cl = caps.get((j, hl), _natural_size(j, hl, sigma, caps))
    cr = caps.get((j + hl, h - hl),
                  _natural_size(j + hl, h - hl, sigma, caps))
    return cl * cr


def default_caps(k: int, sigma: int, cap: int,
                 initial: int = 256) -> Dict[Tuple[int, int], int]:
    """Conservative starting capacities: complete below COMPLETE_LIMIT,
    ``initial`` (≤ cap) elsewhere."""
    caps: Dict[Tuple[int, int], int] = {}
    for (j, h) in _spans(k):
        size = _natural_size(j, h, sigma, caps)
        caps[(j, h)] = size if size <= COMPLETE_LIMIT else min(cap, max(
            128, initial))
    return caps


def normalize_caps(caps: Dict[Tuple[int, int], int], k: int, sigma: int,
                   cap: int) -> Dict[Tuple[int, int], int]:
    """Clamp caps to natural sizes / ceiling and snap to 128 multiples."""
    out: Dict[Tuple[int, int], int] = {}
    for (j, h) in _spans(k):
        natural = _natural_size(j, h, sigma, out)
        c = caps.get((j, h), natural)
        if natural <= COMPLETE_LIMIT and natural <= cap:
            out[(j, h)] = natural
        else:
            c = min(max(c, 128), cap, natural)
            out[(j, h)] = min(natural, cap, -(-c // 128) * 128)
    return out


def _caps_key(caps: Dict[Tuple[int, int], int]) -> tuple:
    return tuple(sorted(caps.items()))


def probe_caps(P_all: np.ndarray, prefix_all: np.ndarray, log_threshold,
               *, k: int, sigma: int, cap: int, max_ghosts: int = 4,
               max_windows: int = 12, margin: float = 2.0,
               ) -> Dict[Tuple[int, int], int]:
    """Sample a few (ghost, window) pairs, run the exact survivor recursion
    on variable-length numpy lists, and derive per-span capacities (max
    observed count × margin, snapped up to a multiple of 128).

    The probe is exact on the sampled windows (same f32 eps chains and
    summation tree as the device code); unsampled windows may still overflow,
    which the device path detects per span and the caller repairs by
    doubling. Cost is O(samples · survivors²) — negligible next to a build.
    """
    P_all = np.asarray(P_all, dtype=np.float32)
    prefix_all = np.asarray(prefix_all, dtype=np.float32)
    G, S = P_all.shape[0], P_all.shape[1]
    W = S - k + 1
    maxima: Dict[Tuple[int, int], int] = {}
    if W <= 0 or G == 0:
        return normalize_caps(maxima, k, sigma, cap)
    g_idx = np.unique(np.linspace(0, G - 1, min(G, max_ghosts)).astype(int))
    w_idx = np.unique(np.linspace(0, W - 1, min(W, max_windows)).astype(int))

    for g in g_idx:
        P = P_all[g]
        prefix = prefix_all[g]
        for w in w_idx:
            def rng_max(s: int, l: int) -> np.float32:
                return np.float32(prefix[w + s + l] - prefix[w + s])

            def lists(j: int, h: int, eps: np.float32) -> np.ndarray:
                if h == 1:
                    col = P[w + j]
                    return col[col > eps]
                hl = h // 2
                hr = h - hl
                eps_l = np.float32(eps - rng_max(j + hl, hr))
                eps_r = np.float32(eps - rng_max(j, hl))
                a = lists(j, hl, eps_l)
                b = lists(j + hl, hr, eps_r)
                if a.size * b.size > (1 << 24):
                    # pathological window: record the ceiling and truncate
                    maxima[(j, h)] = max(maxima.get((j, h), 0), cap)
                    a = np.sort(a)[::-1][:4096]
                    b = np.sort(b)[::-1][:4096]
                s = (a[:, None] + b[None, :]).ravel()
                s = s[s > eps]
                maxima[(j, h)] = max(maxima.get((j, h), 0), s.size)
                return s

            lists(0, k, np.float32(log_threshold))

    caps = {span: max(128, int(-(-int(n * margin) // 128) * 128))
            for span, n in maxima.items()}
    return normalize_caps(caps, k, sigma, cap)


# ---------------------------------------------------------------------------
# span primitives (batched over [G, W, ...])
# ---------------------------------------------------------------------------

def _span_eps(prefix_all: jnp.ndarray, k: int, W: int, log_threshold
              ) -> Dict[Tuple[int, int], jnp.ndarray]:
    """Per-span per-window pruning thresholds [G, W], by the reference's
    exact f32 subtraction chain (``pk_compute.cpp:54-55``)."""
    G = prefix_all.shape[0]
    eps: Dict[Tuple[int, int], jnp.ndarray] = {
        (0, k): jnp.full((G, W), log_threshold, dtype=jnp.float32)}

    def range_max(s: int, l: int) -> jnp.ndarray:
        return (jax.lax.slice_in_dim(prefix_all, s + l, s + l + W, axis=1)
                - jax.lax.slice_in_dim(prefix_all, s, s + W, axis=1))

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


def _sort_desc(codes: jnp.ndarray, scores: jnp.ndarray):
    """Sort each row's (code, score) pairs by (score desc, code asc) —
    pruned -inf slots sink to the end. The code tiebreak (in UNSIGNED
    order: DNA k=31 half-windows use all 32 bits) makes the permutation a
    deterministic total order, so the emitted slot order does not depend on
    the sort's implementation. Values are untouched."""
    ci = (jax.lax.bitcast_convert_type(codes, jnp.int32)
          ^ np.int32(-0x80000000))
    neg, ci, codes = jax.lax.sort((-scores, ci, codes), num_keys=2,
                                  dimension=-1)
    return codes, -neg


def _complete_product(cl, sl, cr, sr, eps, shift):
    """Materialize the full child product (CL·CR ≤ cap): no selection."""
    G, W, CL = sl.shape
    CR = sr.shape[2]
    scores = (sl[:, :, :, None] + sr[:, :, None, :]).reshape(G, W, CL * CR)
    scores = jnp.where(scores > eps[:, :, None], scores, NEG_INF)
    if shift is None:
        clg = jnp.broadcast_to(cl[:, :, :, None],
                               (G, W, CL, CR)).reshape(G, W, -1)
        crg = jnp.broadcast_to(cr[:, :, None, :],
                               (G, W, CL, CR)).reshape(G, W, -1)
        return (clg, crg), scores
    codes = ((cl[:, :, :, None] << np.uint32(shift)) | cr[:, :, None, :]
             ).reshape(G, W, CL * CR)
    return codes, scores


def _staircase_xla(cL, sL, cR, sR, eps, *, cap: int, shift):
    """Staircase combine of two survivor lists.

    With the right list sorted score-descending, the surviving j for each i
    form a PREFIX (f32 addition is monotone), so the survivor region is a
    monotone staircase fully described by per-i counts. Each count is the
    end of that prefix, found by a binary search over j on the exact
    predicate ``fl(sL[i]+sR[j]) > eps``. Flat slot t lies in the unique row
    i with offx[i] <= t < offx[i+1]; the offsets are monotone, so a rank
    query (binary search) finds it, and j = t - offx[i]. Values come from
    plain gathers, so they are the exact f32 inputs. Emission order is
    row-major (i asc, j asc).

    cL/sL: [G, W, CL] (any order), cR/sR: [G, W, CR] (sorted desc). Returns
    (codes, scores [G, W, C], counts [G, W]) with C = min(cap, CL·CR); with
    ``shift=None`` codes is the (cL_sel, cR_sel) pair.
    """
    G, W, CL = sL.shape
    CR = sR.shape[2]
    out_cap = min(cap, CL * CR)

    # exact per-i survivor counts (the staircase profile): the predicate is
    # true on j < cnt[i] and false from there (f32 rounding is monotone), so
    # bisect [lo, hi) down to that boundary; O(CL log CR) per window
    lo = jnp.zeros((G, W, CL), jnp.int32)
    hi = jnp.full((G, W, CL), CR, jnp.int32)
    for _ in range(CR.bit_length()):
        mid = (lo + hi) // 2
        s = sL + jnp.take_along_axis(sR, jnp.minimum(mid, CR - 1), axis=2)
        live = (mid < hi) & (s > eps[..., None])
        lo = jnp.where(live, mid + 1, lo)
        hi = jnp.where(live, hi, mid)
    cnt = lo
    offx = jnp.concatenate(
        [jnp.zeros((G, W, 1), jnp.int32),
         jnp.cumsum(cnt, axis=2, dtype=jnp.int32)], axis=2)  # [G, W, CL+1]
    total = offx[..., -1]

    t = jnp.arange(out_cap, dtype=jnp.int32)
    rank = jax.vmap(jax.vmap(
        lambda o: jnp.searchsorted(o, t, side="right")))(offx)  # [G, W, C]
    row = jnp.minimum(rank - 1, CL - 1)
    col = t - jnp.take_along_axis(offx, row, axis=2)
    valid = t < total[..., None]
    col = jnp.where(valid, col, 0)

    def take(x, idx):
        return jnp.take_along_axis(x, idx, axis=2)

    s = take(sL, row) + take(sR, col)
    valid = valid & (s > eps[..., None])
    s = jnp.where(valid, s, NEG_INF)
    # dead slots carry code 0
    clg = jnp.where(valid, take(cL, row), 0)
    crg = jnp.where(valid, take(cR, col), 0)
    if shift is None:
        return (clg, crg), s, total
    return (clg << np.uint32(shift)) | crg, s, total


def _policy(CL: int, CR: int, cap: int) -> Tuple[bool, bool]:
    """(swap, sort_l) for a staircase of child widths (CL, CR) and output
    capacity cap. ``swap`` exchanges the operands (staircase L := right
    child, sorted operand := left child); ``sort_l`` sorts the L operand
    too. The rule was tuned for an earlier kernel and is not yet re-tuned on
    the GPU; it changes only the slot order, never the survivor sets:

    * strongly asymmetric spans (AA h=3: 20 × 400): the SMALL child goes on
      the L side and both sides are sorted;
    * comparable widths: the smaller child becomes the sorted staircase
      operand (the reference's own sort-the-smaller-side,
      ``pk_compute.cpp:61-70``); the big L is sorted too when there are
      many output slots (cap > 512) or both lists are narrow.
    """
    big, small = max(CL, CR), min(CL, CR)
    if small * 4 <= big:
        return CL > CR, True
    swap = CR > CL
    sort_l = cap > 512 or big <= 128
    return swap, sort_l


def _combine_group(lists, spans, eps, *, sigma: int, bits: int,
                   caps: Dict[Tuple[int, int], int], k: int):
    """Build one or more SAME-SHAPE spans' survivor lists from their
    children — same-shape staircases are concatenated along the ghost axis
    and run as ONE staircase (per-window arithmetic is independent, so
    batched results are bit-identical to per-span calls).
    Returns {span: (codes-or-pair, scores, overflow[G])}.
    """
    j0, h0 = spans[0]
    hl = h0 // 2
    hr = h0 - hl
    children = [(lists[(j, h // 2)], lists[(j + h // 2, h - h // 2)])
                for (j, h) in spans]
    CL = children[0][0][1].shape[2]
    CR = children[0][1][1].shape[2]
    out_cap = caps[spans[0]]
    G = children[0][0][1].shape[0]
    child_ovf = {s: (lc[2] | rc[2]) for s, (lc, rc) in zip(spans, children)}

    if CL * CR <= out_cap:
        # complete products are cheap fused XLA — no batching needed
        out = {}
        for span, ((cl, sl, _), (cr, sr, _)) in zip(spans, children):
            shift = None if span == (0, k) else bits * hr
            codes, scores = _complete_product(cl, sl, cr, sr, eps[span],
                                              shift)
            out[span] = (codes, scores, child_ovf[span])
        return out

    swap, sort_l = _policy(CL, CR, out_cap)

    def pick(ch):
        (cl, sl, _), (cr, sr, _) = ch
        return (cr, sr, cl, sl) if swap else (cl, sl, cr, sr)

    picked = [pick(ch) for ch in children]
    if len(spans) > 1:
        a_c, a_s, b_c, b_s = (jnp.concatenate([p[i] for p in picked], axis=0)
                              for i in range(4))
        eps_cat = jnp.concatenate([eps[s] for s in spans], axis=0)
    else:
        a_c, a_s, b_c, b_s = picked[0]
        eps_cat = eps[spans[0]]

    if sort_l:
        a_c, a_s = _sort_desc(a_c, a_s)
    b_c, b_s = _sort_desc(b_c, b_s)
    (ag, bg), scores, totals = _staircase_xla(
        a_c, a_s, b_c, b_s, eps_cat, cap=out_cap, shift=None)

    out = {}
    for i, span in enumerate(spans):
        sl_ = slice(i * G, (i + 1) * G)
        ovf = (totals[sl_] > out_cap).any(axis=1)
        clg, crg = ((bg[sl_], ag[sl_]) if swap else (ag[sl_], bg[sl_]))
        if span == (0, k):
            codes = (clg, crg)
        else:
            codes = (clg << np.uint32(bits * hr)) | crg
        out[span] = (codes, scores[sl_], child_ovf[span] | ovf)
    return out


@functools.partial(jax.jit,
                   static_argnames=("k", "sigma", "bits", "caps_t"))
def _pairs_device(P_all, prefix_all, log_threshold, *, k: int, sigma: int,
                  bits: int, caps_t: tuple):
    """Whole-batch device enumeration: ONE dispatch per (shape, caps).

    P_all: [G, S, sigma] f32, prefix_all: [G, S+1] f32. Returns
    (cl_sel, cr_sel [G, W, C] uint32, scores [G, W, C] f32,
    ovf_spans [1, n_spans] bool in ``_spans(k)`` order,
    ovf_ghosts [G] bool) where a survivor's packed key is
    ``cl << (bits·(k - k//2)) | cr`` (``pk_compute.cpp:96-105``).
    All device arithmetic is f32/int32 — no 64-bit emulation. Overflow is
    aggregated ON DEVICE into the two small arrays, so the host reads one
    small vector per dispatch instead of one flag per span."""
    caps = dict(caps_t)
    G, S = P_all.shape[0], P_all.shape[1]
    W = S - k + 1
    eps = _span_eps(prefix_all, k, W, log_threshold)

    if k == 1:
        T = jax.lax.slice_in_dim(P_all, 0, W, axis=1)
        scores = jnp.where(T > eps[(0, 1)][:, :, None], T, NEG_INF)
        codes = jnp.broadcast_to(
            jax.lax.broadcasted_iota(jnp.uint32, (1, 1, sigma), 2),
            (G, W, sigma))
        return (jnp.zeros_like(codes), codes, scores,
                jnp.zeros((1, 1), bool), jnp.zeros((G,), bool))

    lists: Dict[Tuple[int, int], tuple] = {}
    overflow: Dict[Tuple[int, int], jnp.ndarray] = {}
    no_ovf = jnp.zeros((G,), dtype=bool)
    for (j, h) in split_tree(k):
        if h == 1:
            span = (j, h)
            T = jax.lax.slice_in_dim(P_all, j, j + W, axis=1)  # [G, W, σ]
            scores = jnp.where(T > eps[span][:, :, None], T, NEG_INF)
            codes = jnp.broadcast_to(
                jax.lax.broadcasted_iota(jnp.uint32, (1, 1, sigma), 2),
                (G, W, sigma))
            lists[span] = (codes, scores, no_ovf)

    # process staircase spans LEVEL by level. Same-shape spans of a level
    # CAN run as one concatenated staircase (_combine_group takes a list);
    # GROUP_SPANS turns that on.
    levels: Dict[Tuple[int, int], int] = {}

    def level(j, h):
        if (j, h) not in levels:
            if h == 1:
                levels[(j, h)] = 0
            else:
                hl = h // 2
                levels[(j, h)] = 1 + max(level(j, hl),
                                         level(j + hl, h - hl))
        return levels[(j, h)]

    level(0, k)
    by_level: Dict[int, list] = {}
    for span in _spans(k):
        by_level.setdefault(levels[span], []).append(span)

    for lv in sorted(by_level):
        groups: Dict[tuple, list] = {}
        for (j, h) in by_level[lv]:
            hl = h // 2
            sig = ((hl, h - hl, lists[(j, hl)][1].shape[2],
                    lists[(j + hl, h - hl)][1].shape[2], caps[(j, h)])
                   if GROUP_SPANS else (j, h))
            groups.setdefault(sig, []).append((j, h))
        for grp in groups.values():
            results = _combine_group(lists, grp, eps, sigma=sigma,
                                     bits=bits, caps=caps, k=k)
            for span, (codes, scores, ovf) in results.items():
                overflow[span] = ovf
                if span == (0, k):
                    cl_sel, cr_sel = codes
                    ovf_spans = jnp.stack(
                        [overflow[s].any() for s in _spans(k)])[None, :]
                    ovf_ghosts = functools.reduce(jnp.logical_or,
                                                  overflow.values())
                    return cl_sel, cr_sel, scores, ovf_spans, ovf_ghosts
                # per-span flags live in `overflow` only; descendants must
                # not leak into an ancestor's ovf_spans slot (caps double
                # per flagged span — resolve_deferred)
                lists[span] = (codes, scores, no_ovf)
    raise AssertionError("unreachable")  # pragma: no cover


@functools.lru_cache(maxsize=64)
def _sharded_pairs_fn(mesh, k: int, sigma: int, bits: int, caps_t: tuple):
    """shard_map of the whole-batch enumeration over the mesh's branch axis
    (cached per (mesh, caps) so cap adaptation reuses compilations).
    Enumeration has no cross-ghost arithmetic → bit-identical per shard."""
    from jax.sharding import PartitionSpec as PS

    def local(P_loc, prefix_loc, log_threshold):
        return _pairs_device.__wrapped__(
            P_loc, prefix_loc, log_threshold, k=k, sigma=sigma, bits=bits,
            caps_t=caps_t)

    from jax.sharding import NamedSharding
    # multi-host: replicate outputs so the host extraction can fetch them
    out_sh = NamedSharding(mesh, PS()) if jax.process_count() > 1 else None
    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(PS("branch"), PS("branch"), PS()),
        out_specs=PS("branch")), out_shardings=out_sh)


def _prepare_batch(P_all, prefix_all, mesh):
    """With a mesh, pad + shard the ghost axis. Returns
    (P_dev, prefix_dev, G0)."""
    G0 = P_all.shape[0]
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as PS
        from ..parallel.build_sharded import pad_ghosts
        P_all, prefix_all, _ = pad_ghosts(
            np.asarray(P_all, np.float32),
            np.asarray(prefix_all, np.float32), mesh.shape["branch"])
        sh = NamedSharding(mesh, PS("branch"))
        P_all = jax.device_put(P_all, sh)
        prefix_all = jax.device_put(prefix_all, sh)
    return P_all, prefix_all, G0


def enumerate_pairs_deferred(P_all, prefix_all, log_threshold, *, k: int,
                             sigma: int, bits: int, caps: Dict, mesh=None):
    """Dispatch one whole-batch enumeration WITHOUT reading its overflow
    flags — the host sync is deferred so successive chunks pipeline
    back-to-back on device. Returns an opaque pending handle for
    :func:`resolve_deferred`.
    """
    P_dev, pre_dev, G0 = _prepare_batch(P_all, prefix_all, mesh)
    if mesh is not None:
        out = _sharded_pairs_fn(
            mesh, k, sigma, bits, _caps_key(caps))(
                P_dev, pre_dev, jnp.float32(log_threshold))
    else:
        out = _pairs_device(
            P_dev, pre_dev, jnp.float32(log_threshold), k=k,
            sigma=sigma, bits=bits, caps_t=_caps_key(caps))
    return (G0, out)


def resolve_deferred(pend, *, k: int, sigma: int, cap: int, caps: Dict):
    """Settle a deferred enumeration: ONE small host transfer reads the
    per-span overflow vector; overflowing spans grow their caps and request
    a re-dispatch.

    Returns (done, result, caps): done=True with result =
    (cl, cr, scores, overflow[G] np.bool_) when the chunk is complete (the
    flags are set only at the cap ceiling); done=False with result=None when
    the caller must re-dispatch with the returned (grown) caps.
    """
    spans_order = _spans(k) if k > 1 else [(0, 1)]
    G0, (cl, cr, scores, ovf_spans, ovf_ghosts) = pend
    vec = np.asarray(ovf_spans).any(axis=0)
    flagged = [s for s, f in zip(spans_order, vec) if f]
    if not flagged:
        return True, (cl[:G0], cr[:G0], scores[:G0],
                      np.zeros((G0,), bool)), caps
    grew = False
    new_caps = dict(caps)
    for span in flagged:
        j, h = span
        natural = _natural_size(j, h, sigma, caps)
        cur = caps[span]
        if cur < min(cap, natural):
            new_caps[span] = min(cap, natural, cur * 2)
            grew = True
    if not grew:
        # ceiling reached: report which ghosts overflowed
        return True, (cl[:G0], cr[:G0], scores[:G0],
                      np.asarray(ovf_ghosts)[:G0]), caps
    return False, None, normalize_caps(new_caps, k, sigma, cap)


def enumerate_pairs_device(P_all, prefix_all, log_threshold, *, k: int,
                           sigma: int, bits: int, cap: int,
                           caps: Optional[Dict] = None, mesh=None):
    """Ghost-batched device enumeration with adaptive per-span capacities.

    Dispatches :func:`_pairs_device`, doubling any span whose capacity
    overflows (recompiles are cached per caps tuple) until the ``cap``
    ceiling. Returns (cl_sel, cr_sel [G, W, C] uint32,
    scores [G, W, C] f32, overflow [G] bool) — overflow is only set when
    the ceiling is reached. With ``mesh``, the batch is sharded over the
    "branch" axis (ghost rows padded with inert matrices and trimmed).
    """
    if caps is None:
        caps = default_caps(k, sigma, cap)
    caps = normalize_caps(caps, k, sigma, cap)
    while True:
        pend = enumerate_pairs_deferred(
            P_all, prefix_all, log_threshold, k=k, sigma=sigma, bits=bits,
            caps=caps, mesh=mesh)
        done, result, caps = resolve_deferred(pend, k=k, sigma=sigma,
                                              cap=cap, caps=caps)
        if done:
            return result


def _pack_host(cl: np.ndarray, cr: np.ndarray, *, k: int, bits: int
               ) -> np.ndarray:
    shift = np.uint64(bits * (k - k // 2))
    return ((np.asarray(cl, dtype=np.uint64) << shift)
            | np.asarray(cr, dtype=np.uint64))


def enumerate_sparse_many(P_all, prefix_all, log_threshold, *, k: int,
                          sigma: int, bits: int, cap: int = 4096,
                          caps: Optional[Dict] = None,
                          probe: bool = True, mesh=None,
                          window_block: int | None = None,
                          combine_budget_bytes: int = 4 << 30,
                          stats: Optional[Dict] = None):
    """Ghost-batched sparse enumeration (host-facing).

    P_all: [G, S, sigma], prefix_all: [G, S+1]. Returns
    (codes [G, W, C] uint64, scores [G, W, C] f32, overflow [G] bool).

    The device does everything in one dispatch per ghost chunk (chunk size
    bounded so working-set HBM stays within ``combine_budget_bytes``); the
    host only packs the returned uint32 pairs into uint64 keys.

    ``stats`` (optional dict) accumulates telemetry: "redispatches" (chunks
    re-run because a span capacity doubled — probe misses) and "final_caps"
    (the settled per-span capacities).
    """
    if bits * (k - k // 2) > 32:
        # mid-span codes are uint32 on device; the widest span is the
        # top's right child (⌈k/2⌉ symbols). AA k=13 would need 35 bits —
        # and 13·5 = 65 bits would not even fit the reference's own 64-bit
        # keys (seq.py caps AA at k=12 for the same reason). Guard here so
        # direct library callers fail loudly instead of silently
        # truncating codes (verified wrong vs the oracle at AA k=13).
        raise ValueError(
            f"k={k} at {bits} bits/symbol exceeds the 32-bit half-window "
            f"code budget (max k: {2 * (32 // bits)} for this alphabet)")
    P_all = np.asarray(P_all, dtype=np.float32)
    prefix_all = np.asarray(prefix_all, dtype=np.float32)
    G, S = P_all.shape[0], P_all.shape[1]
    W = S - k + 1
    if W <= 0 or G == 0:
        return (np.zeros((G, 0, 1), np.uint64),
                np.zeros((G, 0, 1), np.float32), np.zeros((G,), bool))
    if caps is None:
        caps = (probe_caps(P_all, prefix_all, log_threshold, k=k,
                           sigma=sigma, cap=cap)
                if probe else default_caps(k, sigma, cap))
    # working set per ghost: staircase outputs (3 x [W, top_cap] f32/i32) plus
    # per-span survivor lists — dominated by the top span
    top_cap = min(cap, max(list(caps.values()) + [128]))
    per_ghost = W * top_cap * 48
    ghost_chunk = max(1, min(G, combine_budget_bytes // max(1, per_ghost)))

    # dispatch EVERY chunk before settling any (enumerate_pairs_deferred):
    # the per-chunk overflow read is a device round-trip, and reading it
    # eagerly would stall the pipeline between chunks
    chunks = [(g0, min(G, g0 + ghost_chunk))
              for g0 in range(0, G, ghost_chunk)]
    pending = [(g0, g1, enumerate_pairs_deferred(
        P_all[g0:g1], prefix_all[g0:g1], np.float32(log_threshold), k=k,
        sigma=sigma, bits=bits, caps=caps, mesh=mesh))
        for (g0, g1) in chunks]

    out_c, out_s = [], []
    overflow = np.zeros((G,), bool)
    for g0, g1, pend in pending:
        while True:
            done, result, caps = resolve_deferred(pend, k=k, sigma=sigma,
                                                  cap=cap, caps=caps)
            if done:
                break
            if stats is not None:
                stats["redispatches"] = stats.get("redispatches", 0) + 1
            pend = enumerate_pairs_deferred(
                P_all[g0:g1], prefix_all[g0:g1], np.float32(log_threshold),
                k=k, sigma=sigma, bits=bits, caps=caps, mesh=mesh)
        cl, cr, scores, ovf = result
        out_c.append(_pack_host(cl, cr, k=k, bits=bits))
        out_s.append(np.asarray(scores, dtype=np.float32))
        overflow[g0:g1] = ovf
    if stats is not None:
        stats["final_caps"] = dict(caps)
    if len(out_c) > 1:
        # chunks may have adapted to different capacities: pad to the widest
        Cmax = max(c.shape[2] for c in out_c)
        out_c = [np.pad(c, ((0, 0), (0, 0), (0, Cmax - c.shape[2])))
                 for c in out_c]
        out_s = [np.pad(s, ((0, 0), (0, 0), (0, Cmax - s.shape[2])),
                        constant_values=NEG_INF) for s in out_s]
    return np.concatenate(out_c), np.concatenate(out_s), overflow


def enumerate_sparse(P, prefix, log_threshold, *, k: int, sigma: int,
                     bits: int, cap: int = 4096,
                     caps: Optional[Dict] = None,
                     window_block: int | None = None,
                     combine_budget_bytes: int = 1 << 28):
    """Full-window survivor lists for one ghost matrix.

    Returns (codes [W, C] uint64, scores [W, C] f32, overflow bool).
    """
    codes, scores, overflow = enumerate_sparse_many(
        np.asarray(P, dtype=np.float32)[None],
        np.asarray(prefix, dtype=np.float32)[None],
        log_threshold, k=k, sigma=sigma, bits=bits, cap=cap, caps=caps,
        window_block=window_block,
        combine_budget_bytes=combine_budget_bytes)
    return codes[0], scores[0], bool(overflow[0])


def merge_window_lists(codes: np.ndarray, scores: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side insert-or-max merge over windows (and ghosts, if their lists
    are concatenated along the window axis) — the hash-map ``put`` analog
    (``branch_group.cpp:88-102``) on compacted lists.

    codes/scores: [..., C] flattened; invalid slots (score -inf) are dropped.
    Returns (unique sorted codes, per-code max score).
    """
    codes = np.asarray(codes, dtype=np.uint64).ravel()
    scores = np.asarray(scores, dtype=np.float32).ravel()
    valid = np.isfinite(scores)
    codes, scores = codes[valid], scores[valid]
    if codes.size == 0:
        return codes, scores
    order = np.lexsort((-scores, codes))
    codes, scores = codes[order], scores[order]
    first = np.ones(len(codes), dtype=bool)
    first[1:] = codes[1:] != codes[:-1]
    # sorted by (code asc, score desc): the first row of each code group is
    # its maximum
    return codes[first], scores[first]
