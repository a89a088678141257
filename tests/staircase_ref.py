"""Reference for the staircase slot lookup: the membership-mask version.

Before the rank query, ``core.sparse._staircase_xla`` mapped each output slot
back to its (row, column) with membership masks over every slot x every row,
O(cap * CL) per window. It is kept here, verbatim, as an independent
reference: the tests require the rank query to be bit-equal to it, and
``chip_smoke.py`` times the two against each other on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ipk_tpu.core.dense import NEG_INF

#: fused-elementwise working-set budget of the count and mask chunks (elems
#: per chunk)
_CHUNK_ELEMS = 1 << 26


def staircase_membership(cL, sL, cR, sR, eps, *, cap: int, shift):
    """Staircase combine with the membership-mask slot lookup.

    With both lists sorted score-descending, the surviving j for each i form
    a PREFIX (f32 addition is monotone), so the survivor region is a monotone
    staircase fully described by per-i counts. Counts use the exact predicate
    ``fl(sL[i]+sR[j]) > eps`` via a fused compare-reduce; flat slot t maps
    back to its (i, j) with membership masks against the count cumsum and
    masked one-live-term sums (exact in f32 — exactly one live term per
    slot). Emission order is row-major (i asc, j asc).

    cL/sL: [G, W, CL] (any order), cR/sR: [G, W, CR] (sorted desc). Returns
    (codes, scores [G, W, C], counts [G, W]) with C = min(cap, CL·CR); with
    ``shift=None`` codes is the (cL_sel, cR_sel) pair.
    """
    G, W, CL = sL.shape
    CR = sR.shape[2]
    out_cap = min(cap, CL * CR)

    # exact per-i survivor counts (the staircase profile)
    cc = max(1, min(CL, _CHUNK_ELEMS // max(1, G * W * CR)))
    cnts = []
    for c0 in range(0, CL, cc):
        part = ((sL[:, :, c0:c0 + cc, None] + sR[:, :, None, :])
                > eps[:, :, None, None]).sum(axis=3, dtype=jnp.int32)
        cnts.append(part)
    cnt = jnp.concatenate(cnts, axis=2) if len(cnts) > 1 else cnts[0]
    offx = jnp.concatenate(
        [jnp.zeros((G, W, 1), jnp.int32),
         jnp.cumsum(cnt, axis=2, dtype=jnp.int32)], axis=2)  # [G, W, CL+1]
    total = offx[..., -1]

    jr = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 1, CR), 3)

    tc = max(1, min(out_cap,
                    _CHUNK_ELEMS // max(1, G * W * max(CL, CR))))
    out_cl, out_cr, out_s = [], [], []
    for t0 in range(0, out_cap, tc):
        t1 = min(out_cap, t0 + tc)
        ks = jnp.arange(t0, t1, dtype=jnp.int32)
        t = ks[None, None, :, None]                    # [1, 1, T, 1]
        # jj = t - offx[i] <= t < t1 for any L order (offx >= 0), so the
        # right-side membership can stop at t1 lanes; L is not assumed
        # sorted (only R's sortedness drives the staircase prefix)
        il = CL
        jl = min(CR, t1)
        # membership: slot t lies in left-row i iff offx[i] <= t < offx[i+1]
        A = offx[:, :, None, :il + 1] <= t             # [G, W, T, il+1]
        M = A[..., :-1] & ~A[..., 1:]

        def pick_l(f, dt, M=M, il=il):
            # one live term per slot: the masked sum is exact in any dtype
            return jnp.where(M, f[:, :, None, :il], 0).sum(axis=3, dtype=dt)

        prev = pick_l(offx[..., :-1], jnp.int32)
        jj = ks[None, None, :] - prev
        N = jj[:, :, :, None] == jr[..., :jl]          # [G, W, T, jl]

        def pick_r(f, dt, N=N, jl=jl):
            return jnp.where(N, f[:, :, None, :jl], 0).sum(axis=3, dtype=dt)

        s = pick_l(sL, jnp.float32) + pick_r(sR, jnp.float32)
        valid = (ks[None, None, :] < total[..., None]) & (s > eps[..., None])
        out_s.append(jnp.where(valid, s, NEG_INF))
        # dead slots carry code 0 (not the leaked cR[t] of an empty
        # membership mask)
        out_cl.append(jnp.where(valid, pick_l(cL, jnp.uint32), 0))
        out_cr.append(jnp.where(valid, pick_r(cR, jnp.uint32), 0))

    cat = (lambda xs: jnp.concatenate(xs, axis=2) if len(xs) > 1 else xs[0])
    clg, crg, s = cat(out_cl), cat(out_cr), cat(out_s)
    if shift is None:
        return (clg, crg), s, total
    return (clg << np.uint32(shift)) | crg, s, total
