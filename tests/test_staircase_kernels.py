"""The sparse path's staircase combine (``sparse._staircase_xla``) under test.

Two layers of evidence:

* direct: the staircase (XLA two-key sorts + rank-query extraction) against
  a brute-force numpy reference over the sorted views — values, slot order,
  totals, overflow;
* lookup: the rank query that maps each output slot to its (row, column)
  must be bit-equal to the membership-mask lookup it replaced
  (``staircase_ref.staircase_membership``), including windows whose total
  exceeds the capacity.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from ipk_tpu.core import sparse as sparse_mod
from staircase_ref import staircase_membership


def brute_force_sorted(sL, cL, sR, cR, eps, cap, sort_l=True):
    """Reference: two-key sort (score desc, unsigned code asc) — R always,
    L only with ``sort_l`` — emit surviving pairs row-major, pad with
    (-inf, 0)."""
    G, W, CL = sL.shape
    clu = np.zeros((G, W, cap), np.uint32)
    cru = np.zeros((G, W, cap), np.uint32)
    s_out = np.full((G, W, cap), -np.inf, np.float32)
    tot = np.zeros((G, W), np.int32)
    for g in range(G):
        for w in range(W):
            ol = (np.lexsort((cL[g, w], -sL[g, w])) if sort_l
                  else np.arange(CL))
            orr = np.lexsort((cR[g, w], -sR[g, w]))
            T = sL[g, w][ol][:, None] + sR[g, w][orr][None, :]
            ii, jj = np.nonzero(T > eps[g, w])
            n = len(ii)
            take = min(n, cap)
            tot[g, w] = n
            s_out[g, w, :take] = T[ii[:take], jj[:take]]
            clu[g, w, :take] = cL[g, w, ol][ii[:take]]
            cru[g, w, :take] = cR[g, w, orr][jj[:take]]
    return clu, cru, s_out, tot


def staircase(sL, cL, sR, cR, eps, *, cap, sort_l=True,
              impl=sparse_mod._staircase_xla):
    """The production route of ``_combine_group``: R sorted (L too with
    ``sort_l``) by the two-key order, then the staircase. Returns
    (cl, cr, scores, totals)."""
    cL, sL = jnp.asarray(cL), jnp.asarray(sL)
    cR, sR = sparse_mod._sort_desc(jnp.asarray(cR), jnp.asarray(sR))
    if sort_l:
        cL, sL = sparse_mod._sort_desc(cL, sL)
    (cl, cr), s, tot = impl(cL, sL, cR, sR, jnp.asarray(eps), cap=cap,
                            shift=None)
    return cl, cr, s, tot


def random_lists(rng, G, W, CL, CR):
    sL = rng.uniform(-6, 0, (G, W, CL)).astype(np.float32)
    sR = rng.uniform(-6, 0, (G, W, CR)).astype(np.float32)
    # duplicate some scores to exercise the code tiebreak
    sL[:, :, ::3] = np.round(sL[:, :, ::3], 1)
    sR[:, :, ::2] = np.round(sR[:, :, ::2], 1)
    cL = rng.permutation(CL * W * G).astype(np.uint32).reshape(G, W, CL)
    cR = rng.permutation(CR * W * G).astype(np.uint32).reshape(G, W, CR)
    return sL, cL, sR, cR


@pytest.mark.parametrize("sort_l", [True, False])
@pytest.mark.parametrize("G,W,CL,CR,cap", [
    (1, 5, 20, 33, 128),      # tiny, unaligned widths
    (2, 9, 130, 200, 256),    # multi-tile L, cap < survivors possible
    (1, 3, 300, 40, 384),     # wide L, narrow R
])
def test_wide_kernel_matches_brute_force(G, W, CL, CR, cap, sort_l):
    rng = np.random.default_rng(G * 100 + CL)
    sL, cL, sR, cR = random_lists(rng, G, W, CL, CR)
    eps = rng.uniform(-4.5, -4.0, (G, W)).astype(np.float32)
    got = staircase(sL, cL, sR, cR, eps, cap=cap, sort_l=sort_l)
    ref = brute_force_sorted(sL, cL, sR, cR, eps, cap, sort_l=sort_l)
    for name, a, b in zip(("cl", "cr", "scores", "totals"),
                          map(np.asarray, got), ref):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_wide_kernel_unsigned_code_order():
    """Codes with the sign bit set (DNA k=31 half-windows) must sort in
    UNSIGNED order — the biased compare of the two-key sort."""
    G, W, CL, CR, cap = 1, 2, 8, 8, 128
    rng = np.random.default_rng(0)
    sL = np.zeros((G, W, CL), np.float32)      # all-tied scores: order is
    sR = np.zeros((G, W, CR), np.float32)      # decided by the codes alone
    cL = (rng.permutation(CL).astype(np.uint32) * np.uint32(0x20000001)
          ).reshape(G, 1, CL).repeat(W, axis=1)
    cR = (rng.permutation(CR).astype(np.uint32) * np.uint32(0x30000001)
          ).reshape(G, 1, CR).repeat(W, axis=1)
    eps = np.full((G, W), -1.0, np.float32)
    got = staircase(sL, cL, sR, cR, eps, cap=cap)
    ref = brute_force_sorted(sL, cL, sR, cR, eps, min(cap, CL * CR))
    for name, a, b in zip(("cl", "cr", "scores", "totals"),
                          map(np.asarray, got), ref):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_wide_kernel_overflow_totals():
    """totals must report the TRUE survivor count even past cap."""
    G, W, CL, CR, cap = 1, 4, 40, 40, 128
    rng = np.random.default_rng(3)
    sL = rng.uniform(-1, 0, (G, W, CL)).astype(np.float32)
    sR = rng.uniform(-1, 0, (G, W, CR)).astype(np.float32)
    cL = np.arange(G * W * CL, dtype=np.uint32).reshape(G, W, CL)
    cR = np.arange(G * W * CR, dtype=np.uint32).reshape(G, W, CR)
    eps = np.full((G, W), -100.0, np.float32)   # everything survives
    _, _, s, tot = map(np.asarray, staircase(sL, cL, sR, cR, eps, cap=cap))
    assert (tot == CL * CR).all()
    assert np.isfinite(s).all()                  # cap slots all filled


@pytest.mark.parametrize("G,W,CL,CR,cap,eps_lo", [
    (1, 4, 20, 33, 128, -4.5),     # unaligned widths
    (2, 6, 130, 200, 256, -4.5),   # many empty rows, cap < survivors
    (1, 5, 300, 40, 384, -7.0),    # every window's total exceeds cap
    (1, 3, 64, 64, 4096, -3.0),    # cap above the product: C = CL·CR
])
def test_rank_query_matches_membership(G, W, CL, CR, cap, eps_lo):
    """The rank-query slot lookup is bit-equal to the membership-mask
    lookup it replaced: codes, scores, slot order and totals."""
    rng = np.random.default_rng(CL + CR + W)
    sL, cL, sR, cR = random_lists(rng, G, W, CL, CR)
    eps = rng.uniform(eps_lo, eps_lo + 0.5, (G, W)).astype(np.float32)
    got = staircase(sL, cL, sR, cR, eps, cap=cap)
    ref = staircase(sL, cL, sR, cR, eps, cap=cap,
                    impl=staircase_membership)
    if eps_lo <= -7.0:
        assert (np.asarray(got[3]) > cap).all()
    for name, a, b in zip(("cl", "cr", "scores", "totals"),
                          map(np.asarray, got), map(np.asarray, ref)):
        np.testing.assert_array_equal(a, b, err_msg=name)
