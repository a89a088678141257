"""Pallas (Triton route) kernel for the dense enumeration hot path.

The enumeration factorizes (see ``dense.masked_halves``) into cheap masked
half-window tensors L[W, nl], R[W, nr] plus one expensive combine:

    A = max over windows w of  where(L[w] ⊕ R[w] > eps, L[w] ⊕ R[w], -inf)

where ⊕ is the broadcasted outer sum ([nl, 1] + [1, nr]). The XLA version
(``dense.combine_max_jnp``) folds blocks of windows into an accumulator that
lives in device memory, so every block reads and writes the whole
[G, nl, nr] tensor. This kernel gives each program one [BI, BJ] tile of one
ghost's accumulator and loops over ALL windows in registers: per window it
loads one BI-wide row of L and one BJ-wide row of R, and folds the outer sum
into a running max and an int32 survivor count. Device memory traffic is L
and R once per tile row/column and A once. The op has no matmul structure
(an outer *sum*), so it runs on the CUDA cores: 4 ops per candidate and
window (add, max, compare, count).

Masking commutes with the max (x -> x if x > eps else -inf is monotone), so
the kernel masks once, at the end. Max and a single f32 add are exact, so the
result is bit-equal to ``combine_max_jnp`` in any window order; the per-ghost
count comes out as per-program partials [G, nI, nJ] summed by XLA (exact,
deterministic, no atomics).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .dense import NEG_INF

__all__ = ["combine_max"]


def _combine_kernel(eps_ref, L_ref, R_ref, A_ref, *cnt_ref, num_windows: int):
    """One program = one [BI, BJ] accumulator tile of one ghost.

    L_ref: [W, BI], R_ref: [W, BJ] (this program's columns of every window),
    A_ref: [BI, BJ]; cnt_ref (optional): this program's survivor count."""
    eps = eps_ref[0]
    bi, bj = A_ref.shape

    def body(w, carry):
        acc, cnt = carry
        t = L_ref[w, :][:, None] + R_ref[w, :][None, :]
        acc = jnp.maximum(acc, t)
        if cnt_ref:
            cnt = cnt + (t > eps).astype(jnp.int32)
        return acc, cnt

    acc0 = jnp.full((bi, bj), NEG_INF, jnp.float32)
    cnt0 = jnp.zeros((bi, bj) if cnt_ref else (), jnp.int32)
    acc, cnt = jax.lax.fori_loop(0, num_windows, body, (acc0, cnt0))
    A_ref[...] = jnp.where(acc > eps, acc, NEG_INF)
    if cnt_ref:
        cnt_ref[0][...] = jnp.sum(cnt)


def _pad_axis(x, axis: int, multiple: int):
    n = x.shape[axis]
    pad = -n % multiple
    if not pad:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths, constant_values=NEG_INF)


@functools.partial(jax.jit,
                   static_argnames=("block_i", "block_j", "with_count",
                                    "interpret"))
def combine_max(L: jnp.ndarray, R: jnp.ndarray, log_threshold, *,
                block_i: int = 16, block_j: int = 128,
                with_count: bool = False, interpret: bool = False):
    """A[g] = max_w mask(L[g, w] ⊕ R[g, w]) for all ghosts.

    Same contract as ``dense.combine_max_jnp``: L [G, W, nl], R [G, W, nr]
    f32 (from ``masked_halves``, -inf = pruned) → A [G, nl, nr] (+ per-ghost
    int32 surviving-tuple counts when ``with_count``). ``block_i`` and
    ``block_j`` (powers of two) are the accumulator tile each program keeps
    in registers; candidate axes that are not a multiple of them are padded
    with inert -inf columns and sliced away; tests shrink them to force
    padded and multi-tile grids. The defaults, with 4 warps and 1 stage,
    are within 3% of the fastest of 20 tile/warp settings on an H100 (80GB
    HBM3, 700 W) at the dna_k8 and k=10 key-batch shapes. ``interpret``
    runs the kernel in the Pallas interpreter (CPU tests); it is never
    inferred.
    """
    G, W, nl = L.shape
    nr = R.shape[2]
    for b in (block_i, block_j):
        if b & (b - 1):
            raise ValueError(f"combine_max: tile size {b} is not a power of 2")
    Lp = _pad_axis(L, 2, block_i)
    Rp = _pad_axis(R, 2, block_j)
    nI = Lp.shape[2] // block_i
    nJ = Rp.shape[2] // block_j
    eps = jnp.asarray(log_threshold, dtype=jnp.float32).reshape(1)

    out_shape = [jax.ShapeDtypeStruct((G, nI * block_i, nJ * block_j),
                                      jnp.float32)]
    out_specs = [pl.BlockSpec((None, block_i, block_j),
                              lambda g, i, j: (g, i, j))]
    if with_count:
        out_shape.append(jax.ShapeDtypeStruct((G, nI, nJ), jnp.int32))
        out_specs.append(pl.BlockSpec((None, None, None),
                                      lambda g, i, j: (g, i, j)))
    out = pl.pallas_call(
        functools.partial(_combine_kernel, num_windows=W),
        grid=(G, nI, nJ),
        in_specs=[
            pl.BlockSpec((1,), lambda g, i, j: (0,)),
            pl.BlockSpec((None, W, block_i), lambda g, i, j: (g, 0, i)),
            pl.BlockSpec((None, W, block_j), lambda g, i, j: (g, 0, j)),
        ],
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="ipk_combine_max",
    )(eps, Lp, Rp)
    A = out[0][:, :nl, :nr]
    if with_count:
        return A, out[1].sum(axis=(1, 2), dtype=jnp.int32)
    return A
