"""Kernels as compiled for the card (``pytest -m gpu`` on the machine with
the GPU; skipped elsewhere by the ``gpu`` fixture)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ipk_tpu.core import dense
from ipk_tpu.core.pallas_kernels import combine_max

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("k,sigma,G,S", [(8, 4, 16, 120), (4, 20, 4, 40)])
def test_triton_combine_bitequal_on_gpu(gpu, k, sigma, G, S):
    """The compiled Triton combine equals the plain XLA combine bit for bit
    (values and counts), including the padded σ=20 candidate axes."""
    rng = np.random.default_rng(k)
    p = rng.dirichlet(np.ones(sigma) * 0.4, size=(G, S)).astype(np.float32)
    P = np.log10(np.maximum(p, 1e-30)).astype(np.float32)
    prefix = dense.best_score_prefix(P)
    eps = np.float32(np.log10((1.5 / sigma) ** k))
    halves = jax.vmap(functools.partial(dense.masked_halves, k=k,
                                        sigma=sigma), in_axes=(0, 0, None))
    L, R = halves(jnp.asarray(P), jnp.asarray(prefix), eps)
    A, c = combine_max(L, R, eps, with_count=True)
    A_ref, c_ref = dense.combine_max_jnp(L, R, eps, with_count=True)
    np.testing.assert_array_equal(np.asarray(A), np.asarray(A_ref))
    np.testing.assert_array_equal(np.asarray(c), np.asarray(c_ref))
