#!/usr/bin/env python3
"""Sharding-overhead measurement for the collective build step (BASELINE
target row 4, the half measurable in this environment).

This measures the partitioning itself, apart from any card: the
production ``shard_map`` + ``psum`` program runs on a virtual N-device CPU
mesh (``xla_force_host_platform_device_count``). All virtual devices share
the same fixed host cores, so at fixed total work the IDEAL wall time is
FLAT across mesh sizes — any growth is pure partitioning + collective
overhead. That, plus bit-equal enumeration at every mesh size, is what
this records (``sharding_overhead_virtual_mesh`` in results.json); per-card
throughput lives in the single-card rows, and the sharded build on real
cards is checked by ``chip_smoke.py --multi``.
"""

import json
import os
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

from ipk_tpu.core import dense                                   # noqa: E402
from ipk_tpu.core.filter import score_threshold                  # noqa: E402
from ipk_tpu.parallel.mesh import make_mesh                      # noqa: E402
from ipk_tpu.parallel.build_sharded import (pad_ghosts,          # noqa: E402
                                            sharded_build_step)


def main():
    assert jax.device_count() >= 8, jax.devices()
    rng = np.random.default_rng(11)
    omega, k, sigma = 1.5, 7, 4
    G, S = 256, 120
    p = rng.dirichlet(np.ones(sigma) * 0.4, size=(G, S)).astype(np.float32)
    P = np.log10(np.maximum(p, 1e-30)).astype(np.float32)
    prefix = dense.best_score_prefix(P)
    eps = np.float32(np.log10((omega / sigma) ** k))
    thr = score_threshold(omega, sigma, k)

    rows = {}
    ref_fv = None
    ref_t = None
    for n in (1, 2, 4, 8):
        mesh = make_mesh(n_branch=n, n_key=1, devices=jax.devices()[:n])
        step = sharded_build_step(mesh, k=k, sigma=sigma, ghosts_per_group=2,
                                  total_num_groups=G // 2 + 1, threshold=thr)
        P_pad, pre_pad, _ = pad_ghosts(P, prefix, n * 2)
        A, fv, counts = step(P_pad, pre_pad, eps)
        fv = np.asarray(fv)
        A_host = np.asarray(A)[:G // 2]
        best = 1e18
        for _ in range(3):
            t0 = time.monotonic()
            A, fv_d, counts = step(P_pad, pre_pad, eps)
            np.asarray(fv_d)
            best = min(best, time.monotonic() - t0)
        if ref_fv is None:
            ref_fv, ref_A, ref_t = fv, A_host, best
        else:
            # enumeration is bit-equal at any mesh size; the f32 collective
            # filter reduces in mesh-dependent order (host f64 remains the
            # canonical DB ordering — docs/distributed.md)
            assert np.array_equal(A_host, ref_A), "A drifted with mesh size"
            np.testing.assert_allclose(fv, ref_fv, rtol=2e-5, atol=1e-6)
        rows[str(n)] = {"seconds": best,
                        "overhead_vs_1dev": best / ref_t - 1.0}
        print(f"n={n}: {best*1e3:8.1f} ms  overhead vs 1-dev "
              f"{(best/ref_t-1)*100:+5.1f}%", flush=True)

    out = os.path.join(REPO, "benchmarks", "results.json")
    results = json.load(open(out)) if os.path.exists(out) else {}
    results["sharding_overhead_virtual_mesh"] = {
        "devices": rows,
        "workload": f"dense k={k} G={G} S={S}, fixed total work",
        "enumeration_byte_equal_across_mesh_sizes": True,
        "note": ("virtual CPU mesh: all devices share the same host cores, "
                 "so flat time across mesh sizes is IDEAL and any growth is "
                 "partitioning+collective overhead; the sharded build on "
                 "real cards is checked by chip_smoke.py --multi")}
    json.dump(results, open(out, "w"), indent=1)


if __name__ == "__main__":
    main()
