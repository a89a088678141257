"""Backend dispatch, compile-cache placement and the chip check's device
gate — the plumbing that decides where the build runs."""

import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_choose_backend_is_jnp_on_cpu():
    """Off the GPU the dense combine is plain XLA, and nothing asks the
    Triton kernel for interpret mode: ``combine_max`` defaults to compiled
    and only tests pass ``interpret=True``."""
    import inspect
    from ipk_tpu.builder import choose_backend
    from ipk_tpu.core.pallas_kernels import combine_max
    assert choose_backend() == "jnp"
    sig = inspect.signature(combine_max.__wrapped__)
    assert sig.parameters["interpret"].default is False


_CACHE_PROBE = """\
import jax, jax.numpy as jnp, sys
from ipk_tpu.utils.cache import enable_compilation_cache
print(enable_compilation_cache())
print(jax.config.jax_compilation_cache_dir)
"""


def _probe_cache(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.split()
    return out


def test_compile_cache_honours_env(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the cache goes there and nowhere
    else."""
    want = str(tmp_path / "jc")
    used, configured = _probe_cache(want)
    assert used == want and configured == want


def test_compile_cache_default_in_checkout():
    """Unset: the cache lands at the fixed in-checkout path."""
    used, configured = _probe_cache(None)
    assert used == configured == os.path.join(REPO, ".jax_cache")


def test_chip_smoke_refuses_cpu():
    """The chip check's device gate fails on a CPU platform (no fallback
    that hides the device)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    import jax
    info = chip_smoke.device_info(jax.devices())
    assert info["platform"] == "cpu"
    with pytest.raises(chip_smoke.NotOnGPU, match="not a GPU"):
        chip_smoke.require_gpu(info)
