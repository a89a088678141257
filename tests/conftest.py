"""Test configuration: CPU by default, with an 8-device virtual mesh.

Multi-device sharding is validated on a simulated mesh
(``xla_force_host_platform_device_count``) so the suite needs no accelerator.
Pallas kernels are exercised with ``interpret=True``, passed by each test.

Tests marked ``gpu`` need the card: the ``gpu`` fixture skips them when JAX's
default backend is not a GPU. On the machine with the card, run them with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/` on the card")
    return jax.devices()[0]
