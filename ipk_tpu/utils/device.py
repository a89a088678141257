"""Which device a measurement runs on, and the refusal to measure elsewhere.

Every timing this repository prints names its device (platform,
``device_kind``, count, and the card's name and power limit as
``nvidia-smi`` reports them: a power-capped card runs slower under load).
A measurement that finds no GPU fails; it does not fall back to the CPU.
"""

from __future__ import annotations

import subprocess

__all__ = ["NotOnGPU", "device_info", "require_gpu", "nvidia_smi"]


class NotOnGPU(RuntimeError):
    """The default JAX platform is not a GPU."""


def device_info(devices=None) -> dict:
    """{"platform", "kind", "count"} of ``devices`` (default: JAX's)."""
    if devices is None:
        import jax
        devices = jax.devices()
    d = devices[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def require_gpu(info: dict) -> None:
    if info["platform"] != "gpu":
        raise NotOnGPU(f"platform {info['platform']!r} is not a GPU")


def nvidia_smi() -> str:
    """``name, power.limit`` of each visible card, as nvidia-smi prints
    them (or why it could not be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip() or out.stderr.strip()
