"""The accelerator a measurement ran on.

Every number a benchmark prints names its device. A measurement that finds
no GPU fails instead of timing the CPU.
"""

from __future__ import annotations

import subprocess


def require_gpu():
    """jax.devices() when the default backend is a GPU; raises otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default devices are {devs} (a measurement "
            f"never falls back to the CPU)")
    return devs


def device_record() -> dict:
    """{"platform", "kind", "count"} of JAX's default devices."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_and_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for every card, one line
    each (a card set below its maximum power runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
