"""Which accelerator a measurement ran on.

Measurement scripts name the device with every number: JAX's platform,
device kind and device count, and the card's name and power limit as
nvidia-smi reports them (a card set below its maximum power runs slower
under load).  A measurement path that finds no GPU fails; it never falls
back to the CPU.
"""

from __future__ import annotations

import subprocess
from typing import Dict


def require_gpu() -> Dict[str, object]:
    """{"platform", "kind", "count"} of jax.devices(); exits non-zero when
    JAX's default backend is not a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default backend is "
                         f"{devs[0].platform!r}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_info() -> str:
    """`name, power.limit` of every card, one line each, from an nvidia-smi
    child process (which stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
