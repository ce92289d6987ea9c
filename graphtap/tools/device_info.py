"""Which device a measurement ran on.

Every benchmark record names its device: JAX's platform, device kind and
device count, plus the card's name and power limit as ``nvidia-smi``
reports them (a card set below its maximum power runs slower under load,
so a time means little without it). Measurement entry points call
``require_gpu`` first: a device path that finds no GPU fails instead of
falling back to the CPU.
"""

from __future__ import annotations

import subprocess
from typing import List

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


class NoGPUError(RuntimeError):
    pass


def require_gpu() -> None:
    """Raise NoGPUError unless JAX's default backend is a GPU."""
    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise NoGPUError(f"no GPU: JAX's default platform is {platform!r}")


def nvidia_smi() -> List[str]:
    """One ``<name>, <power limit>`` line per card."""
    out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                         timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def device_record() -> dict:
    """The device fields every benchmark JSON line carries."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform,
            "device_kind": devs[0].device_kind,
            "count": len(devs),
            "nvidia_smi": nvidia_smi()}
