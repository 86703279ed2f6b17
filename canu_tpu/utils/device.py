"""The card a run is measured on: its nvidia-smi name and power limit,
and a guard that refuses to measure anything without a GPU."""

from __future__ import annotations

import subprocess


def card_name() -> str:
    """The card as `nvidia-smi --query-gpu=name,power.limit` reports it
    (read in a subprocess, without touching JAX)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return r.stdout.strip() or f"nvidia-smi rc={r.returncode}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def require_gpu(tool: str):
    """The JAX devices, or SystemExit when the default backend is no GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"{tool}: no GPU (JAX default platform is "
            f"{devs[0].platform!r}); nothing is measured on a CPU")
    return devs
