"""What the program runs on: the JAX device and the card behind it."""

from __future__ import annotations

import subprocess


def device_info() -> dict:
    """{"platform", "kind", "count"} of the default JAX devices."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """device_info(), or RuntimeError when JAX's default devices are not
    GPUs: a measurement never falls back to the CPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default platform is {info['platform']!r}")
    return info


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for every card, one per
    line, or a note when nvidia-smi is missing or fails. Read by a child
    process that never touches JAX."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    if r.returncode != 0:
        return f"nvidia-smi failed (rc={r.returncode}): {r.stderr.strip()}"
    return r.stdout.strip()
