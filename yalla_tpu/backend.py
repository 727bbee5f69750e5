"""The one place that decides what the program runs on.

Engines, models and the measurement scripts ask this module instead of
testing ``jax.default_backend()`` themselves:

* :func:`on_gpu` -- whether JAX's default backend is a GPU.  The default
  engines use the cube-sorted sweep kernel (``ops/sweep_triton.py``),
  which compiles only for an NVIDIA GPU, exactly when it is; elsewhere
  they take their plain XLA paths.  A kernel never drops to interpret
  mode by itself: interpret mode is something a caller (a test) asks for
  explicitly.
* :func:`require_gpu` -- measurement scripts refuse to run, rather than
  fall back to the CPU, when JAX finds no GPU.
* :func:`device_info` / :func:`card_line` -- the device a result was
  measured on, as JAX reports it and as ``nvidia-smi`` reports it.
"""
from __future__ import annotations

import subprocess

import jax

__all__ = ["platform", "on_gpu", "require_gpu", "device_info",
           "card_line"]


def platform() -> str:
    """JAX's default backend: ``"gpu"``, ``"cpu"``, ..."""
    return jax.default_backend()


def on_gpu() -> bool:
    return platform() == "gpu"


def require_gpu() -> None:
    """Raise ``RuntimeError`` unless JAX's default backend is a GPU."""
    if not on_gpu():
        raise RuntimeError(
            f"no GPU: JAX's default backend is {platform()!r} "
            f"(devices: {jax.devices()})")


def device_info() -> dict:
    """``{"platform", "kind", "count"}`` of the default devices."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_line() -> str:
    """``name, power.limit`` of the first card as ``nvidia-smi`` prints
    them (one line per card, joined by ``"; "``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())
