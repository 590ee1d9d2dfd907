"""Process set-up for runs on the accelerator.

- ``enable_compile_cache``: JAX's persistent compilation cache, at
  ``$JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads it itself) and
  otherwise at one fixed directory inside the checkout, so a later process
  on the same checkout finds what an earlier one compiled;
- ``require_gpu``: stop with a message unless JAX runs on a GPU — the
  measurement entry points never fall back to the CPU;
- ``card_info``: the card's name and power limit as ``nvidia-smi`` reports
  them, to print beside every measured number.
"""
from __future__ import annotations

import os
import subprocess

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def require_gpu(backend: str | None = None) -> None:
    """Raise SystemExit with a message unless the backend is ``gpu``."""
    backend = jax.default_backend() if backend is None else backend
    if backend != "gpu":
        raise SystemExit(
            f"this entry point measures the GPU, but JAX's backend is "
            f"{backend!r}; run it on a machine with an NVIDIA GPU")


def card_info() -> str:
    """``name, power.limit`` of the visible cards, one line per card."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return res.stdout.strip() or f"nvidia-smi failed: {res.stderr.strip()}"
