"""Process-level device setup shared by the entry points.

`enable_compile_cache` points JAX's persistent compilation cache at one
fixed place, `require_gpu` stops a measurement that would otherwise run on
the wrong device, and `card_info` names the card a number was taken on.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Use JAX's persistent compilation cache; return its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
    else is set here. Otherwise the cache goes to `<repo>/.jax_cache`, a
    fixed path (the path is part of the cache key, so a directory that
    moves between runs never hits). Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def require_gpu(what: str):
    """Return the first device if it is a GPU; otherwise exit with a
    message. Measurements never fall back to another device."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"{what} measures the GPU, but JAX's first device is "
            f"{dev.platform!r} ({dev.device_kind}); refusing to run")
    return dev


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them
    (`name, power.limit`, one line per card), or why they are missing."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    return out.stdout.strip() or out.stderr.strip()


def device_record() -> dict:
    """Platform, kind and count of the devices JAX reports."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
