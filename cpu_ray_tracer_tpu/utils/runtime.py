"""Process set-up shared by the entry points: the persistent compilation
cache, the GPU requirement of the measuring scripts, and the card
description printed beside every number they report."""

from __future__ import annotations

import os
import subprocess
import sys

import jax

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Keep JAX's persistent compilation cache in JAX_COMPILATION_CACHE_DIR
    when that is set, and otherwise in the fixed directory <repo>/.jax_cache
    (created if missing; the path is part of the cache key, so it must not
    move).  Returns the directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(REPO, ".jax_cache")
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_description() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the cards, read by a
    child process that stays off JAX; a note when nvidia-smi is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def require_gpu() -> dict:
    """The device record every measurement is printed with
    ({platform, kind, count}); exits with status 2 when JAX's first device
    is not a GPU, because a CPU number must never stand in for one."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(
            f"this script measures the GPU; JAX's first device is {dev.platform} "
            f"({dev.device_kind})",
            file=sys.stderr,
        )
        raise SystemExit(2)
    return {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}
