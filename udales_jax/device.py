"""The device a run measures on: the GPU check, the card's description,
and JAX's persistent compile cache."""
from __future__ import annotations

import os
import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache and return its directory.  A
    set JAX_COMPILATION_CACHE_DIR is read by JAX itself; only when it is
    unset does this point JAX at `<repo>/.jax_cache` — a fixed path, since
    the path is part of what a later run must find."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        import jax
        path = str(REPO / ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """JAX's devices, when they are GPUs.  A measurement never falls back
    to the CPU, so any other platform raises."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX found {len(devs)} "
                           f"{devs[0].platform} device(s)")
    return devs


def describe(devs) -> dict:
    """The device as JAX reports it."""
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_and_power_limit() -> str:
    """`nvidia-smi`'s name and power limit of each card, one per line.
    The card may be set below its maximum power, which slows it under
    load, so every number taken on it is reported beside this."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
