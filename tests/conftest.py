"""Test configuration: CPU backend with a virtual 8-device mesh for sharding
tests, float64 available for numerical-accuracy oracles.

The platform is forced to CPU through the jax config API before any backend
is initialized, so the suite never takes an accelerator's memory.  Tests
that need a GPU carry the `gpu` marker and request the `gpu_device`
fixture, which skips them where there is no card.
"""
import os
import shutil
import subprocess

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """Skip unless `nvidia-smi` sees a card.  Decided when a test asks for
    it, never at import time (pytest-xdist workers must all collect the
    same tests), and without JAX: this process stays on the CPU, so a gpu
    test drives the card from one child process of its own."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("no GPU: nvidia-smi finds no card")
