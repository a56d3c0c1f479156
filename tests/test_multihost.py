"""Two-process jax.distributed smoke for parallel/multihost.py.

Spawns two REAL processes (each with 2 virtual CPU devices), forms the
4-device global mesh through init_distributed + global_mesh, shards a
State across both processes, runs one full RK3 step, and asserts each
process's addressable shards match the single-process unsharded result —
the multi-rank execution test the reference runs with MPI (SURVEY §4)."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

WORKER = r"""
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"
sys.path.insert(0, r"{repo}")
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
from udales_jax.parallel.multihost import (init_distributed, global_mesh,
                                           shard_state_global)

idx, cnt = init_distributed(f"localhost:{{port}}", 2, pid)
assert cnt == 2, cnt
assert len(jax.devices()) == 4, jax.devices()
mesh = global_mesh()
assert mesh.devices.shape == (2, 2), mesh.devices.shape

from udales_jax.cases import flat_model, flat_state
model = flat_model(16, 16, 16, dtype="float64", ladaptive=False)
state = flat_state(model)                        # identical on both ranks
ref = jax.jit(model.step)(state)                 # single-device oracle

model.mesh = mesh
model.pois.mesh = mesh
gstate = shard_state_global(state, mesh)
out = jax.jit(model.step)(gstate)

for name in ("u", "v", "w", "thl"):
    garr = getattr(out.c, name)
    rarr = np.asarray(getattr(ref.c, name))
    for shard in garr.addressable_shards:
        err = np.abs(np.asarray(shard.data) - rarr[shard.index]).max()
        assert err < 1e-9, (name, shard.index, err)
print(f"MULTIHOST_OK rank={{pid}} shards_checked")
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER.format(repo=str(REPO)))
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen([sys.executable, str(worker), str(pid),
                               str(port)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {pid} failed:\n{out[-4000:]}"
        assert "MULTIHOST_OK" in out, out[-2000:]
