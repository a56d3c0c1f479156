"""Device-mesh sharding for the 2-D pencil decomposition.

The reference decomposes the domain with a 2-D MPI process grid
(nprocx x nprocy z-pencils, 2DECOMP; SURVEY.md section 2.3).  The JAX
equivalent is one `jax.sharding.Mesh` with axes ('x', 'y') and every field
sharded P('x', 'y', None): halo exchange and the Poisson transposes become
XLA collectives inserted by the GSPMD partitioner (the wrap-pads in
ops/halo.py become collective-permutes; FFT axis reshards become
all-to-alls).
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(nprocx: int, nprocy: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = nprocx * nprocy
    assert len(devices) >= n, f"need {n} devices, have {len(devices)}"
    devs = np.asarray(devices[:n]).reshape(nprocx, nprocy)
    return Mesh(devs, axis_names=("x", "y"))


def field_spec(ndim: int, leading_batch: bool = False) -> P:
    """PartitionSpec for a field array: (nx, ny, ...) -> P('x','y',None...);
    scalar arrays stay replicated."""
    if ndim >= 3 and leading_batch:
        return P(None, "x", "y", *([None] * (ndim - 3)))
    if ndim >= 2:
        return P("x", "y", *([None] * (ndim - 2)))
    return P()


def _path_names(path):
    out = []
    for p in path:
        n = getattr(p, "name", None)
        if n is None:
            n = getattr(p, "key", None)
        if n is not None:
            out.append(str(n))
    return out


def _leaf_spec(path, leaf) -> P:
    """PartitionSpec for one State leaf, aware of the special sub-pytrees:
    facet state (replicated), open-boundary planes (sharded along their one
    lateral axis), and the IBM dense parameter stacks (leading slot axis)."""
    nd = getattr(leaf, "ndim", 0)
    names = _path_names(path)
    if "bx" in names:   # XPlanes: (ny, nz[+1]) / sv (nsv, ny, nz)
        if nd == 3:
            return P(None, "y", None)
        if nd == 2:
            return P("y", None)
        return P()
    if "by" in names:   # YPlanes: (nx, nz[+1]) / sv (nsv, nx, nz)
        if nd == 3:
            return P(None, "x", None)
        if nd == 2:
            return P("x", None)
        return P()
    if "drv" in names:   # DriverWindow: rolling (W, ny, nz[+1]) planes
        if nd == 3:      # shard the inlet plane along y, never the record
            return P(None, "y", None)   # axis (W = chunkread_size)
        if nd == 4:      # sv: (W, nsv, ny, nz)
            return P(None, None, "y", None)
        return P()       # t: (W,) replicated
    if "fac" in names and "dense" not in names:
        return P()      # per-facet arrays: replicate
    if "ctl" in names:
        return P()
    if "ig" in names:   # InletGen: y-z planes shard along y, Utav along x,
        last = names[-1] if names else ""
        if last in ("u0", "v0", "w0", "t0"):
            return P("y", None)
        if last == "Utav":
            return P("x", None)
        return P()      # profiles/scalars replicate
    if nd == 4 and ("dense" in names or "surf" in names):
        # IBM dense wall-fn stacks (and the surface-temperature stacks
        # split off them) are z-major slabs (K, kz, ny, nx) — see
        # ibm/ibm.py _build_dense
        return P(None, None, "y", "x")
    if nd == 4:          # sv (nsv, nx, ny, nz)
        return field_spec(4, leading_batch=True)
    if nd >= 2 and "ibmp" not in names and "fac" not in names:
        return field_spec(nd)
    return P()


def shard_state(state, mesh: Mesh):
    """device_put the full State pytree with the pencil sharding."""
    def put(path, leaf):
        if leaf is None:
            return None
        return jax.device_put(leaf, NamedSharding(mesh, _leaf_spec(path,
                                                                   leaf)))
    return jax.tree_util.tree_map_with_path(put, state)


def state_shardings(state, mesh: Mesh):
    """Matching NamedSharding pytree (for jit in_shardings/out_shardings)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, _leaf_spec(path, leaf)),
        state)
