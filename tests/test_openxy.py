"""Simultaneously open x AND y boundaries (modboundary.f90 supports any
BCxm/BCym combination; no shipped example uses both, so this is a synthetic
config test: profile inlets on x and y, convective outlets opposite)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from udales_jax.config import (BC_PROFILE, BCConfig, Config, DomainConfig,
                               RunConfig)
from udales_jax.grid import Grid
from udales_jax.ops.openbc import BC_PROFILE as _BCP, Inlet
from udales_jax.run import Model
from udales_jax.state import initial_state, profile_fields, randomize


def _build(n=16):
    cfg = Config(
        domain=DomainConfig(n, n, n, float(n), float(n)),
        run=RunConfig(ladaptive=True, dtmax=0.1),
        bc=BCConfig(BCxm=BC_PROFILE, BCym=BC_PROFILE, BCxT=BC_PROFILE,
                    BCyT=BC_PROFILE, thls=288.0),
        dtype="float64",
    )
    grid = Grid.uniform(n, n, n, float(n), float(n), float(n),
                        dtype=np.float64)
    model = Model(cfg, grid)
    nz = n
    j = lambda a: jnp.asarray(a, jnp.float64)
    uprof = j(np.full(nz, 1.0))
    vprof = j(np.full(nz, 0.4))
    inl = Inlet(mode=_BCP, uprof=uprof, vprof=vprof,
                thlprof=j(np.full(nz, 290.0)), qtprof=j(np.zeros(nz)),
                e12prof=j(np.full(nz, 1e-3)),
                svprof=jnp.zeros((0, nz), jnp.float64))
    model.inlet = inl
    model.inlet_y = inl
    f = profile_fields(grid, np.full(nz, 1.0), np.full(nz, 0.4),
                       np.full(nz, 290.0), np.zeros(nz),
                       np.full(nz, 1e-3))
    f = randomize(f, jax.random.PRNGKey(3), 0.02, nz)
    from udales_jax.ops.openbc import init_xplanes, init_yplanes
    f = dataclasses.replace(f, bx=init_xplanes(f, grid),
                            by=init_yplanes(f, grid))
    return model, initial_state(grid, f, dt0=0.02)


def test_open_xy_steps_stable():
    model, state = _build()
    step = jax.jit(model.step)
    for _ in range(6):
        state = step(state)
    for name in ("u", "v", "w", "thl", "e12"):
        arr = np.asarray(getattr(state.c, name))
        assert np.isfinite(arr).all(), name
    assert np.abs(np.asarray(state.c.u)).max() < 5.0
    # both inlet faces pinned to their profiles
    u_in = np.asarray(state.c.u[0])
    np.testing.assert_allclose(u_in, 1.0, atol=1e-10)
    v_in = np.asarray(state.c.v[:, 0])
    np.testing.assert_allclose(v_in, 0.4, atol=1e-10)


def test_open_xy_divergence_free():
    """The dual-Neumann (DCT x DCT) Poisson solve must still project to a
    divergence-free field, with the open-face velocities in the balance."""
    model, state = _build()
    step = jax.jit(model.step)
    for _ in range(4):
        state = step(state)
    c = state.c
    grid = model.grid
    n = grid.itot
    u_faces = np.concatenate([np.asarray(c.u),
                              np.asarray(c.bx.u)[None]], axis=0)
    v_faces = np.concatenate([np.asarray(c.v),
                              np.asarray(c.by.v)[:, None]], axis=1)
    dzfi = np.asarray(grid.j("dzfi"))
    div = ((u_faces[1:] - u_faces[:-1]) * grid.dxi
           + (v_faces[:, 1:] - v_faces[:, :-1]) * grid.dyi
           + (np.asarray(c.w)[:, :, 1:] - np.asarray(c.w)[:, :, :-1])
           * dzfi[None, None, :])
    # interior exactly divergence-free; the singular-mode compatibility
    # residual lands in the top level, as in the single-open-x case
    # (test_openbc.py:73-74 uses the same split tolerance)
    assert np.abs(div[:, :, :-1]).max() < 1e-10
    assert np.abs(div[:, :, -1]).max() < 1e-2


def test_open_xy_ghost_corners():
    """Ghost assembly: the x planes attach first, the y planes fill the
    corners (the reference's xm-then-ym ordering)."""
    from udales_jax.ops.boundary import _assemble_xy
    nx = ny = 4
    gk = jnp.zeros((nx, ny, 3))
    xlo = jnp.full((ny, 3), 1.0)
    xhi = jnp.full((ny, 3), 2.0)
    ylo = jnp.full((nx, 3), 3.0)
    yhi = jnp.full((nx, 3), 4.0)
    g = _assemble_xy(gk, 1, xlo, xhi, ylo, yhi)
    assert g.shape == (nx + 2, ny + 2, 3)
    assert float(g[0, 2, 0]) == 1.0 and float(g[-1, 2, 0]) == 2.0
    assert float(g[2, 0, 0]) == 3.0 and float(g[2, -1, 0]) == 4.0
    # corners come from the y pass
    assert float(g[0, 0, 0]) == 3.0 and float(g[-1, -1, 0]) == 4.0
