"""Quantitative physics validation: Taylor-Green vortex against the exact
Navier-Stokes solution, through the FULL solver (RK3 + advection + DNS
diffusion + pressure projection + real boundary conditions).

Exact solution (2-D TGV, z-invariant, molecular viscosity nu):
    u(x,y,t) =  U0 cos(kx) sin(ky) exp(-2 nu k^2 t)
    v(x,y,t) = -U0 sin(kx) cos(ky) exp(-2 nu k^2 t)
The nonlinear terms are irrotational and absorbed exactly by pressure, so
the shape persists and kinetic energy decays as exp(-4 nu k^2 t).

The framework (like the reference, modboundary.f90:434-465) always applies a
molecular no-slip floor, so the bottom of the domain develops a thin Stokes
layer.  The domain is made tall (zsize >> 1/k and >> sqrt(4 nu t)) and the
comparison restricted to the top half, where both the diffusive contamination
(depth sqrt(4 nu t) ~ 1 cm << 20 cm) and the pressure-mode contamination
(~exp(-k z) ~ 3e-6) are negligible.

Measured here, with hard assertions:
  - pointwise solution error converging at 2nd order in dx,
  - the KE decay rate within 2% of 4 nu k^2 (and the discrete-Laplacian
    prediction explains the residual),
  - z-invariance preserved (|w| stays at solver-roundoff scale aloft),
  - temporal self-convergence of the Wicker-Skamarock RK3 at >= 2nd order.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest

from udales_jax.config import (BCConfig, Config, DomainConfig, PhysicsConfig,
                               RunConfig, SubgridConfig, WallsConfig, SGS_DNS,
                               const)
from udales_jax.grid import Grid
from udales_jax.run import Model
from udales_jax.state import initial_state, zero_fields

U0 = 0.01
LXY = 0.1
ZSIZE = 0.4
NZ = 16
K = 2 * math.pi / LXY
NU = const.numol


def _tgv_model(n, dtmax):
    dom = DomainConfig(itot=n, jtot=n, ktot=NZ, xlen=LXY, ylen=LXY)
    cfg = Config(domain=dom, dtype="float64",
                 run=RunConfig(ladaptive=False, dtmax=dtmax,
                               lrandomize=False),
                 subgrid=SubgridConfig(model=SGS_DNS),
                 walls=WallsConfig(lbottom=False),
                 physics=PhysicsConfig(lbuoyancy=False, ltempeq=False,
                                       lmoist=False))
    grid = Grid.uniform(n, n, NZ, LXY, LXY, ZSIZE, dtype=np.float64)
    return Model(cfg, grid), grid


def _tgv_state(model, grid, dt0):
    nx, ny, nz = grid.shape
    xu = (np.arange(nx) * grid.dx)[:, None, None]
    yc = ((np.arange(ny) + 0.5) * grid.dy)[None, :, None]
    xc = ((np.arange(nx) + 0.5) * grid.dx)[:, None, None]
    yv = (np.arange(ny) * grid.dy)[None, :, None]
    u = U0 * np.cos(K * xu) * np.sin(K * yc) * np.ones((1, 1, nz))
    v = -U0 * np.sin(K * xc) * np.cos(K * yv) * np.ones((1, 1, nz))
    f = zero_fields(grid)
    f = dataclasses.replace(f, u=jnp.asarray(u), v=jnp.asarray(v),
                            thl=jnp.full((nx, ny, nz), 288.0, jnp.float64))
    return initial_state(grid, f, dt0=dt0)


def _exact_uv(grid, t):
    nx, ny, nz = grid.shape
    xu = (np.arange(nx) * grid.dx)[:, None, None]
    yc = ((np.arange(ny) + 0.5) * grid.dy)[None, :, None]
    xc = ((np.arange(nx) + 0.5) * grid.dx)[:, None, None]
    yv = (np.arange(ny) * grid.dy)[None, :, None]
    decay = math.exp(-2 * NU * K * K * t)
    u = U0 * np.cos(K * xu) * np.sin(K * yc) * decay * np.ones((1, 1, nz))
    v = -U0 * np.sin(K * xc) * np.cos(K * yv) * decay * np.ones((1, 1, nz))
    return u, v


def _run(n, dt, nsteps):
    model, grid = _tgv_model(n, dt)
    state = _tgv_state(model, grid, dt)
    state = model.run(state, nsteps)
    return model, grid, state


class TestTaylorGreen:
    def _upper_err(self, n, dt, nsteps):
        model, grid, state = _run(n, dt, nsteps)
        t = float(state.timee)
        ue, ve = _exact_uv(grid, t)
        ktop = NZ // 2
        u = np.asarray(state.c.u)[:, :, ktop:]
        v = np.asarray(state.c.v)[:, :, ktop:]
        num = np.sqrt(np.mean((u - ue[:, :, ktop:]) ** 2
                              + (v - ve[:, :, ktop:]) ** 2))
        den = np.sqrt(np.mean(ue[:, :, ktop:] ** 2 + ve[:, :, ktop:] ** 2))
        return num / den, state, grid

    def test_decay_and_spatial_order(self):
        # t_final = 2 s: decay factor exp(-0.237) per component
        errs = []
        states = {}
        for n in (16, 32):
            e, state, grid = self._upper_err(n, 0.01, 200)
            errs.append(e)
            states[n] = (state, grid)
        order = math.log2(errs[0] / errs[1])
        # 2nd-order spatial convergence of the full step
        assert 1.7 < order < 2.4, (errs, order)
        assert errs[1] < 5e-3, errs   # N=32 solution within 0.5%

        # KE decay rate in the top half vs 4 nu k^2
        state, grid = states[32]
        t = float(state.timee)
        ktop = NZ // 2
        u = np.asarray(state.c.u)[:, :, ktop:]
        v = np.asarray(state.c.v)[:, :, ktop:]
        ke = np.mean(u ** 2 + v ** 2)
        ke0 = 0.5 * U0 ** 2   # mean of u^2+v^2 at t=0
        rate = -math.log(ke / ke0) / t
        want = 4 * NU * K * K
        assert abs(rate / want - 1) < 0.02, (rate, want)
        # the residual is the discrete-Laplacian wavenumber deficit:
        # k_d^2/k^2 = 2(1-cos(k dx))/(k dx)^2
        th = K * grid.dx
        kd2 = 2 * (1 - math.cos(th)) / (grid.dx ** 2)
        want_d = 4 * NU * kd2
        assert abs(rate / want_d - 1) < 0.005, (rate, want_d)

    def test_z_invariance_aloft(self):
        _, _, state = _run(16, 0.01, 100)
        w = np.asarray(state.c.w)[:, :, NZ // 2:]
        assert np.abs(w).max() < 1e-6 * U0, np.abs(w).max()

    def test_temporal_convergence(self):
        """RK3 self-convergence on a fixed 24^2 grid at t = 0.8 s:
        order >= 2 (Wicker-Skamarock RK3 is 2nd order for nonlinear
        problems, 3rd for linear)."""
        t_final = 0.8
        sols = []
        for dt in (0.1, 0.05, 0.025, 0.0125):
            _, _, state = _run(24, dt, int(round(t_final / dt)))
            sols.append((np.asarray(state.c.u), np.asarray(state.c.v)))
        ref_u, ref_v = sols[-1]
        errs = [np.sqrt(np.mean((u - ref_u) ** 2 + (v - ref_v) ** 2))
                for u, v in sols[:-1]]
        orders = [math.log2(errs[i] / errs[i + 1]) for i in range(len(errs) - 1)]
        assert min(orders) > 1.9, (errs, orders)
