"""Open-boundary (inflow/outflow) tests: profile inlet + convective outlet
channel flow, mass conservation, divergence, and driver record/replay."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from udales_jax.config import (BCConfig, Config, DomainConfig, RunConfig,
                               PhysicsConfig, WallsConfig, BC_PROFILE,
                               BC_DRIVER, BC_PERIODIC)
from udales_jax.grid import Grid
from udales_jax.run import Model
from udales_jax.ops.openbc import Inlet, init_xplanes
from udales_jax.state import initial_state, profile_fields, randomize


def make_open_model(nx=16, ny=12, nz=8, u0=1.0):
    cfg = Config(
        domain=DomainConfig(itot=nx, jtot=ny, ktot=nz, xlen=float(nx),
                            ylen=float(ny)),
        run=RunConfig(ladaptive=False, dtmax=0.02, lrandomize=False),
        physics=PhysicsConfig(luvolflowr=False),
        walls=WallsConfig(lbottom=True),
        bc=BCConfig(BCxm=BC_PROFILE, BCxT=BC_PROFILE, BCxq=BC_PROFILE,
                    BCxs=BC_PROFILE, z0=0.01, z0h=0.001, thls=288.0),
        dtype="float64")
    grid = Grid.uniform(nx, ny, nz, float(nx), float(ny), float(nz),
                        dtype=np.float64)
    model = Model(cfg, grid)
    j = jnp.asarray
    model.inlet = Inlet(
        mode=BC_PROFILE, uprof=j(np.full(nz, u0)), vprof=j(np.zeros(nz)),
        thlprof=j(np.full(nz, 288.0)), qtprof=j(np.zeros(nz)),
        e12prof=j(np.full(nz, 5e-5)),
        svprof=jnp.zeros((0, nz)))
    return model


def open_state(model, amp=0.02, seed=2):
    nz = model.grid.ktot
    f = profile_fields(model.grid, np.full(nz, 1.0), np.zeros(nz),
                       np.full(nz, 288.0), np.zeros(nz), np.full(nz, 5e-5))
    if amp:
        f = randomize(f, jax.random.PRNGKey(seed), amp, nz)
    f = dataclasses.replace(f, bx=init_xplanes(f, model.grid))
    return initial_state(model.grid, f, dt0=0.02)


class TestProfileInlet:
    def test_inlet_enforced(self):
        model = make_open_model()
        s = jax.jit(model.step)(open_state(model))
        np.testing.assert_allclose(np.asarray(s.c.u[0]), 1.0, atol=1e-12)

    def test_divergence_free(self):
        model = make_open_model()
        s = jax.jit(model.step)(open_state(model))
        grid = model.grid
        c = s.c
        # interior divergence with the outlet face from bx
        uf = jnp.concatenate([c.u, c.bx.u[None]], axis=0)
        gv = jnp.pad(c.v, ((0, 0), (0, 1), (0, 0)), mode="wrap")
        div = ((uf[1:] - uf[:-1]) * grid.dxi
               + (gv[:, 1:] - gv[:, :-1]) * grid.dyi
               + (c.w[:, :, 1:] - c.w[:, :, :-1])
               * grid.dzfi[None, None, :])
        div = np.asarray(div)
        # the inflow/outflow compatibility defect is absorbed at the top
        # level of the mean pressure mode (the reference's Dirichlet-across-
        # the-top-cell pin, modpois.f90:208-220); interior must be clean
        assert np.abs(div[:, :, :-1]).max() < 1e-8
        assert np.abs(div[:, :, -1]).max() < 1e-2

    def test_mass_conservation(self):
        """Net outflow approaches net inflow (uniform u: flux through the
        outlet face equals the inlet flux)."""
        model = make_open_model()
        s = open_state(model, amp=0.0)
        step = jax.jit(model.step)
        for _ in range(10):
            s = step(s)
        influx = float(jnp.mean(s.c.u[0]))
        outflux = float(jnp.mean(s.c.bx.u))
        assert abs(influx - 1.0) < 1e-12
        assert abs(outflux - influx) < 0.05, (influx, outflux)

    def test_stable_with_perturbations(self):
        model = make_open_model()
        s = open_state(model, amp=0.05)
        step = jax.jit(model.step)
        for _ in range(10):
            s = step(s)
        assert np.isfinite(np.asarray(s.c.u)).all()
        assert np.abs(np.asarray(s.c.u)).max() < 5.0
        assert np.isfinite(np.asarray(s.c.bx.v)).all()


class TestDriverReplay:
    def test_record_then_replay(self, tmp_path):
        """Record planes from a periodic run, replay them as inlet: the
        replayed inlet must equal the recorded planes (time-interpolated)."""
        from udales_jax.sim import DriverRecorder
        from udales_jax.ops.openbc import load_driver_inlet
        from tests.test_core import make_cfg, make_model, init_state

        # precursor: tiny periodic run, record every step
        cfg = make_cfg()
        cfg = dataclasses.replace(
            cfg, driver=dataclasses.replace(cfg.driver, idriver=1,
                                            tdriverstart=0.0, dtdriver=0.02,
                                            iplane=16))
        pre = make_model(cfg)
        rec = DriverRecorder(cfg, pre.grid, tmp_path)
        s = init_state(pre)
        step = jax.jit(pre.step)
        for _ in range(6):
            s = step(s)
            rec.maybe_record(s)
        path = rec.save()
        assert path is not None

        inlet = load_driver_inlet(path, np.float64)
        assert inlet.u.shape[0] >= 5
        # interpolation: halfway between two samples
        t0, t1 = float(inlet.t[1]), float(inlet.t[2])
        planes = inlet.planes(jnp.asarray(0.5 * (t0 + t1)), 12, 8)
        expect = 0.5 * (np.asarray(inlet.u[1]) + np.asarray(inlet.u[2]))
        np.testing.assert_allclose(np.asarray(planes["u"]), expect,
                                   rtol=1e-12)

    def test_driver_inlet_run(self, tmp_path):
        """Drive an open-x run from recorded planes; inlet must follow."""
        from udales_jax.sim import DriverRecorder
        from udales_jax.ops.openbc import load_driver_inlet
        from tests.test_core import make_cfg, make_model, init_state

        cfg = make_cfg()
        cfg = dataclasses.replace(
            cfg, driver=dataclasses.replace(cfg.driver, idriver=1,
                                            tdriverstart=0.0, dtdriver=0.02,
                                            iplane=16))
        pre = make_model(cfg)
        rec = DriverRecorder(cfg, pre.grid, tmp_path)
        s = init_state(pre)
        step = jax.jit(pre.step)
        for _ in range(8):
            s = step(s)
            rec.maybe_record(s)
        path = rec.save()

        model = make_open_model()
        model.cfg = dataclasses.replace(
            model.cfg, bc=dataclasses.replace(model.cfg.bc, BCxm=BC_DRIVER,
                                              BCxT=BC_DRIVER,
                                              BCxq=BC_DRIVER,
                                              BCxs=BC_DRIVER))
        model.inlet = load_driver_inlet(path, np.float64)
        s2 = open_state(model, amp=0.0)
        s2 = s2.replace(timee=jnp.asarray(0.05, jnp.float64))
        out = jax.jit(model.step)(s2)
        # inlet face equals the interpolated driver plane at the new time
        planes = model.inlet.planes(out.timee, 12, 8)
        np.testing.assert_allclose(np.asarray(out.c.u[0]),
                                   np.asarray(planes["u"]), atol=1e-12)
        assert np.isfinite(np.asarray(out.c.u)).all()


class TestRecycleInlet:
    def test_recycle_rescale(self):
        """Recycle inlet: inlet mean equals target, fluctuations recycled."""
        from udales_jax.ops.openbc import BC_RECYCLE, Inlet
        model = make_open_model()
        nz = model.grid.ktot
        j = jnp.asarray
        model.inlet = Inlet(
            mode=BC_RECYCLE, uprof=j(np.full(nz, 1.0)),
            vprof=j(np.zeros(nz)), thlprof=j(np.full(nz, 288.0)),
            qtprof=j(np.zeros(nz)), e12prof=j(np.full(nz, 5e-5)),
            svprof=jnp.zeros((0, nz)), irecy=12)
        s = open_state(model, amp=0.05)
        step = jax.jit(model.step)
        for _ in range(3):
            s = step(s)
        u_in = np.asarray(s.c.u[0])
        # slab mean at the inlet equals the target profile
        np.testing.assert_allclose(u_in.mean(axis=0), 1.0, atol=1e-6)
        # turbulence is carried in
        assert u_in.std() > 1e-4
        assert np.isfinite(np.asarray(s.c.u)).all()


# ---------------------------------------------------------------------------
# Open-y (ymi_profile inlet + ymo_convective outlet, modboundary.f90:1017-1190)
# ---------------------------------------------------------------------------

def make_open_y_model(nx=12, ny=16, nz=8, v0=1.0):
    cfg = Config(
        domain=DomainConfig(itot=nx, jtot=ny, ktot=nz, xlen=float(nx),
                            ylen=float(ny)),
        run=RunConfig(ladaptive=False, dtmax=0.02, lrandomize=False),
        physics=PhysicsConfig(lvvolflowr=False),
        walls=WallsConfig(lbottom=True),
        bc=BCConfig(BCym=BC_PROFILE, BCyT=BC_PROFILE, BCyq=BC_PROFILE,
                    BCys=BC_PROFILE, z0=0.01, z0h=0.001, thls=288.0),
        dtype="float64")
    grid = Grid.uniform(nx, ny, nz, float(nx), float(ny), float(nz),
                        dtype=np.float64)
    model = Model(cfg, grid)
    j = jnp.asarray
    model.inlet_y = Inlet(
        mode=BC_PROFILE, uprof=j(np.zeros(nz)), vprof=j(np.full(nz, v0)),
        thlprof=j(np.full(nz, 288.0)), qtprof=j(np.zeros(nz)),
        e12prof=j(np.full(nz, 5e-5)),
        svprof=jnp.zeros((0, nz)))
    return model


def open_y_state(model, amp=0.02, seed=2):
    from udales_jax.ops.openbc import init_yplanes
    nz = model.grid.ktot
    f = profile_fields(model.grid, np.zeros(nz), np.full(nz, 1.0),
                       np.full(nz, 288.0), np.zeros(nz), np.full(nz, 5e-5))
    if amp:
        f = randomize(f, jax.random.PRNGKey(seed), amp, nz)
    f = dataclasses.replace(f, by=init_yplanes(f, model.grid))
    return initial_state(model.grid, f, dt0=0.02)


class TestProfileInletY:
    def test_inlet_enforced(self):
        model = make_open_y_model()
        s = jax.jit(model.step)(open_y_state(model))
        np.testing.assert_allclose(np.asarray(s.c.v[:, 0]), 1.0, atol=1e-12)

    def test_divergence_free(self):
        model = make_open_y_model()
        s = jax.jit(model.step)(open_y_state(model))
        grid = model.grid
        c = s.c
        vf = jnp.concatenate([c.v, c.by.v[:, None]], axis=1)
        gu = jnp.pad(c.u, ((0, 1), (0, 0), (0, 0)), mode="wrap")
        div = ((gu[1:] - gu[:-1]) * grid.dxi
               + (vf[:, 1:] - vf[:, :-1]) * grid.dyi
               + (c.w[:, :, 1:] - c.w[:, :, :-1])
               * grid.dzfi[None, None, :])
        div = np.asarray(div)
        assert np.abs(div[:, :, :-1]).max() < 1e-8
        assert np.abs(div[:, :, -1]).max() < 1e-2

    def test_mass_conservation(self):
        model = make_open_y_model()
        s = open_y_state(model, amp=0.0)
        step = jax.jit(model.step)
        for _ in range(10):
            s = step(s)
        influx = float(jnp.mean(s.c.v[:, 0]))
        outflux = float(jnp.mean(s.c.by.v))
        assert abs(influx - 1.0) < 1e-12
        assert abs(outflux - influx) < 0.05, (influx, outflux)

    def test_stable_with_perturbations(self):
        model = make_open_y_model()
        s = open_y_state(model, amp=0.05)
        step = jax.jit(model.step)
        for _ in range(10):
            s = step(s)
        assert np.isfinite(np.asarray(s.c.v)).all()
        assert np.abs(np.asarray(s.c.v)).max() < 5.0
        assert np.isfinite(np.asarray(s.c.by.u)).all()
