"""Lund-1998 rescale-recycle inlet generator (ops/inletgen.py vs
modinlet.f90): thickness functions against analytic profiles, the
reference's interpolation/extrapolation rules, and a jitted end-to-end
run with the generator active."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from udales_jax.config import (BCConfig, Config, DomainConfig, DriverConfig,
                               PhysicsConfig, RunConfig, WallsConfig, const)
from udales_jax.grid import Grid
from udales_jax.ops import inletgen as ig


class TestThickness:
    def test_momentum_thickness_linear(self):
        # u = z/H: theta = int (u/U)(1-u/U) dz = H (1/2 - 1/3) = H/6
        nz, H = 64, 2.0
        dz = H / nz
        zf = (np.arange(nz) + 0.5) * dz
        u = jnp.asarray(zf / H)
        th = ig.momentumthicknessexp(u / float(u[-1]), jnp.full(nz, dz))
        # normalized by u(top) internally; analytic with u(top)=zf[-1]/H
        r = zf / zf[-1]
        expect = np.sum((r - r * r) * dz)
        assert float(th) == pytest.approx(expect, rel=1e-6)

    def test_bl_thickness_criterion(self):
        nz = 32
        zf = np.arange(nz) + 0.5
        zh0 = 0.0
        u = jnp.asarray(np.minimum(zf / 10.0, 1.0))  # BL top at z=10
        d = ig.blthicknesst(u, jnp.asarray(zf), zh0, 0.99)
        assert 9.0 < float(d) < 10.5

    def test_bl_thickness_never_reached(self):
        nz = 16
        zf = np.arange(nz) + 0.5
        u = jnp.asarray(np.linspace(0.0, 1.0, nz))  # exceeds 0.99*u(top)
        # monotone rising: crossing near the top; cap at zf[-1]
        d = ig.blthicknesst(u, jnp.asarray(zf), 0.0, 0.99)
        assert float(d) <= zf[-1]

    def test_wallaw_viscous_limit(self):
        # tiny velocity -> viscous sublayer: tau = 2 nu u / dz
        u, dz, nu = 1e-6, 0.1, 1.5e-5
        tau = float(ig.wallawinlet(jnp.asarray(u), dz, nu))
        assert tau == pytest.approx(2 * nu * u / dz, rel=1e-12)
        # sign follows utan
        assert float(ig.wallawinlet(jnp.asarray(-u), dz, nu)) < 0

    def test_enthalpy_thickness_regularized(self):
        nz = 8
        u = jnp.ones(nz)
        t = jnp.full(nz, 288.0)
        dz = jnp.ones(nz)
        out = float(ig.enthalpythickness(t, u, dz, 288.0))
        assert out == pytest.approx(1e-6)


class TestInterp:
    def test_identity(self):
        z = jnp.asarray(np.linspace(0.5, 10.0, 20))
        v = jnp.asarray(np.random.default_rng(0).random(20))
        out = ig._interp_profile(z, v, z, 0.0, -1.0)
        assert np.allclose(out[:-1], v[:-1], atol=1e-6)

    def test_bottom_anchor(self):
        z = jnp.asarray([1.0, 2.0, 3.0])
        v = jnp.asarray([2.0, 4.0, 6.0])
        # target below first source point: linear from anchor at z=0
        out = ig._interp_profile(z, v, jnp.asarray([0.5]), 0.0, -1.0)
        assert float(out[0]) == pytest.approx(1.0)
        # anchored at thls-style offset
        out2 = ig._interp_profile(z, v, jnp.asarray([0.5]), 1.0, -1.0)
        assert float(out2[0]) == pytest.approx(1.0 + (2.0 - 1.0) / 1.0 * 0.5)

    def test_top_extrapolation(self):
        z = jnp.asarray([1.0, 2.0, 3.0])
        v = jnp.asarray([2.0, 4.0, 6.0])
        out = ig._interp_profile(z, v, jnp.asarray([5.0]), 0.0, 99.0)
        assert float(out[0]) == 99.0


def _build_model(nz=32, ltempeq=True):
    from udales_jax.ops.openbc import BC_RECYCLE, Inlet
    from udales_jax.run import Model
    n = 32
    cfg = Config(
        domain=DomainConfig(itot=n, jtot=n, ktot=nz, xlen=float(n),
                            ylen=float(n)),
        run=RunConfig(ladaptive=False, dtmax=0.02, lrandomize=False),
        physics=PhysicsConfig(ltempeq=ltempeq, inletav=5.0),
        bc=BCConfig(Uinf=2.0, thls=288.0, thl_top=290.0, z0=0.03,
                    z0h=0.003),
        driver=DriverConfig(iinletgen=1, iplane=n - 8, di=float(nz) / 2,
                            dti=float(nz) / 2),
        dtype="float32")
    grid = Grid.uniform(n, n, nz, float(n), float(n), float(nz),
                        dtype=np.float32)
    model = Model(cfg, grid)
    j = lambda a: jnp.asarray(a, np.float32)
    zf = np.asarray(grid.zf)
    uprof = 2.0 * np.minimum(zf / (0.8 * zf[-1]), 1.0) ** 0.25
    thlprof = 288.0 + 2.0 * zf / zf[-1]
    model.inlet = Inlet(
        mode=BC_RECYCLE, uprof=j(uprof), vprof=j(np.zeros(nz)),
        thlprof=j(thlprof), qtprof=j(np.zeros(nz)),
        e12prof=j(np.full(nz, const.e12min)),
        svprof=jnp.zeros((0, nz), np.float32), irecy=n - 8)
    model.igparams = ig.InletGenParams(cfg, grid)
    return model, uprof, thlprof


def _start(model, uprof, thlprof, seed=5):
    """Cold start from the inlet profiles (load_case feeds prof.inp; the
    bare Model has no inputs, so build the fields explicitly)."""
    from udales_jax.state import initial_state, profile_fields, randomize
    grid = model.grid
    nz = grid.ktot
    f = profile_fields(grid, uprof, np.zeros(nz), thlprof, np.zeros(nz),
                       np.full(nz, const.e12min))
    f = randomize(f, jax.random.PRNGKey(seed), 0.05, nz)
    from udales_jax.ops.openbc import init_xplanes
    f = dataclasses.replace(f, bx=init_xplanes(f, grid))
    st = initial_state(grid, f, dt0=0.02)
    from udales_jax.ops.inletgen import init_inletgen
    return st.replace(ig=init_inletgen(model.cfg, grid, f, model.igparams))


class TestGenerator:
    def test_state_init_and_one_update(self):
        model, uprof, thlprof = _build_model()
        st = _start(model, uprof, thlprof)
        assert st.ig is not None
        g0 = st.ig
        g1 = ig.inletgen_update(g0, st.c, model.cfg, model.grid,
                                jnp.asarray(0.02, np.float32), 1,
                                model.igparams)
        # planes well-formed
        assert np.isfinite(np.asarray(g1.u0)).all()
        assert np.asarray(g1.w0)[:, 0].max() == 0.0
        assert np.asarray(g1.w0)[:, -1].max() == 0.0
        # friction velocity positive and boundedly small
        assert 0.0 < float(g1.utaui) < 1.0
        # temperature plane blends toward thls at the wall, thl_top aloft
        t0 = np.asarray(g1.t0).mean(axis=0)
        assert t0[0] < t0[-1]

    def test_jit_run_stable(self):
        model, uprof, thlprof = _build_model()
        st = _start(model, uprof, thlprof)
        step = jax.jit(model.step)
        for _ in range(4):
            st = step(st)
        u = np.asarray(st.c.u)
        assert np.isfinite(u).all()
        assert np.isfinite(np.asarray(st.ig.Urec)).all()
        # generated inlet mean stays near the running inlet profile
        err = np.abs(np.asarray(st.ig.u0).mean(axis=0)
                     - np.asarray(st.ig.Uinl))
        assert err.max() < 1.0

    def test_notemp_leaves_temperature(self):
        model, uprof, thlprof = _build_model(ltempeq=False)
        st = _start(model, uprof, thlprof)
        g1 = ig.inletgen_update(st.ig, st.c, model.cfg, model.grid,
                                jnp.asarray(0.02, np.float32), 1,
                                model.igparams)
        assert np.array_equal(np.asarray(g1.t0), np.asarray(st.ig.t0))
