"""Tests for lstend subsidence, nudging, fixuinf controllers, shifted PBCs,
periodic EB correction."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from udales_jax.config import PhysicsConfig
from udales_jax.ops.forces import (fixuinf1, lstend, nudge_top,
                                   periodic_eb_corr, shifted_pbcs)
from tests.test_core import make_cfg, make_model, init_state


class TestLstend:
    def test_subsidence_direction(self):
        """Downward w_ls with a positive thl gradient cools the interior
        (advects warmer air downward ... subsidence warms: w<0, dthl/dz>0
        -> -w dthl/dz > 0 -> heating)."""
        model = make_model()
        grid = model.grid
        nz = grid.ktot
        cfg = model.cfg
        whls = jnp.full(nz + 1, -0.01)
        thl0av = jnp.asarray(288.0 + np.arange(nz) * 1.0)
        z = jnp.zeros(nz)
        du, dv, dthl, dqt, dsv = lstend(
            None, grid, cfg, whls, z, z, thl0av, z,
            jnp.zeros((0, nz)))
        assert float(dthl[2]) > 0  # subsidence warming
        np.testing.assert_allclose(np.asarray(dthl[1:-1]), 0.01, rtol=1e-6)

    def test_wired_into_step(self):
        model = make_model()
        model.has_lstend = True
        model.whls = jnp.full(model.grid.ktot + 1, -0.01, jnp.float64)
        state = init_state(model, amp=0.0)
        s2 = jax.jit(model.step)(state)
        assert np.isfinite(np.asarray(s2.c.u)).all()


class TestFixuinf:
    def test_mode1_controller(self):
        """u0av(ke) relaxes toward Uinf within one step."""
        cfg = make_cfg()
        cfg = dataclasses.replace(
            cfg, physics=dataclasses.replace(cfg.physics, ifixuinf=1),
            bc=dataclasses.replace(cfg.bc, Uinf=2.0))
        model = make_model(cfg)
        state = init_state(model, amp=0.0)   # u = 1 everywhere
        s2 = jax.jit(model.step)(state)
        # correction -(1/dt)(1-2) = +1/dt applied on substep 3 with
        # rk3coef=dt -> du = +1 across the domain
        assert np.mean(np.asarray(s2.c.u)) > 1.5

    def test_mode2_controller_state(self):
        cfg = make_cfg()
        cfg = dataclasses.replace(
            cfg, physics=dataclasses.replace(cfg.physics, ifixuinf=2,
                                             tscale=10.0, inletav=1.0),
            bc=dataclasses.replace(cfg.bc, Uinf=0.5))
        model = make_model(cfg)
        from udales_jax.state import Ctl
        z = jnp.zeros((), jnp.float64)
        state = init_state(model, amp=0.0).replace(
            ctl=Ctl(freestreamav=z + 0.5, dgdt=z, dpdx_shift=z))
        s2 = jax.jit(model.step)(state)
        # free stream 1.0 > Uinf 0.5 -> dgdt > 0 (dpdx grows to slow flow)
        assert float(s2.ctl.dgdt) > 0


class TestShiftedPBC:
    def test_only_downstream_half(self):
        model = make_model()
        state = init_state(model, amp=0.05)
        du, dv, dw = shifted_pbcs(state.c, model.grid, model.cfg, 0.02,
                                  jnp.ones(model.grid.ktot), ds=1.0)
        du = np.asarray(du)
        assert np.abs(du[: model.grid.itot // 2 + 1]).max() == 0.0
        assert np.abs(du[model.grid.itot // 2 + 1:]).max() > 0.0


class TestPeriodicEB:
    def test_energy_balance(self):
        """The volume sink removes fraction*flux; the top cell takes the
        remainder: integral of dthl * dV = tot flux (as the reference's
        Grylls-2021 correction intends)."""
        model = make_model()
        grid = model.grid
        cfg = dataclasses.replace(
            model.cfg, eb=dataclasses.replace(model.cfg.eb,
                                              lperiodicEBcorr=True,
                                              fraction=1.0, sinkbase=2))
        dthl, dqt = periodic_eb_corr(grid, cfg, jnp.asarray(-5.0),
                                     jnp.asarray(0.0), jnp.float64)
        vol_per_slab = grid.xlen * grid.ylen * grid.dzf
        total = float(jnp.sum(dthl * vol_per_slab))
        assert abs(total - (-5.0)) < 0.5


class TestNudgeWiring:
    def test_nudge_in_step(self):
        """Regression: lnudge runs inside Model.step with the slab averages
        from thermodynamics (example-201 configuration; modforces.f90:826)."""
        cfg = make_cfg()
        cfg = dataclasses.replace(
            cfg, physics=dataclasses.replace(
                cfg.physics, lnudge=True, nnudge=4, tnudge=100.0,
                ltempeq=True))
        model = make_model(cfg)
        nz = model.grid.ktot

        class _Ins:
            prof = dict(u=np.full(nz, 2.0), v=np.zeros(nz),
                        thl=np.full(nz, 288.0), qt=np.zeros(nz))
        model.inputs = _Ins()
        state = init_state(model, amp=0.0)
        s2 = jax.jit(model.step)(state)
        assert np.isfinite(np.asarray(s2.c.u)).all()
        # u starts at 1, nudged toward 2 in the top slabs: tendency > 0 there
        du = np.asarray(s2.c.u - state.c.u).mean(axis=(0, 1))
        assert du[-1] > 0
