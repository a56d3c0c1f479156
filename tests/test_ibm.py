"""IBM tests against reference example 101 (infinite canyon, 64^3):
geometry loading, mask consistency, and a short stable integration with
solid-cell velocity suppression.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

CASE = Path("/root/reference/examples/101")

pytestmark = pytest.mark.skipif(not CASE.exists(), reason="reference absent")


@pytest.fixture(scope="module")
def model():
    from udales_jax.run import load_case
    return load_case(CASE, "101", dtype="float32")


class TestLoad:
    def test_counts(self, model):
        ibm = model.ibm
        w = model.cfg.walls
        assert ibm.nfcts == w.nfcts == 320
        assert int((1 - np.asarray(ibm.masks.u)).sum()) == w.nsolpts_u
        assert int((1 - np.asarray(ibm.masks.w)[:, :, 1:]).sum()) \
            == w.nsolpts_w - 64 * 64  # floor faces are in solid_w
        assert len(ibm.sec["u"].fac) == w.nfctsecs_u

    def test_masks_floor_solid(self, model):
        assert np.all(np.asarray(model.ibm.masks.w)[:, :, 0] == 0)

    def test_facet_props(self, model):
        ibm = model.ibm
        # roof/road facets are asphalt (z0=0.05); bounding walls z0=0
        assert np.isclose(ibm.facz0.max(), 0.05)
        assert (ibm.facz0 >= 0).all()

    def test_skip_logic(self, model):
        ibm = model.ibm
        # u-sections on x-normal facets are skipped (normal aligned with dir)
        s = ibm.sec["u"]
        norm = ibm.facnorm[s.fac]
        xnormal = np.abs(np.abs(norm[:, 0]) - 1) < 1e-10
        assert not s.active[xnormal].any()
        # z0=0 facets always skipped
        z0zero = ibm.facz0[s.fac] < 1e-10
        assert not s.active[z0zero].any()


class TestRun:
    def test_short_run(self, model):
        state = model.cold_start(seed=3)
        step = jax.jit(model.step)
        s = state
        for _ in range(3):
            s = step(s)
        u = np.asarray(s.c.u)
        assert np.isfinite(u).all()
        # solid u points: stay small (only pressure-correction residual)
        mask = np.asarray(model.ibm.masks.u)
        assert np.abs(u[mask == 0]).max() < 0.2
        assert np.abs(u[mask == 1]).max() < 5.0
        # thl stays physical
        thl = np.asarray(s.c.thl)
        assert 280 < thl.min() < thl.max() < 310

    def test_divergence_free_fluid(self, model):
        state = model.cold_start(seed=3)
        s = jax.jit(model.step)(state)
        grid = model.grid
        c = s.c
        gu = jnp.pad(c.u, ((0, 1), (0, 0), (0, 0)), mode="wrap")
        gv = jnp.pad(c.v, ((0, 0), (0, 1), (0, 0)), mode="wrap")
        div = ((gu[1:] - gu[:-1]) * grid.dxi
               + (gv[:, 1:] - gv[:, :-1]) * grid.dyi
               + (c.w[:, :, 1:] - c.w[:, :, :-1])
               * grid.dzfi[None, None, :].astype(np.float32))
        assert float(jnp.abs(div).max()) < 1e-4


class TestReconstruction:
    """Reconstruction-point path (initibmwallfun:384-533, wallfunmom:1352)."""

    def _grid(self):
        from udales_jax.grid import Grid
        return Grid.uniform(16, 12, 8, 16.0, 12.0, 8.0, dtype=np.float64)

    def test_reconstruction_point_geometry(self):
        from udales_jax.ibm.ibm import _reconstruction_data
        grid = self._grid()
        ijk = np.array([[5, 5, 2]])
        dist = np.array([0.01])
        n = np.array([[1.0, 0.0, 1.0]]) / np.sqrt(2.0)
        z0 = np.array([0.01])
        ok, recdist, interp = _reconstruction_data(ijk, dist, n, z0, 0, grid)
        assert ok[0]
        # p0=(5.5,5.5,2.5); exit through x=6 / z=3 at t=0.5/ (3^(1/2)/2^(1/2))
        t = 0.5 / (np.sqrt(3.0) / np.sqrt(2.0))
        assert np.isclose(recdist[0], 0.01 + t * np.sqrt(3.0))
        for key in ("u", "v", "w", "c"):
            idx, wgt = interp[key]
            assert np.allclose(wgt.sum(axis=1), 1.0)

    def test_too_close_skipped_when_lnorec(self):
        """With lnorec the close section is skipped (reference switch)."""
        import dataclasses
        from udales_jax.run import load_case
        cfg_mod = load_case(CASE, "101", dtype="float32")
        # 101's asphalt z0=0.05, dist ~0.25 -> log(5)=1.6>1: no rec needed
        for s in cfg_mod.ibm.sec.values():
            if s.rec is not None:
                assert not s.rec.any()

    def test_trilinear_sampling(self):
        """A linear field is reproduced exactly at the reconstruction
        point (trilinear_interp_var:1609)."""
        from udales_jax.config import Config, DomainConfig
        from udales_jax.ibm.ibm import (IBM, Masks, SecData,
                                        _reconstruction_data)
        grid = self._grid()
        nx, ny, nz = grid.shape
        cfg = Config(domain=DomainConfig(itot=nx, jtot=ny, ktot=nz,
                                         xlen=16.0, ylen=12.0))
        ijk = np.array([[5, 5, 2]])
        dist = np.array([0.01])
        facnorm = np.array([[1.0, 0.0, 1.0]]) / np.sqrt(2.0)
        z0 = np.array([0.01])
        ok, recdist, interp = _reconstruction_data(ijk, dist, facnorm, z0,
                                                   0, grid)
        assert ok[0]
        sec_c = SecData(ijk=ijk, area=np.array([1.0]), dist=recdist,
                        fac=np.array([0]), active=np.array([True]),
                        rec=ok, interp=interp)
        z = np.zeros(0)
        empty = SecData(np.zeros((0, 3), np.int64), z, z,
                        np.zeros(0, np.int64), z.astype(bool))
        ones = lambda *s: jnp.ones(s, jnp.float64)
        masks = Masks(u=ones(nx, ny, nz), v=ones(nx, ny, nz),
                      w=ones(nx, ny, nz + 1), c=ones(nx, ny, nz))
        ibm = IBM(cfg, grid, masks, empty, empty, empty, sec_c,
                  facnorm, z0, z0 / 10, np.array([288.0]), np.array([1.0]))
        # linear fields: u = x (on u faces x=i), thl = 300 + z
        import dataclasses as dc
        from udales_jax.state import profile_fields
        f = profile_fields(grid, np.zeros(nz), np.zeros(nz),
                           np.full(nz, 288.0), np.zeros(nz),
                           np.full(nz, 5e-5))
        u = jnp.broadcast_to(jnp.arange(nx, dtype=jnp.float64)[:, None, None],
                             (nx, ny, nz))
        thl = jnp.broadcast_to(300.0 + jnp.asarray(grid.j("zf")),
                               (nx, ny, nz))
        f = dc.replace(f, u=u, thl=thl)
        uu, vv, ww, Ta = ibm._gather_uvw("c", f, grid)
        # recpt = p0 + t*seg = (6.0, 5.5, 3.0)
        assert np.isclose(float(uu[0]), 6.0, atol=1e-12)
        assert np.isclose(float(Ta[0]), 303.0, atol=1e-12)
        assert np.isclose(float(vv[0]), 0.0, atol=1e-12)


class TestWritefac:
    """lwritefac facet stress/pressure output (modibm.f90:198-247,
    1416-1430, 1475-1476, 1539-1540)."""

    @pytest.fixture(scope="class")
    def model_wf(self):
        import dataclasses
        from udales_jax.config import load_namoptions
        from udales_jax.grid import Grid
        from udales_jax.ibm.ibm import IBM
        from udales_jax.io.inputs import CaseInputs
        from udales_jax.run import Model
        cfg = load_namoptions(CASE / "namoptions.101")
        cfg = dataclasses.replace(
            cfg, walls=dataclasses.replace(cfg.walls, lwritefac=True))
        dom = cfg.domain
        grid = Grid.from_prof_inp(CASE / "prof.inp.101", dom.itot, dom.jtot,
                                  dom.ktot, dom.xlen, dom.ylen,
                                  dtype=np.float32)
        inputs = CaseInputs.load(CASE, "101", dom.ktot, cfg.scalars.nsv)
        ibm = IBM.load(CASE, "101", cfg, grid)
        return Model(cfg, grid, inputs, ibm)

    def test_accumulation_and_write(self, model_wf, tmp_path):
        import dataclasses
        model = model_wf
        state = model.cold_start(seed=3)
        assert state.facstats is not None
        s = jax.jit(model.step)(state)
        fs = s.facstats
        tau_x = np.asarray(fs.tau_x)
        # canyon walls feel x-stress on some facets; floor facets (z-normal)
        # appear in tau_x via u-sections below them
        assert np.isfinite(tau_x).all()
        assert np.abs(tau_x).max() > 0
        # pressure accumulators picked up pres0 (nonzero after projection)
        assert np.abs(np.asarray(fs.pres)).max() > 0
        # dt-weighting: one substep-3 accumulation of dt * <tau>
        dt = float(s.dt)
        assert np.abs(tau_x).max() < dt * 10.0

        # write + reset via the Simulation writer path
        from udales_jax.sim import Simulation
        sim = Simulation(model, outdir=tmp_path, monitor=False)
        s2 = sim._write_facstats(s, float(s.timee))
        assert float(np.abs(np.asarray(s2.facstats.tau_x)).max()) == 0.0
        sim.facstatwriter.close()
        from udales_jax.post import NCData
        d = NCData(tmp_path / "fac.101.nc")
        assert set(("tau_x", "tau_y", "tau_z", "pres", "htc", "cth",
                    "pres_flc")) <= set(d.variables())
        # written mean = accumulated/interval
        tint = float(s.timee)
        assert np.allclose(d["tau_x"][0], tau_x / tint, rtol=1e-5,
                           atol=1e-12)
        d.close()


class TestConservativeIBM:
    """advecc2nd_corr_conservative (modibm.f90:889-933): with the
    conservative correction, the cd2 advective tendency summed over fluid
    cells (volume-weighted) is exactly telescoping — fluid-fluid face fluxes
    cancel pairwise and fluid-solid face fluxes are removed — so the total
    is zero on a periodic domain, for ANY velocity field."""

    def _fields(self, model, seed):
        s = model.cold_start(seed=seed)
        c = s.c
        key = jax.random.PRNGKey(seed)
        k1, k2 = jax.random.split(key)
        # non-solenoidal random velocities + structured scalar: conservation
        # must hold regardless
        import dataclasses
        w = c.w + 0.3 * jax.random.normal(k1, c.w.shape, c.w.dtype)
        w = w.at[:, :, 0].set(0.0).at[:, :, -1].set(0.0)  # impermeable walls
        c = dataclasses.replace(
            c,
            u=c.u + 0.3 * jax.random.normal(k1, c.u.shape, c.u.dtype),
            w=w,
            thl=c.thl + 2.0 * jax.random.normal(k2, c.thl.shape, c.thl.dtype))
        return c

    def test_conservative_sums_to_zero(self):
        from udales_jax.ops.advection import adv_c2
        from udales_jax.ops.boundary import make_ghosts
        from udales_jax.run import load_case
        model = load_case(CASE, "101", dtype="float64")
        grid, cfg, ibm = model.grid, model.cfg, model.ibm
        c = self._fields(model, 7)
        zeros = jnp.zeros_like(c.thl)
        g = make_ghosts(c, zeros, zeros, cfg, grid)
        adv = adv_c2(g.thl, g, grid)
        corr = ibm._advecc2nd_corr_conservative(c.thl, c, grid)
        dzf = np.asarray(grid.dzf)
        vol = (grid.dx * grid.dy * dzf)[None, None, :]
        mc = np.asarray(ibm.masks.c, np.float64)
        tot_cons = float(np.sum((np.asarray(adv, np.float64)
                                 + np.asarray(corr, np.float64)) * mc * vol))
        scale = float(np.sum(np.abs(np.asarray(adv, np.float64)) * mc * vol))
        assert abs(tot_cons) < 1e-12 * max(scale, 1.0)
        # the liberal correction is deliberately NOT conservative
        corr_l = ibm._advecc2nd_corr_liberal(c.thl, c, grid)
        tot_lib = float(np.sum((np.asarray(adv, np.float64)
                                + np.asarray(corr_l, np.float64)) * mc * vol))
        assert abs(tot_lib) > 100 * abs(tot_cons)

    def test_switch_selects_conservative(self):
        import dataclasses
        from udales_jax.run import load_case
        m = load_case(CASE, "101", dtype="float32")
        m.cfg = dataclasses.replace(
            m.cfg, physics=dataclasses.replace(
                m.cfg.physics, lconservativeibm=True))
        s = m.cold_start(seed=3)
        s = jax.jit(m.step)(s)
        assert np.isfinite(np.asarray(s.c.thl)).all()


class TestTauDiagnostics:
    """tau_x/y/z + thl_flux fielddump diagnostics (modibm.f90:1185,
    2014-2093): per-substep wall-function tendency increments."""

    def test_taud_and_masks_dump(self, tmp_path):
        import dataclasses
        from udales_jax.run import load_case
        from udales_jax.sim import Simulation
        m = load_case(CASE, "101", dtype="float32")
        m.cfg = dataclasses.replace(
            m.cfg, output=dataclasses.replace(
                m.cfg.output, lfielddump=True, tfielddump=0.01,
                fieldvars="u0,tx,ty,tz,hf,mu,mc"))
        m.need_taudiag = True
        sim = Simulation(m, tmp_path)
        st = m.cold_start(seed=3)
        st = jax.jit(m.step)(st)
        assert st.taud is not None
        tx = np.asarray(st.taud["x"])
        assert np.isfinite(tx).all()
        # wall functions act somewhere: nonzero stress increments exist
        assert np.abs(tx).max() > 0
        sim.fielddump.dump(st)
        sim.fielddump.close()
        from udales_jax.post import NCData
        nc = NCData(tmp_path / "fielddump.101.nc")
        assert "tau_x" in nc.variables() and "mask_u" in nc.variables()
        mu = nc["mask_u"]
        assert set(np.unique(mu)) <= {0.0, 1.0}
        nc.close()


class TestDiffCorrFolding:
    """The IBM diffusion corrections folded into the main sweeps as {0,1}
    flux masks (subgrid.diff_u/..., run.py) must reproduce the separate
    sweep+correction passes exactly (f64) on the real 101 case."""

    def _run(self, fold, nsteps=3):
        from udales_jax.run import load_case
        m = load_case(CASE, "101", dtype="float64")
        m.ibm.fold_diffcorr = fold
        state = m.cold_start(seed=11)
        step = jax.jit(m.step)
        for _ in range(nsteps):
            state = step(state)
        return state

    def test_folded_equals_separate(self):
        a = self._run(True)
        b = self._run(False)
        for name in ("u", "v", "w", "thl", "qt", "sv"):
            fa = np.asarray(getattr(a.c, name))
            fb = np.asarray(getattr(b.c, name))
            sc = max(np.abs(fb).max(), 1e-12)
            np.testing.assert_allclose(fa, fb, rtol=0, atol=1e-12 * sc,
                                       err_msg=name)

    def test_masked_sweep_equals_sweep_plus_corr_directly(self):
        """Operator-level check: diff_* with M == diff_* + _diff*_corr
        at fluid points (solid points differ until ibmnorm zeroes them)."""
        from udales_jax.ops import subgrid as sg
        from udales_jax.ops.boundary import make_ghosts
        from udales_jax.run import load_case
        m = load_case(CASE, "101", dtype="float64")
        ibm, grid, cfg = m.ibm, m.grid, m.cfg
        state = m.cold_start(seed=13)
        ekm = jnp.asarray(
            np.random.default_rng(17).uniform(1e-4, 1e-2, grid.shape))
        g = make_ghosts(state.c, ekm, ekm, cfg, grid)
        Mu = np.asarray(ibm.masks.u, bool)
        got = np.asarray(sg.diff_u(g, grid, M=ibm.pmask_u))
        want = np.asarray(sg.diff_u(g, grid)
                          + ibm._diffu_corr(g, grid))
        np.testing.assert_allclose(got[Mu], want[Mu], rtol=1e-12,
                                   atol=1e-14)
        Mw = np.asarray(ibm.masks.w, bool)
        gotw = np.asarray(sg.diff_w(g, grid, M=ibm.pmask_w))
        wantw = np.asarray(sg.diff_w(g, grid)
                           + ibm._diffw_corr(g, grid))
        np.testing.assert_allclose(gotw[Mw], wantw[Mw], rtol=1e-12,
                                   atol=1e-14)
        Mc = np.asarray(ibm.masks.c, bool)
        gotc = np.asarray(sg.diff_c(g.thl, g.ekh, grid, M=ibm.pmask_c))
        wantc = np.asarray(sg.diff_c(g.thl, g.ekh, grid)
                           + ibm._diffc_corr(g.thl, g.ekh, grid))
        np.testing.assert_allclose(gotc[Mc], wantc[Mc], rtol=1e-12,
                                   atol=1e-14)
