"""Core dynamical-core tests: grid metrics, Poisson solver, divergence-free
projection, conservation sanity, and short stable integration.

Oracle strategy mirrors the reference test suite (SURVEY.md section 4):
in-process checks of primitives against brute force.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from udales_jax.config import Config, DomainConfig, RunConfig, PhysicsConfig, \
    WallsConfig, BCConfig, SubgridConfig, SGS_VREMAN, SGS_DNS
from udales_jax.grid import Grid
from udales_jax.ops.poisson import PoissonSolver, dct2, idct2
from udales_jax.run import Model
from udales_jax.state import initial_state, profile_fields, randomize
import dataclasses


def make_cfg(**kw):
    dom = DomainConfig(itot=16, jtot=12, ktot=8, xlen=16.0, ylen=12.0)
    cfg = Config(domain=dom, dtype="float64",
                 run=RunConfig(ladaptive=False, dtmax=0.02, lrandomize=False),
                 walls=WallsConfig(lbottom=True),
                 bc=BCConfig(z0=0.01, z0h=0.001, thls=288.0))
    return dataclasses.replace(cfg, **kw)


def make_model(cfg=None):
    cfg = cfg or make_cfg()
    d = cfg.domain
    grid = Grid.uniform(d.itot, d.jtot, d.ktot, d.xlen, d.ylen, 8.0,
                        dtype=np.float64)
    return Model(cfg, grid)


def init_state(model, seed=1, amp=0.05):
    nz = model.grid.ktot
    f = profile_fields(model.grid, np.full(nz, 1.0), np.zeros(nz),
                       np.full(nz, 288.0), np.zeros(nz), np.full(nz, 5e-5))
    f = randomize(f, jax.random.PRNGKey(seed), amp, nz)
    return initial_state(model.grid, f, dt0=0.02)


class TestGrid:
    def test_uniform_metrics(self):
        g = Grid.uniform(8, 8, 8, 16.0, 16.0, 8.0, dtype=np.float64)
        assert np.allclose(g.dzf, 1.0)
        assert np.allclose(g.dzh, 1.0)
        assert np.isclose(g.dx, 2.0)
        assert np.isclose(g.zf[0], 0.5)
        assert np.isclose(g.zh[-1], 8.0)

    def test_stretched_metrics(self):
        # geometric stretching: zh reconstructed from zf midpoint recursion
        zf = np.cumsum(1.1 ** np.arange(8)) - 0.5 * 1.1 ** np.arange(8)
        g = Grid(4, 4, 8, 4.0, 4.0, zf, dtype=np.float64)
        assert np.allclose(g.dzf, np.diff(g.zh))
        assert np.allclose(g.dzh[1:-1], zf[1:] - zf[:-1])
        assert np.isclose(g.dzh[0], 2 * zf[0])


class TestDCT:
    def test_roundtrip(self):
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.standard_normal((5, 8, 3)))
        X = dct2(x, axis=1)
        y = idct2(X, axis=1)
        assert np.allclose(y, x, atol=1e-10)

    def test_matches_scipy_def(self):
        rng = np.random.default_rng(1)
        x = rng.standard_normal(16)
        X = np.asarray(dct2(jnp.asarray(x)[None, :], axis=1))[0]
        # REDFT10: X[k] = 2 sum x[j] cos(pi k (2j+1) / 2N)
        j = np.arange(16)
        ref = np.array([2 * np.sum(x * np.cos(np.pi * k * (2 * j + 1) / 32))
                        for k in range(16)])
        assert np.allclose(X, ref, atol=1e-10)


class TestPoisson:
    def test_laplacian_inverse(self):
        """solve() must invert the discrete staggered Laplacian with
        Neumann-z BCs (periodic x/y)."""
        cfg = make_cfg()
        d = cfg.domain
        grid = Grid.uniform(d.itot, d.jtot, d.ktot, d.xlen, d.ylen, 8.0,
                            dtype=np.float64)
        pois = PoissonSolver(grid, cfg)
        rng = np.random.default_rng(2)
        p = jnp.asarray(rng.standard_normal(grid.shape))
        p = p - jnp.mean(p)

        def laplacian(p):
            gp = jnp.pad(p, ((1, 1), (1, 1), (0, 0)), mode="wrap")
            lap = ((gp[2:, 1:-1] - 2 * gp[1:-1, 1:-1] + gp[:-2, 1:-1])
                   * grid.dx2i
                   + (gp[1:-1, 2:] - 2 * gp[1:-1, 1:-1] + gp[1:-1, :-2])
                   * grid.dy2i)
            # z with Neumann: flux zero at bottom/top faces
            dzfi = grid.dzfi[None, None, :]
            dzhi = grid.dzhi
            flux = (p[:, :, 1:] - p[:, :, :-1]) * dzhi[1:-1][None, None, :]
            zero = jnp.zeros_like(p[:, :, :1])
            flux = jnp.concatenate([zero, flux, zero], axis=2)
            lap += (flux[:, :, 1:] - flux[:, :, :-1]) * dzfi
            return lap

        rhs = laplacian(p)
        p_sol = pois.solve(rhs)
        # solution defined up to a constant in the zero mode
        p0 = p - jnp.mean(p)
        ps = p_sol - jnp.mean(p_sol)
        assert np.allclose(ps, p0, atol=1e-8), np.abs(ps - p0).max()

    def test_x3_preset_never_touches_f64(self, monkeypatch):
        """Forcing the bf16x3 transform preset must leave float64 solves
        at full-precision tolerances: `_mm` pins f64 (and complex)
        matmuls to Precision.HIGHEST regardless of UDALES_POIS_PREC
        (ops/poisson.py), so the f64 oracle suite stays bit-stable even
        where x3 is the platform default."""
        monkeypatch.setenv("UDALES_POIS_PREC", "x3")
        cfg = make_cfg()
        d = cfg.domain
        grid = Grid.uniform(d.itot, d.jtot, d.ktot, d.xlen, d.ylen, 8.0,
                            dtype=np.float64)
        pois = PoissonSolver(grid, cfg)
        rng = np.random.default_rng(2)
        p = jnp.asarray(rng.standard_normal(grid.shape))
        p0 = p - jnp.mean(p)
        rhs = self._neumann_z_laplacian(grid, p0)
        # wrap-x Laplacian == per_x=True variant on this periodic cfg
        p_sol = pois.solve(rhs)
        ps = p_sol - jnp.mean(p_sol)
        assert np.allclose(ps, p0, atol=1e-8), np.abs(ps - p0).max()

    def _neumann_z_laplacian(self, grid, p, per_x=True):
        """Discrete Laplacian, periodic or Neumann x, periodic y, Neumann z."""
        if per_x:
            gp = jnp.pad(p, ((1, 1), (0, 0), (0, 0)), mode="wrap")
        else:
            gp = jnp.pad(p, ((1, 1), (0, 0), (0, 0)), mode="edge")
        lap = (gp[2:] - 2 * gp[1:-1] + gp[:-2]) * grid.dx2i
        gq = jnp.pad(p, ((0, 0), (1, 1), (0, 0)), mode="wrap")
        lap += (gq[:, 2:] - 2 * gq[:, 1:-1] + gq[:, :-2]) * grid.dy2i
        dzfi = grid.dzfi[None, None, :]
        flux = (p[:, :, 1:] - p[:, :, :-1]) * grid.dzhi[1:-1][None, None, :]
        zero = jnp.zeros_like(p[:, :, :1])
        flux = jnp.concatenate([zero, flux, zero], axis=2)
        return lap + (flux[:, :, 1:] - flux[:, :, :-1]) * dzfi

    def test_bczp2_laplacian_inverse(self):
        """BCzp=2 (z cosine transform, modpois.f90:556-591) must invert the
        same Neumann-z Laplacian on an equidistant grid."""
        cfg = make_cfg()
        cfg = dataclasses.replace(cfg,
                                  bc=dataclasses.replace(cfg.bc, BCzp=2))
        d = cfg.domain
        grid = Grid.uniform(d.itot, d.jtot, d.ktot, d.xlen, d.ylen, 8.0,
                            dtype=np.float64)
        pois = PoissonSolver(grid, cfg)
        assert pois.bczp2 and not pois.diag_z
        rng = np.random.default_rng(7)
        p = jnp.asarray(rng.standard_normal(grid.shape))
        p = p - jnp.mean(p)
        rhs = self._neumann_z_laplacian(grid, p)
        ps = pois.solve(rhs)
        ps = ps - jnp.mean(ps)
        assert np.allclose(ps, p, atol=1e-8), np.abs(ps - p).max()

    def test_bczp2_neumann_x(self):
        """BCzp=2 combined with a non-periodic (DCT) x direction."""
        from udales_jax.config import BC_PROFILE
        cfg = make_cfg()
        cfg = dataclasses.replace(
            cfg, bc=dataclasses.replace(cfg.bc, BCzp=2, BCxm=BC_PROFILE))
        d = cfg.domain
        grid = Grid.uniform(d.itot, d.jtot, d.ktot, d.xlen, d.ylen, 8.0,
                            dtype=np.float64)
        pois = PoissonSolver(grid, cfg)
        assert pois.bczp2 and not pois.per_x
        rng = np.random.default_rng(8)
        p = jnp.asarray(rng.standard_normal(grid.shape))
        p = p - jnp.mean(p)
        rhs = self._neumann_z_laplacian(grid, p, per_x=False)
        ps = pois.solve(rhs)
        ps = ps - jnp.mean(ps)
        assert np.allclose(ps, p, atol=1e-8), np.abs(ps - p).max()


class TestPoissonFFT3D:
    def test_periodic_laplacian_inverse(self):
        """POISS_FFT3D (modpois.f90:808-882) inverts the fully periodic
        discrete Laplacian."""
        import dataclasses
        from udales_jax.config import POISS_FFT3D
        cfg = make_cfg()
        cfg = dataclasses.replace(
            cfg, dynamics=dataclasses.replace(cfg.dynamics,
                                              ipoiss=POISS_FFT3D))
        d = cfg.domain
        grid = Grid.uniform(d.itot, d.jtot, d.ktot, d.xlen, d.ylen, 8.0,
                            dtype=np.float64)
        pois = PoissonSolver(grid, cfg)
        assert pois.fft3d
        rng = np.random.default_rng(5)
        p = jnp.asarray(rng.standard_normal(grid.shape))
        p = p - jnp.mean(p)

        def laplacian3(p):
            lap = jnp.zeros_like(p)
            for ax, ci in ((0, grid.dx2i), (1, grid.dy2i),
                           (2, float(grid.dzfi[0]) ** 2)):
                lap += (jnp.roll(p, -1, ax) - 2 * p + jnp.roll(p, 1, ax)) * ci
            return lap

        rhs = laplacian3(p)
        ps = pois.solve(rhs)
        ps = ps - jnp.mean(ps)
        assert np.allclose(ps, p, atol=1e-8), np.abs(ps - p).max()


class TestLqlnr:
    def test_newton_raphson_matches_analytic(self):
        """lqlnr NR iteration (modthermodynamics.f90:449-476) agrees with
        the all-or-nothing closed form away from the saturation boundary."""
        from udales_jax.ops.thermo import ql_sat_adjust
        rng = np.random.default_rng(7)
        thl = jnp.asarray(285.0 + 10 * rng.random((4, 4, 8)))
        pressure = jnp.full((4, 4, 8), 101325.0)
        exner = jnp.full((4, 4, 8), 1.0)
        # strongly sub-saturated: both give exactly zero
        qt_dry = jnp.full((4, 4, 8), 1e-4)
        assert np.all(np.asarray(
            ql_sat_adjust(thl, qt_dry, pressure, exner, True)) == 0.0)
        # super-saturated: both positive, close to each other
        qt_wet = jnp.full((4, 4, 8), 0.03)
        ql_nr = np.asarray(ql_sat_adjust(thl, qt_wet, pressure, exner, True))
        ql_an = np.asarray(ql_sat_adjust(thl, qt_wet, pressure, exner, False))
        assert (ql_nr > 0).all()
        # the exact NR solve condenses LESS than the linearized form (latent
        # heating raises T and qsat); they agree to O(ql^2)
        assert (ql_nr <= ql_an + 1e-12).all()
        assert np.allclose(ql_nr, ql_an, atol=5e-3), np.abs(ql_nr - ql_an).max()
        # just above saturation the two coincide tightly
        from udales_jax.config import const
        es = const.es0 * np.exp(const.at * (np.asarray(thl) - const.tmelt)
                                / (np.asarray(thl) - const.bt))
        qsat = const.ep * es / (101325.0 - (1.0 - const.ep) * es)
        qt_near = jnp.asarray(qsat + 5e-4)
        ql_nr2 = np.asarray(ql_sat_adjust(thl, qt_near, pressure, exner, True))
        ql_an2 = np.asarray(ql_sat_adjust(thl, qt_near, pressure, exner,
                                          False))
        assert (ql_nr2 > 0).all()
        assert np.allclose(ql_nr2, ql_an2, atol=5e-5)


class TestStep:
    def test_projection_divergence_free(self):
        model = make_model()
        state = init_state(model)
        state2 = jax.jit(model.step)(state)
        # divergence of the updated velocity field
        c = state2.c
        grid = model.grid
        gu = jnp.pad(c.u, ((0, 1), (0, 0), (0, 0)), mode="wrap")
        gv = jnp.pad(c.v, ((0, 0), (0, 1), (0, 0)), mode="wrap")
        div = ((gu[1:] - gu[:-1]) * grid.dxi
               + (gv[:, 1:] - gv[:, :-1]) * grid.dyi
               + (c.w[:, :, 1:] - c.w[:, :, :-1])
               * grid.dzfi[None, None, :])
        # rhs of projection is div(u)/rk3coef; tolerance scales with dt
        assert np.abs(div).max() < 1e-8, np.abs(div).max()

    def test_short_run_stable(self):
        model = make_model()
        state = init_state(model)
        final = jax.jit(lambda s: model.run(s, 10))(state)
        assert np.isfinite(np.asarray(final.c.u)).all()
        assert np.isfinite(np.asarray(final.c.w)).all()
        assert np.abs(np.asarray(final.c.u)).max() < 10.0

    def test_momentum_source_balance(self):
        """Uniform u=1 flow with dpdx forcing: domain-mean momentum change
        must equal dt*(dpdx - tau_wall/zsize) with the neutral log-law floor
        stress tau = (fkar/log(dz/2/z0))^2 * u^2 (dT=0 -> neutral)."""
        cfg = make_cfg(physics=PhysicsConfig())
        model = make_model(cfg)
        model.dpdxl = jnp.full(model.grid.ktot, -1e-4, jnp.float64)
        state = init_state(model, amp=0.0)
        s2 = jax.jit(model.step)(state)
        du = np.mean(np.asarray(s2.c.u)) - 1.0
        grid = model.grid
        ctm = (0.41 / np.log(0.5 * grid.dzf[0] / 0.01)) ** 2
        expected = float(s2.dt) * (1e-4 - ctm / grid.zh[-1])
        assert abs(du - expected) / abs(expected) < 0.01, (du, expected)

    def test_adaptive_dt(self):
        cfg = make_cfg(run=RunConfig(ladaptive=True, dtmax=5.0,
                                     lrandomize=False))
        model = make_model(cfg)
        state = init_state(model)
        s2 = jax.jit(model.step)(state)
        # CFL: dt*max(|u|/dx...) <= courant
        c = state.m
        grid = model.grid
        cour = np.asarray(jnp.max(
            jnp.abs(c.u) * grid.dxi + jnp.abs(c.v) * grid.dyi
            + jnp.abs(c.w[..., :grid.ktot])
            / grid.dzh[:grid.ktot][None, None, :]))
        assert float(s2.dt) <= 5.0
        assert float(s2.dt) * cour <= 1.5 * 1.001


class TestPoissonDiag:
    def test_diag_matches_thomas(self):
        """The uniform-z diagonal path equals the tridiagonal path up to an
        additive constant (the singular mean mode)."""
        cfg = make_cfg()
        d = cfg.domain
        grid = Grid.uniform(d.itot, d.jtot, d.ktot, d.xlen, d.ylen, 8.0,
                            dtype=np.float64)
        pois = PoissonSolver(grid, cfg)
        assert pois.diag_z
        rng = np.random.default_rng(7)
        rhs = jnp.asarray(rng.standard_normal(grid.shape))
        rhs = rhs - jnp.mean(rhs)  # compatible
        p_diag = pois.solve(rhs)
        pois.diag_z = False
        p_thom = pois.solve(rhs)
        dd = np.asarray(p_diag) - np.asarray(p_thom)
        assert np.abs(dd - dd.mean()).max() < 1e-8, np.abs(dd-dd.mean()).max()

    def test_stretched_uses_thomas(self):
        cfg = make_cfg()
        zf = np.cumsum(1.05 ** np.arange(8)) - 0.5 * 1.05 ** np.arange(8)
        grid = Grid(16, 12, 8, 16.0, 12.0, zf, dtype=np.float64)
        pois = PoissonSolver(grid, cfg)
        assert not pois.diag_z
