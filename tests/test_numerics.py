"""Analytic unit oracles for the hot-path numerics.

Direct value/convergence tests of the advection schemes, the flux limiter,
the SGS closures and the diffusion stencils — independent of the end-to-end
trend tests.  Strategy:

  - translation/product-flux oracles with exact continuum tendencies and
    measured spatial convergence orders (cd2 -> 2, upwind -> 1, kappa -> ~2
    away from extrema / >=1 in L1 with the limiter active),
  - limiter-branch oracle for rlim (modadvection.f90:410-421) covering all
    four phir branches,
  - positivity/boundedness of the kappa scheme on a step profile (the
    property the reference forces kappa for scalars for,
    modglobal.f90:556-560) with a cd2 contrast run that DOES undershoot,
  - loop-based numpy re-implementations (independent indexing style) of the
    Vreman closure (modsubgrid.f90:269-330) and the Smagorinsky strain2
    (modsubgrid.f90:235-255), evaluated on random ghosted fields,
  - closed-form closure values for canonical flows: Vreman vanishes for
    pure shear and solid-body rotation and equals c*dx*dy*S^2/sqrt(2*S^2)
    for plane strain; Smagorinsky gives (cs*delta)^2 * 2|S| for plane
    strain,
  - TKE source-term formula oracle (modsubgrid.f90:415-538),
  - constant-coefficient diffusion stencils vs the analytic Laplacian
    (divergence-free field) at 2nd order.

Ghost convention: interior stencils are tested with analytic ghost fill
(periodic wrap in x/y, analytic continuation in z), which isolates the
stencil from the BC assembly (covered by test_core / test_openxy).
"""
import dataclasses
import math
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

from udales_jax.config import (Config, DomainConfig, PhysicsConfig, RunConfig,
                               SubgridConfig, SGS_SMAGORINSKY, SGS_VREMAN,
                               const)
from udales_jax.grid import Grid
from udales_jax.ops import advection as adv
from udales_jax.ops import subgrid as sg
from udales_jax.ops.advection import _rlim

# ---------------------------------------------------------------------------
# analytic-field helpers
# ---------------------------------------------------------------------------


def _grid(n, nz=None, L=1.0, H=1.0):
    nz = nz or n
    return Grid.uniform(n, n, nz, L, L, H, dtype=np.float64)


def _coords(grid):
    nx, ny, nz = grid.shape
    dx, dy = grid.dx, grid.dy
    dz = grid.dzf[0]
    xc = (np.arange(nx) + 0.5) * dx
    yc = (np.arange(ny) + 0.5) * dy
    zc = (np.arange(nz) + 0.5) * dz
    xu = np.arange(nx) * dx          # u-point i at x = i*dx
    yv = np.arange(ny) * dy
    zw = np.arange(nz + 1) * dz      # w faces 0..nz
    return xc, yc, zc, xu, yv, zw


def _eval(fn, x, y, z):
    X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
    return fn(X, Y, Z)


def _ghost_cell(fn, grid, h=1, hk=1):
    """Ghosted cell-centred array: wrap ghosts in x/y, analytic z ghosts."""
    nx, ny, nz = grid.shape
    dx, dy = grid.dx, grid.dy
    dz = grid.dzf[0]
    x = (np.arange(-h, nx + h) % nx + 0.5) * dx   # periodic fill
    y = (np.arange(-h, ny + h) % ny + 0.5) * dy
    z = (np.arange(-hk, nz + hk) + 0.5) * dz      # analytic continuation
    return jnp.asarray(_eval(fn, x, y, z))


def _ghost_u(fn, grid, h=1):
    nx, ny, nz = grid.shape
    dx, dy = grid.dx, grid.dy
    dz = grid.dzf[0]
    x = (np.arange(-h, nx + h) % nx) * dx
    y = (np.arange(-h, ny + h) % ny + 0.5) * dy
    z = (np.arange(-1, nz + 1) + 0.5) * dz
    return jnp.asarray(_eval(fn, x, y, z))


def _ghost_v(fn, grid, h=1):
    nx, ny, nz = grid.shape
    dx, dy = grid.dx, grid.dy
    dz = grid.dzf[0]
    x = (np.arange(-h, nx + h) % nx + 0.5) * dx
    y = (np.arange(-h, ny + h) % ny) * dy
    z = (np.arange(-1, nz + 1) + 0.5) * dz
    return jnp.asarray(_eval(fn, x, y, z))


def _ghost_w(fn, grid, h=1):
    """w face array, faces 0..nz, no k ghosts."""
    nx, ny, nz = grid.shape
    dx, dy = grid.dx, grid.dy
    dz = grid.dzf[0]
    x = (np.arange(-h, nx + h) % nx + 0.5) * dx
    y = (np.arange(-h, ny + h) % ny + 0.5) * dy
    z = np.arange(nz + 1) * dz
    return jnp.asarray(_eval(fn, x, y, z))


def _pd(f, axis, h=1e-6):
    """Numerical partial derivative of an analytic field fn(x,y,z) -> field
    evaluated pointwise; f takes (x, y, z) arrays."""
    def d(x, y, z):
        if axis == 0:
            return (f(x + h, y, z) - f(x - h, y, z)) / (2 * h)
        if axis == 1:
            return (f(x, y + h, z) - f(x, y - h, z)) / (2 * h)
        return (f(x, y, z + h) - f(x, y, z - h)) / (2 * h)
    return d


def _orders(errs):
    return [math.log2(errs[i] / errs[i + 1]) for i in range(len(errs) - 1)]


# ---------------------------------------------------------------------------
# rlim limiter branches (modadvection.f90:410-421)
# ---------------------------------------------------------------------------

class TestRlim:
    def _ref(self, d1, d2, eps1=1e-10):
        ri = (d2 + eps1) / (d1 + eps1)
        phir = max(0.0, min(2.0 * ri, min(1.0 / 3.0 + 2.0 / 3.0 * ri, 2.0)))
        return 0.5 * phir * d1

    def test_branches(self):
        # r < 0 (opposite-sign slopes): phir = 0
        # 0 < r < 1/4: phir = 2r          (2r < 1/3 + 2r/3  <=>  r < 1/4)
        # 1/4 < r < 5/2: phir = 1/3+2r/3  (1/3 + 2r/3 < 2   <=>  r < 5/2)
        # r > 5/2: phir = 2
        cases = [
            (1.0, -0.5),    # r<0 -> 0
            (1.0, 0.1),     # 2r branch
            (1.0, 1.0),     # middle branch, phir = 1
            (0.5, 4.0),     # phir = 2 branch
            (-1.0, -0.3),   # negative slopes
            (2.0, 0.5),     # middle branch
        ]
        for d1, d2 in cases:
            got = float(_rlim(jnp.float64(d1), jnp.float64(d2)))
            assert got == pytest.approx(self._ref(d1, d2), rel=1e-12), (d1, d2)

    def test_branch_values_exact(self):
        # pin each branch analytically (eps1 negligible at O(1) slopes)
        assert float(_rlim(jnp.float64(1.0), jnp.float64(-0.5))) == \
            pytest.approx(0.0, abs=1e-9)
        assert float(_rlim(jnp.float64(1.0), jnp.float64(0.1))) == \
            pytest.approx(0.5 * 2 * 0.1, rel=1e-7)          # 2r
        assert float(_rlim(jnp.float64(1.0), jnp.float64(1.0))) == \
            pytest.approx(0.5 * 1.0, rel=1e-7)              # 1/3 + 2/3
        assert float(_rlim(jnp.float64(0.5), jnp.float64(4.0))) == \
            pytest.approx(0.5 * 2 * 0.5, rel=1e-7)          # clipped at 2

    def test_vectorized_matches_scalar(self):
        rng = np.random.default_rng(3)
        d1 = rng.standard_normal(64)
        d2 = rng.standard_normal(64)
        got = np.asarray(_rlim(jnp.asarray(d1), jnp.asarray(d2)))
        want = np.array([self._ref(a, b) for a, b in zip(d1, d2)])
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------------
# scalar advection: translation oracles + convergence orders
# ---------------------------------------------------------------------------

def _scalar_tendency(scheme, grid, cfn, ufn, vfn, wfn):
    g = SimpleNamespace(u=_ghost_u(ufn, grid), v=_ghost_v(vfn, grid),
                        w=_ghost_w(wfn, grid))
    if scheme == "cd2":
        gc = _ghost_cell(cfn, grid, h=1, hk=1)
        return np.asarray(adv.adv_c2(gc, g, grid))
    gc = _ghost_cell(cfn, grid, h=2, hk=2)
    fn = adv.adv_kappa if scheme == "kappa" else adv.adv_upw
    return np.asarray(fn(gc, g, grid))


def _exact_flux_tend(cfn, ufn, vfn, wfn, grid):
    """-div(u c) at cell centres via tight central differences (1e-6,
    f64: truncation ~1e-12, far below any discretization error here)."""
    fx = lambda x, y, z: ufn(x, y, z) * cfn(x, y, z)
    fy = lambda x, y, z: vfn(x, y, z) * cfn(x, y, z)
    fz = lambda x, y, z: wfn(x, y, z) * cfn(x, y, z)
    xc, yc, zc, *_ = _coords(grid)
    return -(_eval(_pd(fx, 0), xc, yc, zc) + _eval(_pd(fy, 1), xc, yc, zc)
             + _eval(_pd(fz, 2), xc, yc, zc))


class TestScalarAdvectionOrder:
    U0, V0, W0 = 0.7, -0.4, 0.5

    def _errs(self, scheme, direction, norm):
        errs = []
        for n in (16, 32, 64):
            grid = _grid(n)
            if direction == "x":
                cfn = lambda x, y, z: 2.0 + np.sin(2 * np.pi * x)
                ufn = lambda x, y, z: self.U0 + 0 * x
                vfn = wfn = lambda x, y, z: 0 * x
            elif direction == "y":
                cfn = lambda x, y, z: 2.0 + np.cos(2 * np.pi * y)
                vfn = lambda x, y, z: self.V0 + 0 * x
                ufn = wfn = lambda x, y, z: 0 * x
            else:  # z, with w vanishing at the bottom/top faces
                cfn = lambda x, y, z: 2.0 + np.cos(np.pi * z)
                wfn = lambda x, y, z: self.W0 * np.sin(np.pi * z)
                ufn = vfn = lambda x, y, z: 0 * x
            got = _scalar_tendency(scheme, grid, cfn, ufn, vfn, wfn)
            want = _exact_flux_tend(cfn, ufn, vfn, wfn, grid)
            e = got - want
            if norm == "linf":
                errs.append(np.abs(e).max())
            else:
                errs.append(np.abs(e).mean())
        return errs

    @pytest.mark.parametrize("direction", ["x", "y", "z"])
    def test_cd2_second_order(self, direction):
        errs = self._errs("cd2", direction, "linf")
        orders = _orders(errs)
        assert min(orders) > 1.9, (errs, orders)
        assert max(orders) < 2.2, (errs, orders)

    @pytest.mark.parametrize("direction", ["x", "y", "z"])
    def test_upwind_first_order(self, direction):
        errs = self._errs("upw", direction, "linf")
        orders = _orders(errs)
        assert 0.8 < min(orders), (errs, orders)
        assert max(orders) < 1.3, (errs, orders)

    @pytest.mark.parametrize("direction", ["x", "y", "z"])
    def test_kappa_converges(self, direction):
        # the limiter clips at smooth extrema -> L1 order ~2 is the right
        # statement (Linf degrades locally at the extrema, as designed)
        errs = self._errs("kappa", direction, "l1")
        orders = _orders(errs)
        assert min(orders) > 1.5, (errs, orders)

    def test_kappa_beats_upwind(self):
        """On smooth data the limited kappa scheme must be far more accurate
        than first-order upwind (same inputs, same norm)."""
        ek = self._errs("kappa", "x", "l1")[-1]
        eu = self._errs("upw", "x", "l1")[-1]
        assert ek < eu / 8, (ek, eu)

    def test_uniform_field_zero_tendency(self):
        """A constant scalar in a divergence-free flow has zero tendency
        (discrete conservation/consistency) for every scheme."""
        grid = _grid(16)
        cfn = lambda x, y, z: 3.0 + 0 * x
        # divergence-free: u = sin(2 pi x) -> du/dx balanced by v
        ufn = lambda x, y, z: np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y)
        vfn = lambda x, y, z: -np.cos(2 * np.pi * x) * np.sin(2 * np.pi * y)
        wfn = lambda x, y, z: 0 * x
        for scheme in ("cd2", "kappa", "upw"):
            t = _scalar_tendency(scheme, grid, cfn, ufn, vfn, wfn)
            # discrete velocity divergence of the sampled field is O(h^2),
            # scaled by c=3; the tendency must be exactly -c * div_h(u)
            gu = SimpleNamespace(u=_ghost_u(ufn, grid), v=_ghost_v(vfn, grid),
                                 w=_ghost_w(wfn, grid))
            nx, ny, nz = grid.shape
            u = np.asarray(gu.u)[1:, 1:-1, 1:-1]
            v = np.asarray(gu.v)[1:-1, 1:, 1:-1]
            div = ((u[1:] - u[:-1]) * grid.dxi + (v[:, 1:] - v[:, :-1])
                   * grid.dyi)
            np.testing.assert_allclose(t, -3.0 * div, rtol=0, atol=1e-11)


class TestKappaPositivity:
    """The property the reference forces kappa for (modglobal.f90:556-560):
    advection of a non-negative step must stay within [min, max]."""

    def _advect_step(self, scheme, nsteps=256, cfl=0.25):
        n = 64
        grid = _grid(n, nz=4)
        dx = grid.dx
        u0 = 1.0
        dt = cfl * dx / u0
        c = np.zeros((n, n, 4))
        c[n // 4: n // 2] = 1.0   # sharp step in x
        ufn = lambda x, y, z: u0 + 0 * x
        zfn = lambda x, y, z: 0 * x
        g = SimpleNamespace(u=_ghost_u(ufn, grid), v=_ghost_v(zfn, grid),
                            w=_ghost_w(zfn, grid))

        def ghost(c, h, hk):
            gk = np.pad(c, ((h, h), (h, h), (0, 0)), mode="wrap")
            return jnp.asarray(np.pad(gk, ((0, 0), (0, 0), (hk, hk)),
                                      mode="edge"))

        c = jnp.asarray(c)
        for _ in range(nsteps):
            if scheme == "kappa":
                t = adv.adv_kappa(ghost(np.asarray(c), 2, 2), g, grid)
            elif scheme == "upw":
                t = adv.adv_upw(ghost(np.asarray(c), 2, 2), g, grid)
            else:
                t = adv.adv_c2(ghost(np.asarray(c), 1, 1), g, grid)
            c = c + dt * t
        return np.asarray(c)

    def test_kappa_positive_and_bounded(self):
        # tolerance: the limiter's eps1 = 1e-10 regularization admits
        # O(eps1)-scale excursions over many steps; a limiter bypass gives
        # O(1e-2) undershoot (see the cd2 contrast below)
        c = self._advect_step("kappa")
        assert c.min() >= -1e-9, c.min()
        assert c.max() <= 1.0 + 1e-9, c.max()

    def test_kappa_conserves_mass(self):
        c = self._advect_step("kappa", nsteps=64)
        assert float(c.sum()) == pytest.approx(64 * 64 * 4 / 4, rel=1e-12)

    def test_cd2_does_undershoot(self):
        """Contrast: central differencing on the same step DOES produce
        undershoots (Gibbs) — proves this test can catch a limiter bypass."""
        c = self._advect_step("cd2", nsteps=64)
        assert c.min() < -1e-3, c.min()

    def test_upwind_bounded(self):
        c = self._advect_step("upw")
        assert c.min() >= -1e-12 and c.max() <= 1.0 + 1e-12


# ---------------------------------------------------------------------------
# momentum advection convergence (modadvection.f90:158-314)
# ---------------------------------------------------------------------------

def _mom_fields():
    tp = 2 * np.pi
    ufn = lambda x, y, z: np.sin(tp * x) * np.cos(tp * y) * (1 + 0.5 * np.cos(np.pi * z))
    vfn = lambda x, y, z: np.cos(tp * x) * np.sin(tp * y) * (1 + 0.5 * np.sin(np.pi * z))
    wfn = lambda x, y, z: np.sin(tp * x) * np.sin(tp * y) * np.sin(np.pi * z)
    return ufn, vfn, wfn


class TestMomentumAdvectionOrder:
    def _ghosts(self, grid):
        ufn, vfn, wfn = _mom_fields()
        return SimpleNamespace(u=_ghost_u(ufn, grid), v=_ghost_v(vfn, grid),
                               w=_ghost_w(wfn, grid))

    def test_adv_u_order(self):
        ufn, vfn, wfn = _mom_fields()
        errs = []
        for n in (16, 32, 64):
            grid = _grid(n)
            got = np.asarray(adv.adv_u(self._ghosts(grid), grid))
            xc, yc, zc, xu, yv, zw = _coords(grid)
            fxx = lambda x, y, z: ufn(x, y, z) ** 2
            fxy = lambda x, y, z: vfn(x, y, z) * ufn(x, y, z)
            fxz = lambda x, y, z: wfn(x, y, z) * ufn(x, y, z)
            want = -(_eval(_pd(fxx, 0), xu, yc, zc)
                     + _eval(_pd(fxy, 1), xu, yc, zc)
                     + _eval(_pd(fxz, 2), xu, yc, zc))
            errs.append(np.abs(got - want).max())
        orders = _orders(errs)
        assert min(orders) > 1.85, (errs, orders)

    def test_adv_v_order(self):
        ufn, vfn, wfn = _mom_fields()
        errs = []
        for n in (16, 32, 64):
            grid = _grid(n)
            got = np.asarray(adv.adv_v(self._ghosts(grid), grid))
            xc, yc, zc, xu, yv, zw = _coords(grid)
            fyx = lambda x, y, z: ufn(x, y, z) * vfn(x, y, z)
            fyy = lambda x, y, z: vfn(x, y, z) ** 2
            fyz = lambda x, y, z: wfn(x, y, z) * vfn(x, y, z)
            want = -(_eval(_pd(fyx, 0), xc, yv, zc)
                     + _eval(_pd(fyy, 1), xc, yv, zc)
                     + _eval(_pd(fyz, 2), xc, yv, zc))
            errs.append(np.abs(got - want).max())
        orders = _orders(errs)
        assert min(orders) > 1.85, (errs, orders)

    def test_adv_w_order(self):
        ufn, vfn, wfn = _mom_fields()
        errs = []
        for n in (16, 32, 64):
            grid = _grid(n)
            got = np.asarray(adv.adv_w(self._ghosts(grid), grid))
            xc, yc, zc, xu, yv, zw = _coords(grid)
            fzx = lambda x, y, z: ufn(x, y, z) * wfn(x, y, z)
            fzy = lambda x, y, z: vfn(x, y, z) * wfn(x, y, z)
            fzz = lambda x, y, z: wfn(x, y, z) ** 2
            zin = zw[1:-1]   # interior faces only (bottom/top not advanced)
            want = -(_eval(_pd(fzx, 0), xc, yc, zin)
                     + _eval(_pd(fzy, 1), xc, yc, zin)
                     + _eval(_pd(fzz, 2), xc, yc, zin))
            errs.append(np.abs(got[:, :, 1:-1] - want).max())
        orders = _orders(errs)
        # pre-asymptotic at N=16; asymptotic order must be 2
        assert min(orders) > 1.75 and orders[-1] > 1.9, (errs, orders)


# ---------------------------------------------------------------------------
# SGS closures: loop-based numpy oracles + closed forms
# ---------------------------------------------------------------------------

def _cfg_sgs(model, **sub):
    dom = DomainConfig(itot=6, jtot=5, ktot=7, xlen=6 * 0.25, ylen=5 * 0.21)
    return Config(domain=dom, dtype="float64",
                  subgrid=SubgridConfig(model=model, **sub))


def _rand_ghosts(nx, ny, nz, seed=0):
    rng = np.random.default_rng(seed)
    gu = jnp.asarray(rng.standard_normal((nx + 2, ny + 2, nz + 2)))
    gv = jnp.asarray(rng.standard_normal((nx + 2, ny + 2, nz + 2)))
    gw = jnp.asarray(rng.standard_normal((nx + 2, ny + 2, nz + 1)))
    return SimpleNamespace(u=gu, v=gv, w=gw)


def _np_vreman_loop(g, grid, c_vreman):
    """Loop-based numpy Vreman (modsubgrid.f90:269-330), written against the
    Fortran index arithmetic directly (u0(i,j,k) == gu[i+1? ...]): here the
    ghosted array index (i, j, k) maps Fortran (i-1, j-1, k-1) with interior
    at 1..n."""
    nx, ny, nz = grid.shape
    u = np.asarray(g.u)
    v = np.asarray(g.v)
    w = np.asarray(g.w)   # faces: w[., ., k] is the face below cell k
    dxi, dyi = grid.dxi, grid.dyi
    dxiq, dyiq = grid.dxiq, grid.dyiq
    dzf = np.asarray(grid.j("dzf_g"))     # dzf_g[1+k] = dzf[k]
    dzhi = np.asarray(grid.j("dzhi"))     # dzhi[k] = 1/dzh at face k
    dzfi = np.asarray(grid.j("dzfi"))
    dzfiq = np.asarray(grid.j("dzfiq"))
    dx2, dy2 = grid.dx2, grid.dy2
    dzf2 = np.asarray(grid.j("dzf2"))
    ekm = np.zeros((nx, ny, nz))
    for k in range(nz):
        kg = k + 1                        # ghosted cell index
        for j in range(ny):
            jg = j + 1
            for i in range(nx):
                ig = i + 1
                a11 = (u[ig + 1, jg, kg] - u[ig, jg, kg]) * dxi
                a12 = (v[ig + 1, jg + 1, kg] + v[ig + 1, jg, kg]
                       - v[ig - 1, jg + 1, kg] - v[ig - 1, jg, kg]) * dxiq
                a13 = (w[ig + 1, jg, k + 1] + w[ig + 1, jg, k]
                       - w[ig - 1, jg, k + 1] - w[ig - 1, jg, k]) * dxiq
                a21 = (u[ig + 1, jg + 1, kg] + u[ig, jg + 1, kg]
                       - u[ig + 1, jg - 1, kg] - u[ig, jg - 1, kg]) * dyiq
                a22 = (v[ig, jg + 1, kg] - v[ig, jg, kg]) * dyi
                a23 = (w[ig, jg + 1, k + 1] + w[ig, jg + 1, k]
                       - w[ig, jg - 1, k + 1] - w[ig, jg - 1, k]) * dyiq
                a31 = (((u[ig + 1, jg, kg + 1] + u[ig, jg, kg + 1]) * dzf[kg]
                        + (u[ig + 1, jg, kg] + u[ig, jg, kg]) * dzf[kg + 1])
                       * dzhi[k + 1]
                       - ((u[ig + 1, jg, kg] + u[ig, jg, kg]) * dzf[kg - 1]
                          + (u[ig + 1, jg, kg - 1] + u[ig, jg, kg - 1])
                          * dzf[kg]) * dzhi[k]) * dzfiq[k]
                a32 = (((v[ig, jg + 1, kg + 1] + v[ig, jg, kg + 1]) * dzf[kg]
                        + (v[ig, jg + 1, kg] + v[ig, jg, kg]) * dzf[kg + 1])
                       * dzhi[k + 1]
                       - ((v[ig, jg + 1, kg] + v[ig, jg, kg]) * dzf[kg - 1]
                          + (v[ig, jg + 1, kg - 1] + v[ig, jg, kg - 1])
                          * dzf[kg]) * dzhi[k]) * dzfiq[k]
                a33 = (w[ig, jg, k + 1] - w[ig, jg, k]) * dzfi[k]
                aa = (a11 * a11 + a21 * a21 + a31 * a31 + a12 * a12
                      + a22 * a22 + a32 * a32 + a13 * a13 + a23 * a23
                      + a33 * a33)
                b11 = dx2 * a11 ** 2 + dy2 * a21 ** 2 + dzf2[k] * a31 ** 2
                b22 = dx2 * a12 ** 2 + dy2 * a22 ** 2 + dzf2[k] * a32 ** 2
                b12 = dx2 * a11 * a12 + dy2 * a21 * a22 + dzf2[k] * a31 * a32
                b33 = dx2 * a13 ** 2 + dy2 * a23 ** 2 + dzf2[k] * a33 ** 2
                b13 = dx2 * a11 * a13 + dy2 * a21 * a23 + dzf2[k] * a31 * a33
                b23 = dx2 * a12 * a13 + dy2 * a22 * a23 + dzf2[k] * a32 * a33
                bb = (b11 * b22 - b12 ** 2 + b11 * b33 - b13 ** 2
                      + b22 * b33 - b23 ** 2)
                ekm[i, j, k] = (0.0 if bb < 1e-8
                                else c_vreman * math.sqrt(bb / max(aa, 1e-30)))
    return ekm


def _np_strain2_loop(g, grid):
    """Loop-based numpy strain2 (modsubgrid.f90:235-255)."""
    nx, ny, nz = grid.shape
    u = np.asarray(g.u)
    v = np.asarray(g.v)
    w = np.asarray(g.w)
    dxi, dyi = grid.dxi, grid.dyi
    dzfi = np.asarray(grid.j("dzfi"))
    dzhi = np.asarray(grid.j("dzhi"))
    s2 = np.zeros((nx, ny, nz))
    for k in range(nz):
        kg = k + 1
        for j in range(ny):
            jg = j + 1
            for i in range(nx):
                ig = i + 1
                s = (((u[ig + 1, jg, kg] - u[ig, jg, kg]) * dxi) ** 2
                     + ((v[ig, jg + 1, kg] - v[ig, jg, kg]) * dyi) ** 2
                     + ((w[ig, jg, k + 1] - w[ig, jg, k]) * dzfi[k]) ** 2)
                s += 0.125 * (
                    ((w[ig, jg, k + 1] - w[ig - 1, jg, k + 1]) * dxi
                     + (u[ig, jg, kg + 1] - u[ig, jg, kg]) * dzhi[k + 1]) ** 2
                    + ((w[ig, jg, k] - w[ig - 1, jg, k]) * dxi
                       + (u[ig, jg, kg] - u[ig, jg, kg - 1]) * dzhi[k]) ** 2
                    + ((w[ig + 1, jg, k] - w[ig, jg, k]) * dxi
                       + (u[ig + 1, jg, kg] - u[ig + 1, jg, kg - 1])
                       * dzhi[k]) ** 2
                    + ((w[ig + 1, jg, k + 1] - w[ig, jg, k + 1]) * dxi
                       + (u[ig + 1, jg, kg + 1] - u[ig + 1, jg, kg])
                       * dzhi[k + 1]) ** 2)
                s += 0.125 * (
                    ((u[ig, jg + 1, kg] - u[ig, jg, kg]) * dyi
                     + (v[ig, jg + 1, kg] - v[ig - 1, jg + 1, kg]) * dxi) ** 2
                    + ((u[ig, jg, kg] - u[ig, jg - 1, kg]) * dyi
                       + (v[ig, jg, kg] - v[ig - 1, jg, kg]) * dxi) ** 2
                    + ((u[ig + 1, jg, kg] - u[ig + 1, jg - 1, kg]) * dyi
                       + (v[ig + 1, jg, kg] - v[ig, jg, kg]) * dxi) ** 2
                    + ((u[ig + 1, jg + 1, kg] - u[ig + 1, jg, kg]) * dyi
                       + (v[ig + 1, jg + 1, kg] - v[ig, jg + 1, kg])
                       * dxi) ** 2)
                s += 0.125 * (
                    ((v[ig, jg, kg + 1] - v[ig, jg, kg]) * dzhi[k + 1]
                     + (w[ig, jg, k + 1] - w[ig, jg - 1, k + 1]) * dyi) ** 2
                    + ((v[ig, jg, kg] - v[ig, jg, kg - 1]) * dzhi[k]
                       + (w[ig, jg, k] - w[ig, jg - 1, k]) * dyi) ** 2
                    + ((v[ig, jg + 1, kg] - v[ig, jg + 1, kg - 1]) * dzhi[k]
                       + (w[ig, jg + 1, k] - w[ig, jg, k]) * dyi) ** 2
                    + ((v[ig, jg + 1, kg + 1] - v[ig, jg + 1, kg])
                       * dzhi[k + 1]
                       + (w[ig, jg + 1, k + 1] - w[ig, jg, k + 1])
                       * dyi) ** 2)
                s2[i, j, k] = s
    return s2


class TestClosureOracles:
    def test_vreman_vs_numpy_loop(self):
        cfg = _cfg_sgs(SGS_VREMAN)
        d = cfg.domain
        grid = Grid.uniform(d.itot, d.jtot, d.ktot, d.xlen, d.ylen, 7 * 0.3,
                            dtype=np.float64)
        g = _rand_ghosts(*grid.shape, seed=7)
        ekm, ekh = sg.vreman_closure(g, grid, cfg)
        want = _np_vreman_loop(g, grid, cfg.subgrid.c_vreman)
        np.testing.assert_allclose(np.asarray(ekm) - const.numol, want,
                                   rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(
            np.asarray(ekh) - const.numol * const.prandtlmoli,
            want / cfg.subgrid.prandtl, rtol=1e-12, atol=1e-15)

    def test_vreman_stretched_grid(self):
        cfg = _cfg_sgs(SGS_VREMAN)
        d = cfg.domain
        zf = np.cumsum(1.12 ** np.arange(d.ktot)) * 0.2 \
            - 0.1 * 1.12 ** np.arange(d.ktot)
        grid = Grid(d.itot, d.jtot, d.ktot, d.xlen, d.ylen, zf,
                    dtype=np.float64)
        g = _rand_ghosts(*grid.shape, seed=11)
        ekm, _ = sg.vreman_closure(g, grid, cfg)
        want = _np_vreman_loop(g, grid, cfg.subgrid.c_vreman)
        np.testing.assert_allclose(np.asarray(ekm) - const.numol, want,
                                   rtol=1e-12, atol=1e-15)

    def test_strain2_vs_numpy_loop(self):
        cfg = _cfg_sgs(SGS_SMAGORINSKY)
        d = cfg.domain
        grid = Grid.uniform(d.itot, d.jtot, d.ktot, d.xlen, d.ylen, 7 * 0.3,
                            dtype=np.float64)
        g = _rand_ghosts(*grid.shape, seed=13)
        got = np.asarray(sg._strain2(g, grid))
        want = _np_strain2_loop(g, grid)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)

    def test_gradpack_strain2_matches_loop(self):
        """The packed strain2 (shared-edge evaluation) must equal the
        reference loop too (re-associated sums only)."""
        cfg = _cfg_sgs(SGS_SMAGORINSKY)
        d = cfg.domain
        grid = Grid.uniform(d.itot, d.jtot, d.ktot, d.xlen, d.ylen, 7 * 0.3,
                            dtype=np.float64)
        g = _rand_ghosts(*grid.shape, seed=17)
        pack = sg.compute_gradpack(g, grid)
        got = np.asarray(sg._strain2_pack(pack))
        want = _np_strain2_loop(g, grid)
        np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-14)

    # --- closed forms -----------------------------------------------------

    def _uniform_ghosts(self, grid, ufn, vfn, wfn):
        return SimpleNamespace(u=_ghost_u(ufn, grid), v=_ghost_v(vfn, grid),
                               w=_ghost_w(wfn, grid))

    def test_vreman_zero_for_pure_shear(self):
        """Vreman (2004) property: nu_t = 0 for a single-gradient flow
        (bb = 0 identically)."""
        cfg = _cfg_sgs(SGS_VREMAN)
        grid = _grid(8, L=1.0, H=1.0)
        S = 3.7
        g = self._uniform_ghosts(grid, lambda x, y, z: S * z,
                                 lambda x, y, z: 0 * x,
                                 lambda x, y, z: 0 * x)
        ekm, _ = sg.vreman_closure(g, grid, cfg)
        np.testing.assert_allclose(np.asarray(ekm), const.numol, rtol=1e-12)

    def test_vreman_zero_for_solid_body_rotation(self):
        cfg = _cfg_sgs(SGS_VREMAN)
        grid = _grid(8)
        Om = 2.1
        g = self._uniform_ghosts(grid, lambda x, y, z: -Om * (y - 0.5),
                                 lambda x, y, z: Om * (x - 0.5),
                                 lambda x, y, z: 0 * x)
        ekm, _ = sg.vreman_closure(g, grid, cfg)
        # a12 = Om, a21 = -Om: bb = b11 b22 - b12^2 + ... with
        # b12 = dx2*a11*a12 + dy2*a21*a22 = 0, b11 = dy2 Om^2, b22 = dx2 Om^2
        # -> bb = dx2 dy2 Om^4 > 0: Vreman does NOT vanish for rotation on
        # anisotropic beta; on THIS uniform dx=dy grid
        # bb = dx^4 Om^4, aa = 2 Om^2 -> nu_t = c dx^2 |Om| / sqrt(2)
        # (interior cells only: the linear field is not x/y-periodic, so
        # wrap-filled ghost cells poison the one-cell boundary ring)
        want = cfg.subgrid.c_vreman * grid.dx ** 2 * Om / math.sqrt(2.0)
        np.testing.assert_allclose(
            np.asarray(ekm)[1:-1, 1:-1] - const.numol, want, rtol=1e-9)

    def test_vreman_plane_strain_closed_form(self):
        """u = Sx, v = -Sy: nu_t = c * dx * dy * |S| / sqrt(2)."""
        cfg = _cfg_sgs(SGS_VREMAN)
        grid = _grid(8)
        S = 1.3
        g = self._uniform_ghosts(grid, lambda x, y, z: S * x,
                                 lambda x, y, z: -S * y,
                                 lambda x, y, z: 0 * x)
        ekm, _ = sg.vreman_closure(g, grid, cfg)
        want = cfg.subgrid.c_vreman * grid.dx * grid.dy * S / math.sqrt(2.0)
        np.testing.assert_allclose(
            np.asarray(ekm)[1:-1, 1:-1] - const.numol, want, rtol=1e-9)

    def test_smagorinsky_plane_strain_closed_form(self):
        """strain2 = S_ij S_ij = 2 S^2 -> ekm = (cs*delta)^2 * 2|S|."""
        cfg = _cfg_sgs(SGS_SMAGORINSKY, cs=0.17)
        grid = _grid(8)
        S = 0.9
        g = self._uniform_ghosts(grid, lambda x, y, z: S * x,
                                 lambda x, y, z: -S * y,
                                 lambda x, y, z: 0 * x)
        ekm, _ = sg.smagorinsky_closure(g, grid, cfg)
        delta = float(np.asarray(grid.j("delta"))[0])
        want = (0.17 * delta) ** 2 * 2.0 * S
        np.testing.assert_allclose(
            np.asarray(ekm)[1:-1, 1:-1] - const.numol, want, rtol=1e-9)

    def test_tke_sources_formula(self):
        """sbshr/sbbuo/sbdiss vs the scalar formulas
        (modsubgrid.f90:460-538) on a random state."""
        cfg = _cfg_sgs(SGS_VREMAN)   # model irrelevant; constants from cfg
        d = cfg.domain
        grid = Grid.uniform(d.itot, d.jtot, d.ktot, d.xlen, d.ylen, 7 * 0.3,
                            dtype=np.float64)
        g = _rand_ghosts(*grid.shape, seed=23)
        rng = np.random.default_rng(29)
        shape = grid.shape
        e12 = jnp.asarray(rng.uniform(0.01, 1.0, shape))
        ekm = jnp.asarray(rng.uniform(1e-4, 1e-2, shape))
        ekh = jnp.asarray(rng.uniform(1e-4, 1e-2, shape))
        dthvdz = jnp.asarray(rng.standard_normal(shape) * 0.01)
        zlt = jnp.asarray(rng.uniform(0.05, 0.3, shape))
        thvs = 290.0
        got = np.asarray(sg.tke_sources(g, grid, cfg, e12, ekm, ekh,
                                        dthvdz, zlt, thvs))
        cm, ch2, ce1, ce2, _ = sg.sgs_const.derived(
            cfg.subgrid.prandtl, cfg.subgrid.cf, cfg.subgrid.cn,
            cfg.subgrid.rigc)
        tdef2 = 2.0 * _np_strain2_loop(g, grid)
        e = np.maximum(np.asarray(e12), 1e-30)
        numolh = const.numol * const.prandtlmoli
        sbshr = (np.asarray(ekm) - const.numol) * tdef2 / (2 * e)
        sbbuo = -(np.asarray(ekh) - numolh) * const.grav / thvs \
            * np.asarray(dthvdz) / (2 * e)
        delta = np.asarray(grid.j("delta"))[None, None, :]
        sbdiss = -2.0 * (ce1 + ce2 * np.asarray(zlt) / delta) \
            * np.asarray(e12) ** 2 / (2 * np.asarray(zlt))
        want = sbshr + sbbuo + sbdiss
        want[:, :, 0] = 0.0   # lowest level handled by wall functions
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


# ---------------------------------------------------------------------------
# diffusion stencils: constant-coefficient Laplacian convergence
# ---------------------------------------------------------------------------

class TestDiffusionOrder:
    def test_diff_u_constant_ekm_laplacian(self):
        """With ekm = nu const and a divergence-free field,
        d/dxj(2 nu S1j) = nu * laplacian(u): 2nd-order convergence."""
        nu = 0.01
        tp = 2 * np.pi
        # divergence-free: (u, v, w) = curl of a vector potential
        ufn = lambda x, y, z: np.sin(tp * x) * np.cos(tp * y)
        vfn = lambda x, y, z: -np.cos(tp * x) * np.sin(tp * y)
        wfn = lambda x, y, z: 0 * x
        errs = []
        for n in (16, 32, 64):
            grid = _grid(n)
            g = SimpleNamespace(
                u=_ghost_u(ufn, grid), v=_ghost_v(vfn, grid),
                w=_ghost_w(wfn, grid),
                ekm=jnp.full((n + 2, n + 2, n + 2), nu, dtype=jnp.float64))
            got = np.asarray(sg.diff_u(g, grid))
            xc, yc, zc, xu, yv, zw = _coords(grid)
            lap = lambda x, y, z: -2 * tp ** 2 * ufn(x, y, z)
            want = nu * _eval(lap, xu, yc, zc)
            errs.append(np.abs(got - want).max())
        orders = _orders(errs)
        assert min(orders) > 1.9, (errs, orders)

    def test_diff_c_constant_ekh_laplacian(self):
        nu = 0.02
        tp = 2 * np.pi
        cfn = lambda x, y, z: np.sin(tp * x) * np.cos(tp * y) \
            * (2 + np.cos(np.pi * z))
        errs = []
        for n in (16, 32, 64):
            grid = _grid(n)
            gc = _ghost_cell(cfn, grid, h=1, hk=1)
            gekh = jnp.full((n + 2, n + 2, n + 2), nu, dtype=jnp.float64)
            got = np.asarray(sg.diff_c(gc, gekh, grid))
            xc, yc, zc, *_ = _coords(grid)
            lap = lambda x, y, z: (
                -2 * tp ** 2 * np.sin(tp * x) * np.cos(tp * y)
                * (2 + np.cos(np.pi * z))
                - np.pi ** 2 * np.sin(tp * x) * np.cos(tp * y)
                * np.cos(np.pi * z))
            want = nu * _eval(lap, xc, yc, zc)
            errs.append(np.abs(got - want).max())
        orders = _orders(errs)
        assert min(orders) > 1.9, (errs, orders)

    def test_fused_diffusion_matches_standalone(self):
        """fused flux-difference form == standalone diffu/diffv/diffw on a
        random state (f64 tight)."""
        grid = _grid(8, nz=6)
        rng = np.random.default_rng(31)
        g = SimpleNamespace(
            u=jnp.asarray(rng.standard_normal((10, 10, 8))),
            v=jnp.asarray(rng.standard_normal((10, 10, 8))),
            w=jnp.asarray(rng.standard_normal((10, 10, 7))),
            ekm=jnp.asarray(rng.uniform(1e-4, 1e-2, (10, 10, 8))))
        tu, tv, tw = sg.fused_diffusion(g, grid)
        np.testing.assert_allclose(np.asarray(tu), np.asarray(sg.diff_u(g, grid)),
                                   rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(np.asarray(tv), np.asarray(sg.diff_v(g, grid)),
                                   rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(np.asarray(tw), np.asarray(sg.diff_w(g, grid)),
                                   rtol=1e-12, atol=1e-14)
