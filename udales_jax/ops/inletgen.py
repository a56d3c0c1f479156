"""Lund-1998 / Kong-2000 rescale-recycle turbulent inlet generator.

Full JAX port of the reference's `modinlet.f90` (2,511 LoC;
`inletgen:202` with temperature, `inletgennotemp:946` without): running
j-averaged means at the recycle plane, friction-velocity and thickness
based inner/outer rescaling (Ludwig-Tillmann utau ratio, gamma/lambda),
inner (z+ = utau z / nu) and outer (z/delta) interpolation with the
reference's extrapolation rules, tanh weight-function blending
(modinlet.f90:681-688, alpha=4, b=0.2), Heaviside damping of the
fluctuations above the boundary layer (initinlet:99-150), and the
mass-flux rescale (modinlet.f90:756-766).

Everything is a pure function of an :class:`InletGen` pytree carried in
``State.ig`` — the reference's module arrays (Urec/Uinl/Utav/u0inletbc...,
modinletdata.f90) become traced state; the z-coordinate bookkeeping
(loclow/locup searches, modinlet.f90:445-516) becomes vectorized
``searchsorted`` interpolation inside jit.

The legacy `iinletgen=2` store/replay path (modinlet.f90:860-944 plus
writeinletfile/readinletfile) is realised by recording the generated
planes host-side each step (`Simulation` writes `inletdata.<exp>.npz`)
and replaying them through the time-interpolating `openbc.Inlet`, which
subsumes the reference's substep-cadence bookkeeping."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config, const
from ..grid import Grid


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class InletGen:
    """Traced rescale-recycle state (modinletdata.f90 module arrays)."""
    Urec: Any    # (nz,)   running j-avg u at the recycle plane
    Wrec: Any    # (nz+1,) running j-avg w at irecy-1
    Trec: Any    # (nz,)   running j-avg thl at irecy-1
    Uinl: Any    # (nz,)   running j-avg u of the generated inlet plane
    Tinl: Any    # (nz,)
    Utav: Any    # (nx, nz) running j-avg u everywhere (displacement thickn.)
    utaui: Any   # scalar: friction velocity at the inlet
    ttaui: Any   # scalar: friction temperature at the inlet
    displ: Any   # (nx,) displacement thickness
    ddispdx: Any  # scalar: d(delta*)/dx (top-BC transpiration rate)
    u0: Any      # (ny, nz)   generated inlet planes
    v0: Any      # (ny, nz)
    w0: Any      # (ny, nz+1)
    t0: Any      # (ny, nz)


class InletGenParams:
    """Static (non-traced) parameters: target thicknesses, Heaviside and
    weight profiles, plane indices (initinlet, modinlet.f90:38-200)."""

    def __init__(self, cfg: Config, grid: Grid):
        nz = grid.ktot
        zf = np.asarray(grid.zf, np.float64)
        zh = np.asarray(grid.zh, np.float64)
        xf = np.asarray(grid.xf, np.float64)
        d = cfg.driver
        self.irecy = max(int(d.iplane), 1)          # u sampled here,
        self.irecym = self.irecy - 1                # v/w/thl at irecy-1
        self.di = d.di if d.di > 0 else 0.5 * float(zh[-1])
        self.dti = d.dti if d.dti > 0 else self.di
        self.inletav = cfg.physics.inletav if cfg.physics.inletav > 0 \
            else 20.0
        self.lfixinlet = d.lfixinlet
        self.lfixutauin = d.lfixutauin
        self.lwallfunc = d.lwallfunc
        self.luvolflowr = cfg.physics.luvolflowr
        self.Uinf = cfg.bc.Uinf
        self.thls = cfg.bc.thls if cfg.bc.thls > 0 else 288.0
        self.thl_top = cfg.bc.thl_top if cfg.bc.thl_top > 0 else self.thls
        self.ltempeq = cfg.physics.ltempeq

        def heaviside(z, dlt):
            # smoothed step down across [1.2 d - eps, 1.2 d + eps]
            # (initinlet:99-118, eps = d/4)
            eps = 0.25 * dlt
            pfi = z - 1.2 * dlt - eps
            h = 0.5 * (1.0 - pfi / eps - np.sin(np.pi * pfi / eps) / np.pi)
            return np.where(pfi < -eps, 1.0, np.where(pfi > eps, 0.0, h))

        self.heavif = heaviside(zf, self.di)
        self.heavih = heaviside(zh, self.di)
        self.heavit = heaviside(zf, self.dti)
        self.xfm = xf.mean()
        self.xf2m = (xf ** 2).mean()


# -- thickness functions (modinlet.f90:1464-1811) ---------------------------

def momentumthicknessexp(u, dzf):
    """momentumthicknessexp (modinlet.f90:1464-1484)."""
    r = u / u[-1]
    return jnp.sum((r - r * r) * dzf)


def enthalpythickness(t, u, dzf, thls):
    """enthalpythickness (modinlet.f90:1527-1565) with the reference's
    exact-zero regularizations."""
    thlsd = jnp.where(t[-1] == thls, thls - 1e-6, thls)
    eth = (u / u[-1]) * ((t - t[-1]) / (thlsd - t[-1])) * dzf
    s = jnp.sum(eth)
    return jnp.where(s == 0.0, 1e-6, s)


def blthicknesst(u, zf, zh0, crit):
    """blthicknesst (modinlet.f90:1691-1720): height where u first exceeds
    crit * u(top), linearly interpolated."""
    nz = u.shape[0]
    ucrit = crit * u[-1]
    above = u > ucrit
    k = jnp.argmax(above)                       # first True (0 if none)
    km = jnp.maximum(k - 1, 0)
    interp = zf[km] + (zf[k] - zf[km]) / (u[k] - u[km] + 1e-300) \
        * (ucrit - u[km])
    first = zh0 + (zf[0] - zh0) / (u[0] + 1e-300) * ucrit
    out = jnp.where(k == 0, first, interp)
    return jnp.where(jnp.any(above), out, zf[nz - 1])


def wallawinlet(utan, dx, visc):
    """Werner-Wengle wall law -> tau (modinlet.f90:1815-1854)."""
    aaa, bbb = 8.3, 0.1428571429
    dxi = 1.0 / dx
    c1 = 0.5 * (1.0 - bbb) * aaa ** ((1.0 + bbb) / (1.0 - bbb))
    c2 = (1.0 + bbb) / aaa
    c3 = aaa ** (2.0 / (1.0 - bbb))
    c4 = 2.0 / (1.0 + bbb)
    ua = jnp.abs(utan)
    utankr = 0.5 * visc * dxi * c3
    tausub = 2.0 * visc * ua * dxi
    taupow = (c1 * (visc * dxi) ** (1.0 + bbb)
              + (c2 * (visc * dxi) ** bbb) * ua) ** c4
    tau = jnp.where(utankr - ua >= 0, tausub, taupow)
    return jnp.sign(utan) * tau


# -- inner/outer interpolation (modinlet.f90:445-649) -----------------------

def _interp_profile(src_z, src_v, tgt_z, bottom0, top_v):
    """Reference interpolation with its extrapolation rules: below the
    first source point, linear from `bottom0` at z=0; above the last,
    constant `top_v`."""
    n = src_z.shape[0]
    idx = jnp.searchsorted(src_z, tgt_z, side="left")
    lo = jnp.clip(idx - 1, 0, n - 1)
    hi = jnp.clip(idx, 0, n - 1)
    den = src_z[hi] - src_z[lo]
    frac = (tgt_z - src_z[lo]) / jnp.where(den == 0, 1.0, den)
    val = src_v[lo] + frac * (src_v[hi] - src_v[lo])
    val = jnp.where(idx == 0,
                    bottom0 + (src_v[0] - bottom0) / src_z[0] * tgt_z, val)
    return jnp.where(idx >= n, top_v, val)


def _interp_plane(src_z, src_v, tgt_z, bottom_scale, top_v):
    """Same lookup for fluctuation planes (ny, nz*): below the first source
    level the fluctuation scales linearly to 0 at z=0; above the last it is
    `top_v` (0 inner, 0 outer)."""
    n = src_z.shape[0]
    idx = jnp.searchsorted(src_z, tgt_z, side="left")
    lo = jnp.clip(idx - 1, 0, n - 1)
    hi = jnp.clip(idx, 0, n - 1)
    den = src_z[hi] - src_z[lo]
    frac = ((tgt_z - src_z[lo]) / jnp.where(den == 0, 1.0, den))[None, :]
    val = src_v[:, lo] + frac * (src_v[:, hi] - src_v[:, lo])
    val = jnp.where((idx == 0)[None, :],
                    src_v[:, :1] / src_z[0] * tgt_z[None, :], val)
    return jnp.where((idx >= n)[None, :], top_v, val)


def init_inletgen(cfg: Config, grid: Grid, f, params: InletGenParams) \
        -> InletGen:
    """Initial inlet-generator state from the initial fields
    (modstartup.f90:1351-1443)."""
    dt = f.u.dtype
    ir, irm = params.irecy, params.irecym
    Urec = f.u[ir].mean(axis=0)
    Wrec = f.w[irm].mean(axis=0)
    Trec = f.thl[irm].mean(axis=0)
    Uinl = f.u[0].mean(axis=0)
    Tinl = f.thl[0].mean(axis=0)
    Utav = f.u.mean(axis=1)
    numol = const.numol
    tau = wallawinlet(Uinl[0], grid.dzf[0], numol)
    utaui = jnp.sqrt(jnp.abs(tau))
    q0 = numol * const.prandtlmoli * 2.0 * (Tinl[0] - params.thls) \
        / grid.dzf[0]
    ttaui = q0 / jnp.maximum(utaui, 1e-10)
    ny = f.u.shape[1]
    nz = grid.ktot
    return InletGen(
        Urec=Urec, Wrec=Wrec, Trec=Trec, Uinl=Uinl, Tinl=Tinl, Utav=Utav,
        utaui=utaui.astype(dt), ttaui=ttaui.astype(dt),
        displ=jnp.zeros(grid.itot, dt), ddispdx=jnp.zeros((), dt),
        u0=jnp.broadcast_to(Uinl[None, :], (ny, nz)).astype(dt),
        v0=jnp.zeros((ny, nz), dt),
        w0=jnp.zeros((ny, nz + 1), dt),
        t0=jnp.broadcast_to(Tinl[None, :], (ny, nz)).astype(dt))


def inletgen_update(ig: InletGen, c, cfg: Config, grid: Grid,
                    dt, rk3step: int, params: InletGenParams) -> InletGen:
    """One substep of the generator (inletgen, modinlet.f90:202-944).

    `c` holds the current substep fields; `rk3step` is static (1|2|3)."""
    p = params
    f64 = jnp.float64 if c.u.dtype == jnp.float64 else jnp.float32
    zf = jnp.asarray(grid.zf, f64)
    zh = jnp.asarray(grid.zh, f64)
    dzf = jnp.asarray(grid.dzf, f64)
    nz = grid.ktot
    numol = const.numol
    rk3coef = dt / (4.0 - rk3step)
    # effective time advanced by this substep (modinlet.f90:265-273)
    deltat = {1: rk3coef, 2: rk3coef - dt / 3.0, 3: rk3coef - dt / 2.0}[rk3step]
    avi = deltat / p.inletav
    ir, irm = p.irecy, p.irecym

    # running means at the recycle plane (modinlet.f90:283-313)
    urav = c.u[ir].mean(axis=0)
    wrav = c.w[irm].mean(axis=0)
    trav = c.thl[irm].mean(axis=0)
    Urec = urav * avi + (1.0 - avi) * ig.Urec
    Wrec = wrav * avi + (1.0 - avi) * ig.Wrec
    Trec = trav * avi + (1.0 - avi) * ig.Trec
    Utav = c.u.mean(axis=1) * avi + (1.0 - avi) * ig.Utav

    # fluctuations at the recycle plane (modinlet.f90:346-361)
    uprec = c.u[ir] - Urec[None, :]
    vprec = c.v[irm]
    wprec = c.w[irm] - Wrec[None, :]
    tprec = c.thl[irm] - Trec[None, :]

    # recycle-plane friction scales (modinlet.f90:364-377)
    if p.lwallfunc:
        utaur2 = wallawinlet(Urec[0], dzf[0], numol)
    else:
        utaur2 = 2.0 * numol * Urec[0] / dzf[0]
    utaur = jnp.sqrt(jnp.abs(utaur2))
    q0 = numol * const.prandtlmoli * 2.0 * (Trec[0] - p.thls) / dzf[0]
    ttaur = q0 / jnp.maximum(utaur, 1e-10)
    ttaur = jnp.where(ttaur == 0.0, 1e-7, ttaur)

    # thicknesses (modinlet.f90:380-416)
    dr = blthicknesst(Urec, zf, zh[0], 0.99)
    dtr = blthicknesst(Trec - p.thls, zf, zh[0], 0.99)
    thetai = momentumthicknessexp(ig.Uinl, dzf)
    thetar = momentumthicknessexp(Urec, dzf)
    thetati = enthalpythickness(ig.Tinl, ig.Uinl, dzf, p.thls)
    thetatr = enthalpythickness(Trec, Urec, dzf, p.thls)
    thetati = jnp.where(thetati == 0.0, 1e-7, thetati)

    # Ludwig-Tillmann-like utau ratio (modinlet.f90:418-434)
    utaui = ig.utaui if p.lfixutauin else \
        utaur * jnp.abs(thetar / thetai) ** 0.125
    ttaui = ttaur * jnp.abs(thetatr / thetati) ** 0.125
    gamm = utaui / jnp.maximum(utaur, 1e-10)
    lamb = ttaui / ttaur

    # inner / outer coordinates (modinlet.f90:436-443)
    zirf = utaur * zf / numol
    zirh = utaur * zh / numol
    ziif = utaui * zf / numol
    ziih = utaui * zh / numol
    zorf = zf / dr
    zorh = zh / dr
    zoif = zf / p.di
    zoih = zh / p.di
    zotr = zf / dtr
    zoti = zf / p.dti

    # inner interpolation + rescale (modinlet.f90:516-583, 652-658)
    Uinli = gamm * _interp_profile(zirf, Urec, ziif, 0.0, Urec[-1])
    Tinli = lamb * _interp_profile(zirf, Trec, ziif, p.thls, Trec[-1]) \
        + (1.0 - lamb) * p.thls
    Winli = _interp_profile(zirh, Wrec, ziih, 0.0, Wrec[-1]).at[0].set(0.0)
    upinli = gamm * _interp_plane(zirf, uprec, ziif, 0.0, 0.0)
    vpinli = gamm * _interp_plane(zirf, vprec, ziif, 0.0, 0.0)
    tpinli = lamb * _interp_plane(zirf, tprec, ziif, 0.0, 0.0)
    wpinli = gamm * _interp_plane(zirh, wprec, ziih, 0.0, 0.0)

    # outer interpolation + rescale (modinlet.f90:585-649, 659-668)
    Uinlo = gamm * _interp_profile(zorf, Urec, zoif, 0.0, p.Uinf) \
        + (1.0 - gamm) * p.Uinf
    Tinlo = lamb * _interp_profile(zotr, Trec, zoti, p.thls, p.thl_top) \
        + (1.0 - lamb) * p.thl_top
    Winlo = _interp_profile(zorh, Wrec, zoih, 0.0, Wrec[-1]).at[0].set(0.0)
    upinlo = gamm * _interp_plane(zorf, uprec, zoif, 0.0, 0.0)
    vpinlo = gamm * _interp_plane(zorf, vprec, zoif, 0.0, 0.0)
    tpinlo = lamb * _interp_plane(zotr, tprec, zoti, 0.0, 0.0)
    wpinlo = gamm * _interp_plane(zorh, wprec, zoih, 0.0, 0.0)

    # tanh weight function, alpha=4 b=0.2 (modinlet.f90:681-702)
    alpha, beta = 4.0, 0.2
    wfn = lambda zo: jnp.minimum(0.5 * (
        1.0 + jnp.tanh(alpha * (zo - beta) / ((1.0 - 2.0 * beta) * zo
                                              + beta)) / np.tanh(alpha)), 1.0)
    wff, wfh, wft = wfn(zoif), wfn(zoih), wfn(zoti)

    # blended inlet planes with Heaviside-damped fluctuations
    # (modinlet.f90:706-725)
    hf = jnp.asarray(p.heavif, f64)[None, :]
    hh = jnp.asarray(p.heavih, f64)[None, :]
    ht = jnp.asarray(p.heavit, f64)[None, :]
    u0 = (Uinli[None, :] + upinli * hf) * (1.0 - wff[None, :]) \
        + (Uinlo[None, :] + upinlo * hf) * wff[None, :]
    v0 = vpinli * hf * (1.0 - wff[None, :]) + vpinlo * hf * wff[None, :]
    t0 = (Tinli[None, :] + tpinli * ht) * (1.0 - wft[None, :]) \
        + (Tinlo[None, :] + tpinlo * ht) * wft[None, :]
    w0 = (Winli[None, :] + wpinli * hh) * (1.0 - wfh[None, :]) \
        + (Winlo[None, :] + wpinlo * hh) * wfh[None, :]
    w0 = w0.at[:, 0].set(0.0).at[:, -1].set(0.0)

    # mass-flux rescale (modinlet.f90:740-766, luvolflowr)
    urav_new = u0.mean(axis=0)
    zsize = zh[-1] - zh[0]
    totalu = jnp.sum(urav_new * dzf) / zsize
    if p.luvolflowr:
        totaluinl = jnp.sum(ig.Uinl * dzf) / zsize
        scalef = totaluinl / jnp.where(totalu == 0, 1.0, totalu)
        u0 = u0 * scalef
        urav_new = urav_new * scalef

    # running j+time-averaged inlet profiles (modinlet.f90:790-800)
    Uinl = ig.Uinl if p.lfixinlet else \
        urav_new * avi + (1.0 - avi) * ig.Uinl
    Tinl = t0.mean(axis=0) * avi + (1.0 - avi) * ig.Tinl

    # displacement thickness + its x-slope (dispthicknessexp,
    # modinlet.f90:1569-1601) — drives the top-BC transpiration
    dth = (1.0 - Utav / Utav[:, -1:]) * dzf[None, :]
    displ = jnp.sum(dth, axis=1)
    dispm = displ.mean()
    xfdispm = (jnp.asarray(grid.xf, f64) * displ).mean()
    ddispdx = (xfdispm - p.xfm * dispm) / (p.xf2m - p.xfm ** 2)

    dt_ = c.u.dtype
    if not p.ltempeq:
        # inletgennotemp (modinlet.f90:946-1462): temperature untouched
        Trec, Tinl, t0 = ig.Trec, ig.Tinl, ig.t0
        ttaui = ig.ttaui
    return InletGen(
        Urec=Urec.astype(dt_), Wrec=Wrec.astype(dt_), Trec=Trec.astype(dt_),
        Uinl=Uinl.astype(dt_), Tinl=Tinl.astype(dt_), Utav=Utav.astype(dt_),
        utaui=utaui.astype(dt_), ttaui=jnp.asarray(ttaui, dt_),
        displ=displ.astype(dt_), ddispdx=ddispdx.astype(dt_),
        u0=u0.astype(dt_), v0=v0.astype(dt_), w0=w0.astype(dt_),
        t0=jnp.asarray(t0, dt_))


def inletgen_planes(ig: InletGen, inlet, ny: int, nz: int):
    """Planes dict for the x-inlet BC machinery (xmi_driver analogue):
    generated u/v/w/thl plus profile qt/e12/sv from the `Inlet` profiles."""
    b = lambda prof: jnp.broadcast_to(prof[None, :], (ny, nz))
    sv = (jnp.broadcast_to(inlet.svprof[:, None, :],
                           (inlet.svprof.shape[0], ny, nz))
          if inlet is not None and inlet.svprof is not None
          and inlet.svprof.shape[0] else
          jnp.zeros((0, ny, nz), ig.u0.dtype))
    return dict(u=ig.u0, v=ig.v0, w=ig.w0, thl=ig.t0,
                qt=b(inlet.qtprof) if inlet is not None
                else jnp.zeros((ny, nz), ig.u0.dtype),
                e12=b(inlet.e12prof) if inlet is not None
                else jnp.zeros((ny, nz), ig.u0.dtype),
                sv=sv)
