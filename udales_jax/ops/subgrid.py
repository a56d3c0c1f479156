"""Subgrid-scale closure and diffusion.

Re-derivations of src/modsubgrid.f90:
  - Vreman (2004) closure (:269-360) with optional stable-stratification
    buoyancy correction (:332-354)
  - Smagorinsky (:208-264)
  - one-equation TKE (:363-400) + its source terms (`sources`, :415-538)
  - diffusion stencils diffu (:672), diffv (:778), diffw (:890), diffc (:540),
    diffe (:627)

Model constants follow modsubgriddata.f90 defaults and the initsubgrid
derivations (modsubgrid.f90:45-80).

Op-count design: the closure and the three momentum-diffusion sweeps can
share one set of *corner-located* strain primitives (`GradPack`, computed
once per substep).  The reference recomputes every velocity difference in
each of modsubgrid.f90's five loops; where a step is bound by arithmetic
rather than memory traffic that recomputation dominates, so here:

  - S12 = du/dy + dv/dx on xy-edges serves diffu's t_y, diffv's t_x, the
    Vreman a12/a21 (as 4-corner averages) and strain2, all exactly — the
    reference's corner brackets ARE these edge values (modsubgrid.f90:
    700-707 vs 806-813 vs 243-247).
  - likewise S13 (xz-edges) and S23 (yz-edges).
  - the corner-interpolated viscosities (empo/emmo/emop/emom families,
    modsubgrid.f90:683-698) collapse to three shared corner fields
    Exy/Exz/Eyz, and the *fluxes* F12 = Exy*S12 etc. are shared between
    the two sweeps that difference them.

Within-f32-ulp equivalent to the standalone stencils (addition order of
the 4-term averages differs); `tests/test_gradpack.py` pins the match.
"""
from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax.numpy as jnp

from ..config import SGS_DNS, SGS_ONEEQN, SGS_SMAGORINSKY, SGS_VREMAN, Config, const
from ..grid import Grid
from .stencil import kvec, sh, shw


class sgs_const:
    """Derived one-equation/Smagorinsky constants (modsubgrid.f90:62-79)."""
    alpha_kolm = 1.5
    cf = 2.5
    cn = 0.76
    Rigc = 0.25
    ch1 = 1.0
    dampmin = 1e-10

    @staticmethod
    def derived(prandtl: float, cf: float = 2.5, cn: float = 0.76,
                Rigc: float = 0.25):
        cm = cf / (2.0 * math.pi) * (1.5 * sgs_const.alpha_kolm) ** (-1.5)
        ch = prandtl
        ch2 = ch - sgs_const.ch1
        ceps = 2.0 * math.pi / cf * (1.5 * sgs_const.alpha_kolm) ** (-1.5)
        ce1 = (cn ** 2) * (cm / Rigc - sgs_const.ch1 * cm)
        ce2 = ceps - ce1
        return cm, ch2, ce1, ce2, ceps


def _gradients(g, grid: Grid):
    """Velocity-gradient tensor a_ij = du_j/dx_i at cell centres
    (modsubgrid.f90:281-305)."""
    nx, ny, nz = grid.shape
    S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
    Sw = partial(shw, nx=nx, ny=ny, nz=nz, h=1)
    u, v, w = g.u, g.v, g.w
    dxi, dyi = grid.dxi, grid.dyi
    dxiq, dyiq = grid.dxiq, grid.dyiq
    dzf = grid.j("dzf_g"); dzhi = grid.j("dzhi")
    dzf_k = kvec(dzf, 1, nz); dzf_kp = kvec(dzf, 2, nz); dzf_km = kvec(dzf, 0, nz)
    dzhi_k = kvec(dzhi, 0, nz); dzhi_kp = kvec(dzhi, 1, nz)
    dzfi_k = kvec(grid.j("dzfi"), 0, nz)
    dzfiq_k = kvec(grid.j("dzfiq"), 0, nz)

    a11 = (S(u, 1, 0, 0) - S(u, 0, 0, 0)) * dxi
    a12 = (S(v, 1, 1, 0) + S(v, 1, 0, 0) - S(v, -1, 1, 0) - S(v, -1, 0, 0)) * dxiq
    a13 = (Sw(w, 1, 0, 1) + Sw(w, 1, 0, 0) - Sw(w, -1, 0, 1) - Sw(w, -1, 0, 0)) * dxiq
    a21 = (S(u, 1, 1, 0) + S(u, 0, 1, 0) - S(u, 1, -1, 0) - S(u, 0, -1, 0)) * dyiq
    a22 = (S(v, 0, 1, 0) - S(v, 0, 0, 0)) * dyi
    a23 = (Sw(w, 0, 1, 1) + Sw(w, 0, 1, 0) - Sw(w, 0, -1, 1) - Sw(w, 0, -1, 0)) * dyiq
    a31 = (((S(u, 1, 0, 1) + S(u, 0, 0, 1)) * dzf_k
            + (S(u, 1, 0, 0) + S(u, 0, 0, 0)) * dzf_kp) * dzhi_kp
           - ((S(u, 1, 0, 0) + S(u, 0, 0, 0)) * dzf_km
              + (S(u, 1, 0, -1) + S(u, 0, 0, -1)) * dzf_k) * dzhi_k) * dzfiq_k
    a32 = (((S(v, 0, 1, 1) + S(v, 0, 0, 1)) * dzf_k
            + (S(v, 0, 1, 0) + S(v, 0, 0, 0)) * dzf_kp) * dzhi_kp
           - ((S(v, 0, 1, 0) + S(v, 0, 0, 0)) * dzf_km
              + (S(v, 0, 1, -1) + S(v, 0, 0, -1)) * dzf_k) * dzhi_k) * dzfiq_k
    a33 = (Sw(w, 0, 0, 1) - Sw(w, 0, 0, 0)) * dzfi_k
    return a11, a12, a13, a21, a22, a23, a31, a32, a33


class GradPack(NamedTuple):
    """Shared velocity-gradient primitives, computed once per substep.

    Corner index convention: corner index ``ci`` sits at ``x_{ci-1/2}``
    (the u-face of cell ``ci``), ``ci in [0, nx]``; same for ``cj``/``ck``
    (``ck`` is the w-face, so ``ck in [0, nz]``).
    """
    D11: jnp.ndarray   # (nx+1, ny, nz)   du/dx at centre ci-1,  ci=0..nx
    D22: jnp.ndarray   # (nx, ny+1, nz)   dv/dy at centre cj-1
    D33: jnp.ndarray   # (nx, ny, nz)     dw/dz at centres
    C12u: jnp.ndarray  # (nx+1, ny+1, nz) du/dy on xy-edges
    C12v: jnp.ndarray  # (nx+1, ny+1, nz) dv/dx on xy-edges
    S12: jnp.ndarray   # C12u + C12v
    C13u: jnp.ndarray  # (nx+1, ny, nz+1) du/dz on xz-edges
    C13w: jnp.ndarray  # (nx+1, ny, nz+1) dw/dx on xz-edges
    S13: jnp.ndarray
    C23v: jnp.ndarray  # (nx, ny+1, nz+1) dv/dz on yz-edges
    C23w: jnp.ndarray  # (nx, ny+1, nz+1) dw/dy on yz-edges
    S23: jnp.ndarray


def compute_gradpack(g, grid: Grid) -> GradPack:
    """All first differences of (u, v, w) used by closure + diffusion,
    each computed exactly once.  `g` carries h=1/hk=1 ghosted velocities
    (ops/boundary conventions; w has faces 0..nz)."""
    nx, ny, nz = grid.shape
    u, v, w = g.u, g.v, g.w
    dxi, dyi = grid.dxi, grid.dyi
    dzhi = grid.j("dzhi")
    dzhi_c = dzhi[: nz + 1][None, None, :]
    dzfi_k = kvec(grid.j("dzfi"), 0, nz)

    D11 = (u[1:, 1:1 + ny, 1:1 + nz] - u[:-1, 1:1 + ny, 1:1 + nz]) * dxi
    D22 = (v[1:1 + nx, 1:, 1:1 + nz] - v[1:1 + nx, :-1, 1:1 + nz]) * dyi
    D33 = (w[1:1 + nx, 1:1 + ny, 1:] - w[1:1 + nx, 1:1 + ny, :-1]) * dzfi_k

    C12u = (u[1:, 1:, 1:1 + nz] - u[1:, :-1, 1:1 + nz]) * dyi
    C12v = (v[1:, 1:, 1:1 + nz] - v[:-1, 1:, 1:1 + nz]) * dxi
    C13u = (u[1:, 1:1 + ny, 1:] - u[1:, 1:1 + ny, :-1]) * dzhi_c
    C13w = (w[1:, 1:1 + ny, :] - w[:-1, 1:1 + ny, :]) * dxi
    C23v = (v[1:1 + nx, 1:, 1:] - v[1:1 + nx, 1:, :-1]) * dzhi_c
    C23w = (w[1:1 + nx, 1:, :] - w[1:1 + nx, :-1, :]) * dyi
    return GradPack(D11, D22, D33, C12u, C12v, C12u + C12v,
                    C13u, C13w, C13u + C13w, C23v, C23w, C23v + C23w)


def _avg4xy(C):
    return 0.25 * (C[:-1, :-1] + C[1:, :-1] + C[:-1, 1:] + C[1:, 1:])


def _avg4xz(C):
    return 0.25 * (C[:-1, :, :-1] + C[1:, :, :-1] + C[:-1, :, 1:]
                   + C[1:, :, 1:])


def _avg4yz(C):
    return 0.25 * (C[:, :-1, :-1] + C[:, 1:, :-1] + C[:, :-1, 1:]
                   + C[:, 1:, 1:])


def _gradients_pack(pack: GradPack, g, grid: Grid):
    """Cell-centred velocity-gradient tensor from the shared pack
    (modsubgrid.f90:281-305).  a12/a13/a21/a23 are 4-corner averages of the
    edge derivatives (identical values, re-associated sum); a31/a32 keep the
    reference's dzf-weighted interface form which has no edge equivalent."""
    nx, ny, nz = grid.shape
    S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
    u, v = g.u, g.v
    dzf = grid.j("dzf_g")
    dzf_k = kvec(dzf, 1, nz); dzf_kp = kvec(dzf, 2, nz); dzf_km = kvec(dzf, 0, nz)
    dzhi = grid.j("dzhi")
    dzhi_k = kvec(dzhi, 0, nz); dzhi_kp = kvec(dzhi, 1, nz)
    dzfiq_k = kvec(grid.j("dzfiq"), 0, nz)

    a11 = pack.D11[1:]
    a22 = pack.D22[:, 1:]
    a33 = pack.D33
    a12 = _avg4xy(pack.C12v)
    a21 = _avg4xy(pack.C12u)
    a13 = _avg4xz(pack.C13w)
    a23 = _avg4yz(pack.C23w)
    a31 = (((S(u, 1, 0, 1) + S(u, 0, 0, 1)) * dzf_k
            + (S(u, 1, 0, 0) + S(u, 0, 0, 0)) * dzf_kp) * dzhi_kp
           - ((S(u, 1, 0, 0) + S(u, 0, 0, 0)) * dzf_km
              + (S(u, 1, 0, -1) + S(u, 0, 0, -1)) * dzf_k) * dzhi_k) * dzfiq_k
    a32 = (((S(v, 0, 1, 1) + S(v, 0, 0, 1)) * dzf_k
            + (S(v, 0, 1, 0) + S(v, 0, 0, 0)) * dzf_kp) * dzhi_kp
           - ((S(v, 0, 1, 0) + S(v, 0, 0, 0)) * dzf_km
              + (S(v, 0, 1, -1) + S(v, 0, 0, -1)) * dzf_k) * dzhi_k) * dzfiq_k
    return a11, a12, a13, a21, a22, a23, a31, a32, a33


def vreman_closure(g, grid: Grid, cfg: Config, dthvdz=None, thl=None,
                   pack: GradPack | None = None):
    """Vreman (2004) eddy viscosity (modsubgrid.f90:269-360)."""
    nz = grid.ktot
    if pack is None:
        a11, a12, a13, a21, a22, a23, a31, a32, a33 = _gradients(g, grid)
    else:
        a11, a12, a13, a21, a22, a23, a31, a32, a33 = \
            _gradients_pack(pack, g, grid)
    aa = (a11 * a11 + a21 * a21 + a31 * a31 + a12 * a12 + a22 * a22
          + a32 * a32 + a13 * a13 + a23 * a23 + a33 * a33)
    dx2, dy2 = grid.dx2, grid.dy2
    dzf2_k = kvec(grid.j("dzf2"), 0, nz)
    b11 = dx2 * a11 * a11 + dy2 * a21 * a21 + dzf2_k * a31 * a31
    b22 = dx2 * a12 * a12 + dy2 * a22 * a22 + dzf2_k * a32 * a32
    b12 = dx2 * a11 * a12 + dy2 * a21 * a22 + dzf2_k * a31 * a32
    b33 = dx2 * a13 * a13 + dy2 * a23 * a23 + dzf2_k * a33 * a33
    b13 = dx2 * a11 * a13 + dy2 * a21 * a23 + dzf2_k * a31 * a33
    b23 = dx2 * a12 * a13 + dy2 * a22 * a23 + dzf2_k * a32 * a33
    bb = (b11 * b22 - b12 * b12 + b11 * b33 - b13 * b13
          + b22 * b33 - b23 * b23)
    ekm = jnp.where(bb < 1e-8, 0.0,
                    cfg.subgrid.c_vreman * jnp.sqrt(bb / jnp.maximum(aa, 1e-30)))

    if cfg.physics.lbuoyancy and cfg.subgrid.lbuoycorr:
        # stable-stratification correction (modsubgrid.f90:332-354)
        nx, ny, _ = grid.shape
        S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
        u, v = g.u, g.v
        dzh = grid.j("dzh")
        denom = kvec(dzh, 1, nz) + kvec(dzh, 0, nz)
        du0dz = 0.5 * ((S(u, 0, 0, 1) + S(u, 1, 0, 1))
                       - (S(u, 0, 0, -1) + S(u, 1, 0, -1))) / denom
        dv0dz = 0.5 * ((S(v, 0, 0, 1) + S(v, 0, 1, 1))
                       - (S(v, 0, 0, -1) + S(v, 0, 1, -1))) / denom
        Rig = (const.grav / thl) * dthvdz / (du0dz ** 2 + dv0dz ** 2 + 1e-10)
        Rigc = cfg.subgrid.rigc
        ekm = ekm * jnp.sqrt(1.0 - jnp.clip(Rig, 0.0, Rigc) / Rigc)

    prandtli = 1.0 / cfg.subgrid.prandtl
    ekh = ekm * prandtli + const.numol * const.prandtlmoli
    ekm = ekm + const.numol
    return ekm, ekh


def _strain2(g, grid: Grid):
    """Squared strain rate with cross terms (modsubgrid.f90:235-255;
    the `sources` variant tdef2 = 2*strain2, :460-481)."""
    nx, ny, nz = grid.shape
    S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
    Sw = partial(shw, nx=nx, ny=ny, nz=nz, h=1)
    u, v, w = g.u, g.v, g.w
    dxi, dyi = grid.dxi, grid.dyi
    dzfi_k = kvec(grid.j("dzfi"), 0, nz)
    dzhi = grid.j("dzhi")
    dzhi_k = kvec(dzhi, 0, nz); dzhi_kp = kvec(dzhi, 1, nz)

    s2 = (((S(u, 1, 0, 0) - S(u, 0, 0, 0)) * dxi) ** 2
          + ((S(v, 0, 1, 0) - S(v, 0, 0, 0)) * dyi) ** 2
          + ((Sw(w, 0, 0, 1) - Sw(w, 0, 0, 0)) * dzfi_k) ** 2)
    s2 = s2 + 0.125 * (
        ((Sw(w, 0, 0, 1) - Sw(w, -1, 0, 1)) * dxi
         + (S(u, 0, 0, 1) - S(u, 0, 0, 0)) * dzhi_kp) ** 2
        + ((Sw(w, 0, 0, 0) - Sw(w, -1, 0, 0)) * dxi
           + (S(u, 0, 0, 0) - S(u, 0, 0, -1)) * dzhi_k) ** 2
        + ((Sw(w, 1, 0, 0) - Sw(w, 0, 0, 0)) * dxi
           + (S(u, 1, 0, 0) - S(u, 1, 0, -1)) * dzhi_k) ** 2
        + ((Sw(w, 1, 0, 1) - Sw(w, 0, 0, 1)) * dxi
           + (S(u, 1, 0, 1) - S(u, 1, 0, 0)) * dzhi_kp) ** 2)
    s2 = s2 + 0.125 * (
        ((S(u, 0, 1, 0) - S(u, 0, 0, 0)) * dyi
         + (S(v, 0, 1, 0) - S(v, -1, 1, 0)) * dxi) ** 2
        + ((S(u, 0, 0, 0) - S(u, 0, -1, 0)) * dyi
           + (S(v, 0, 0, 0) - S(v, -1, 0, 0)) * dxi) ** 2
        + ((S(u, 1, 0, 0) - S(u, 1, -1, 0)) * dyi
           + (S(v, 1, 0, 0) - S(v, 0, 0, 0)) * dxi) ** 2
        + ((S(u, 1, 1, 0) - S(u, 1, 0, 0)) * dyi
           + (S(v, 1, 1, 0) - S(v, 0, 1, 0)) * dxi) ** 2)
    s2 = s2 + 0.125 * (
        ((S(v, 0, 0, 1) - S(v, 0, 0, 0)) * dzhi_kp
         + (Sw(w, 0, 0, 1) - Sw(w, 0, -1, 1)) * dyi) ** 2
        + ((S(v, 0, 0, 0) - S(v, 0, 0, -1)) * dzhi_k
           + (Sw(w, 0, 0, 0) - Sw(w, 0, -1, 0)) * dyi) ** 2
        + ((S(v, 0, 1, 0) - S(v, 0, 1, -1)) * dzhi_k
           + (Sw(w, 0, 1, 0) - Sw(w, 0, 0, 0)) * dyi) ** 2
        + ((S(v, 0, 1, 1) - S(v, 0, 1, 0)) * dzhi_kp
           + (Sw(w, 0, 1, 1) - Sw(w, 0, 0, 1)) * dyi) ** 2)
    return s2


def _strain2_pack(pack: GradPack):
    """strain2 from the shared pack: the reference's corner brackets
    (modsubgrid.f90:235-255) are exactly the S1j edge values."""
    s2 = (pack.D11[1:] ** 2 + pack.D22[:, 1:] ** 2 + pack.D33 ** 2)
    sq = pack.S13 ** 2
    s2 = s2 + 0.125 * (sq[:-1, :, 1:] + sq[:-1, :, :-1]
                       + sq[1:, :, :-1] + sq[1:, :, 1:])
    sq = pack.S12 ** 2
    s2 = s2 + 0.125 * (sq[:-1, 1:] + sq[:-1, :-1] + sq[1:, :-1] + sq[1:, 1:])
    sq = pack.S23 ** 2
    s2 = s2 + 0.125 * (sq[:, :-1, 1:] + sq[:, :-1, :-1]
                       + sq[:, 1:, :-1] + sq[:, 1:, 1:])
    return s2


def smagorinsky_closure(g, grid: Grid, cfg: Config,
                        pack: GradPack | None = None):
    """(modsubgrid.f90:208-264). csz = (cm^3/ceps)^(1/4) unless cs given."""
    nz = grid.ktot
    cm, ch2, ce1, ce2, ceps = sgs_const.derived(
        cfg.subgrid.prandtl, cfg.subgrid.cf, cfg.subgrid.cn, cfg.subgrid.rigc)
    csz = (cm ** 3 / ceps) ** 0.25 if cfg.subgrid.cs == -1.0 else cfg.subgrid.cs
    mlen = csz * kvec(grid.j("delta"), 0, nz)
    s2 = _strain2(g, grid) if pack is None else _strain2_pack(pack)
    ekm = (mlen ** 2) * jnp.sqrt(2.0 * s2)
    prandtli = 1.0 / cfg.subgrid.prandtl
    ekh = ekm * prandtli + const.numol * const.prandtlmoli
    ekm = ekm + const.numol
    return ekm, ekh


def oneeqn_closure(g, grid: Grid, cfg: Config, e12, dthvdz, thvs):
    """One-equation TKE closure (modsubgrid.f90:363-400)."""
    nz = grid.ktot
    cm, ch2, ce1, ce2, _ = sgs_const.derived(
        cfg.subgrid.prandtl, cfg.subgrid.cf, cfg.subgrid.cn, cfg.subgrid.rigc)
    delta_k = jnp.broadcast_to(kvec(grid.j("delta"), 0, nz), e12.shape)
    stable = dthvdz > 0
    zlt_stable = jnp.minimum(
        delta_k,
        cfg.subgrid.cn * e12 / jnp.sqrt(
            const.grav / thvs * jnp.abs(dthvdz) + 1e-30))
    zlt = jnp.where(stable, zlt_stable, delta_k)
    ekm_t = cm * zlt * e12
    ekh_t = jnp.where(stable,
                      (sgs_const.ch1 + ch2 * zlt / delta_k) * ekm_t,
                      (sgs_const.ch1 + ch2) * ekm_t)
    ekm = ekm_t + const.numol
    ekh = ekh_t + const.numol * const.prandtlmoli
    return ekm, ekh, zlt


def closure(g, grid: Grid, cfg: Config, e12=None, dthvdz=None, thl=None,
            thvs=None, pack: GradPack | None = None):
    """Dispatch (modsubgrid.f90:159-412). Returns interior ekm, ekh (and zlt
    for the one-equation model, else None).  Pass `pack`
    (`compute_gradpack`) to share the velocity differences with the
    diffusion sweeps (`fused_diffusion`)."""
    model = cfg.subgrid.model
    if model == SGS_VREMAN:
        ekm, ekh = vreman_closure(g, grid, cfg, dthvdz, thl, pack=pack)
        return ekm, ekh, None
    if model == SGS_SMAGORINSKY:
        ekm, ekh = smagorinsky_closure(g, grid, cfg, pack=pack)
        return ekm, ekh, None
    if model == SGS_ONEEQN:
        return oneeqn_closure(g, grid, cfg, e12, dthvdz, thvs)
    # DNS: constant molecular coefficients
    nx, ny, nz = grid.shape
    ekm = jnp.full((nx, ny, nz), const.numol, grid.dtype)
    ekh = jnp.full((nx, ny, nz), const.numol * const.prandtlmoli, grid.dtype)
    return ekm, ekh, None


def tke_sources(g, grid: Grid, cfg: Config, e12, ekm, ekh, dthvdz, zlt, thvs,
                pack: GradPack | None = None):
    """Shear + buoyancy + dissipation sources of the e12 equation
    (modsubgrid.f90:415-538). Applied for k >= kb+1 only (wall functions
    handle the lowest level)."""
    nz = grid.ktot
    cm, ch2, ce1, ce2, _ = sgs_const.derived(
        cfg.subgrid.prandtl, cfg.subgrid.cf, cfg.subgrid.cn, cfg.subgrid.rigc)
    tdef2 = 2.0 * (_strain2(g, grid) if pack is None else _strain2_pack(pack))
    numolh = const.numol * const.prandtlmoli
    e12s = jnp.maximum(e12, 1e-30)
    sbshr = (ekm - const.numol) * tdef2 / (2.0 * e12s)
    sbbuo = -(ekh - numolh) * const.grav / thvs * dthvdz / (2.0 * e12s)
    delta_k = jnp.broadcast_to(kvec(grid.j("delta"), 0, nz), e12.shape)
    sbdiss = -2.0 * (ce1 + ce2 * zlt / delta_k) * e12 ** 2 / (2.0 * zlt)
    src = sbshr + sbbuo + sbdiss
    # zero out lowest level (reference loops k=kb+1..ke)
    mask = (jnp.arange(nz) >= 1)[None, None, :]
    return src * mask


# ---------------------------------------------------------------------------
# Diffusion stencils
# ---------------------------------------------------------------------------

def diff_u(g, grid: Grid, M=None):
    """d/dxj(2 Km S1j) at u-points (modsubgrid.f90:672-775, LES branch).

    `M` (optional): ghosted IBM fluid mask at u-points (ibm.pmask_u).
    When given, the u-normal-gradient component of each lateral/vertical
    flux is multiplied by the OPPOSITE point's mask — exactly the
    reference's diffu_corr subtraction (modibm.f90:990-1030) folded into
    the sweep: masking a flux term by {0,1} equals computing it and
    subtracting it, with zero extra passes (see ibm/ibm.py wallfun)."""
    nx, ny, nz = grid.shape
    S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
    Sw = partial(shw, nx=nx, ny=ny, nz=nz, h=1)
    u, v, w, ekm = g.u, g.v, g.w, g.ekm
    dxi, dyi = grid.dxi, grid.dyi
    dzf = grid.j("dzf_g")
    dzf_k = kvec(dzf, 1, nz); dzf_kp = kvec(dzf, 2, nz); dzf_km = kvec(dzf, 0, nz)
    dzhiq = grid.j("dzhiq"); dzhi = grid.j("dzhi")
    dzhiq_k = kvec(dzhiq, 0, nz); dzhiq_kp = kvec(dzhiq, 1, nz)
    dzhi_k = kvec(dzhi, 0, nz); dzhi_kp = kvec(dzhi, 1, nz)
    dzfi_k = kvec(grid.j("dzfi"), 0, nz)

    ekm_c = S(ekm, 0, 0, 0); ekm_im = S(ekm, -1, 0, 0)
    emom = (dzf_km * (ekm_c + ekm_im)
            + dzf_k * (S(ekm, 0, 0, -1) + S(ekm, -1, 0, -1))) * dzhiq_k
    emop = (dzf_kp * (ekm_c + ekm_im)
            + dzf_k * (S(ekm, 0, 0, 1) + S(ekm, -1, 0, 1))) * dzhiq_kp
    empo = 0.25 * (ekm_c + S(ekm, 0, 1, 0) + S(ekm, -1, 0, 0) + S(ekm, -1, 1, 0))
    emmo = 0.25 * (ekm_c + S(ekm, 0, -1, 0) + S(ekm, -1, -1, 0) + S(ekm, -1, 0, 0))

    one = 1.0
    mjp = S(M, 0, 1, 0) if M is not None else one
    mjm = S(M, 0, -1, 0) if M is not None else one
    mkp = S(M, 0, 0, 1) if M is not None else one
    mkm = S(M, 0, 0, -1) if M is not None else one
    t_x = (ekm_c * (S(u, 1, 0, 0) - S(u, 0, 0, 0))
           - ekm_im * (S(u, 0, 0, 0) - S(u, -1, 0, 0))) * 2.0 * grid.dx2i
    t_y = (empo * ((S(u, 0, 1, 0) - S(u, 0, 0, 0)) * dyi * mjp
                   + (S(v, 0, 1, 0) - S(v, -1, 1, 0)) * dxi)
           - emmo * ((S(u, 0, 0, 0) - S(u, 0, -1, 0)) * dyi * mjm
                     + (S(v, 0, 0, 0) - S(v, -1, 0, 0)) * dxi)) * dyi
    t_z = (emop * ((S(u, 0, 0, 1) - S(u, 0, 0, 0)) * dzhi_kp * mkp
                   + (Sw(w, 0, 0, 1) - Sw(w, -1, 0, 1)) * dxi)
           - emom * ((S(u, 0, 0, 0) - S(u, 0, 0, -1)) * dzhi_k * mkm
                     + (Sw(w, 0, 0, 0) - Sw(w, -1, 0, 0)) * dxi)) * dzfi_k
    return t_x + t_y + t_z


def diff_v(g, grid: Grid, M=None):
    """(modsubgrid.f90:778-886).  `M`: ghosted v-point fluid mask — folds
    diffv_corr (modibm.f90:1033-1075), see diff_u."""
    nx, ny, nz = grid.shape
    S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
    Sw = partial(shw, nx=nx, ny=ny, nz=nz, h=1)
    u, v, w, ekm = g.u, g.v, g.w, g.ekm
    dxi, dyi = grid.dxi, grid.dyi
    dzf = grid.j("dzf_g")
    dzf_k = kvec(dzf, 1, nz); dzf_kp = kvec(dzf, 2, nz); dzf_km = kvec(dzf, 0, nz)
    dzhiq = grid.j("dzhiq"); dzhi = grid.j("dzhi")
    dzhiq_k = kvec(dzhiq, 0, nz); dzhiq_kp = kvec(dzhiq, 1, nz)
    dzhi_k = kvec(dzhi, 0, nz); dzhi_kp = kvec(dzhi, 1, nz)
    dzfi_k = kvec(grid.j("dzfi"), 0, nz)

    ekm_c = S(ekm, 0, 0, 0); ekm_jm = S(ekm, 0, -1, 0)
    eomm = (dzf_km * (ekm_c + ekm_jm)
            + dzf_k * (S(ekm, 0, 0, -1) + S(ekm, 0, -1, -1))) * dzhiq_k
    eomp = (dzf_kp * (ekm_c + ekm_jm)
            + dzf_k * (S(ekm, 0, 0, 1) + S(ekm, 0, -1, 1))) * dzhiq_kp
    emmo = 0.25 * (ekm_c + ekm_jm + S(ekm, -1, -1, 0) + S(ekm, -1, 0, 0))
    epmo = 0.25 * (ekm_c + ekm_jm + S(ekm, 1, -1, 0) + S(ekm, 1, 0, 0))

    one = 1.0
    mip = S(M, 1, 0, 0) if M is not None else one
    mim = S(M, -1, 0, 0) if M is not None else one
    mkp = S(M, 0, 0, 1) if M is not None else one
    mkm = S(M, 0, 0, -1) if M is not None else one
    t_x = (epmo * ((S(v, 1, 0, 0) - S(v, 0, 0, 0)) * dxi * mip
                   + (S(u, 1, 0, 0) - S(u, 1, -1, 0)) * dyi)
           - emmo * ((S(v, 0, 0, 0) - S(v, -1, 0, 0)) * dxi * mim
                     + (S(u, 0, 0, 0) - S(u, 0, -1, 0)) * dyi)) * dxi
    t_y = (ekm_c * (S(v, 0, 1, 0) - S(v, 0, 0, 0))
           - ekm_jm * (S(v, 0, 0, 0) - S(v, 0, -1, 0))) * 2.0 * grid.dy2i
    t_z = (eomp * ((S(v, 0, 0, 1) - S(v, 0, 0, 0)) * dzhi_kp * mkp
                   + (Sw(w, 0, 0, 1) - Sw(w, 0, -1, 1)) * dyi)
           - eomm * ((S(v, 0, 0, 0) - S(v, 0, 0, -1)) * dzhi_k * mkm
                     + (Sw(w, 0, 0, 0) - Sw(w, 0, -1, 0)) * dyi)) * dzfi_k
    return t_x + t_y + t_z


def diff_w(g, grid: Grid, M=None):
    """(modsubgrid.f90:890-997). Face-shaped result, interior faces only.
    `M`: x/y-ghosted w-face fluid mask (ibm.pmask_w) — folds diffw_corr
    (modibm.f90:1078-1117), see diff_u."""
    nx, ny, nz = grid.shape
    u, v, w, ekm = g.u, g.v, g.w, g.ekm
    h = 1
    nf = nz - 1
    wf = lambda di, dj, dk: w[h + di: h + di + nx, h + dj: h + dj + ny,
                              1 + dk: 1 + dk + nf]
    C = lambda A, di, dj, dk: A[h + di: h + di + nx, h + dj: h + dj + ny,
                                1 + dk: 1 + dk + nf]
    dxi, dyi = grid.dxi, grid.dyi
    dzf = grid.j("dzf_g")
    dzf_km = kvec(dzf, 1, nf)   # dzf[kf-1]
    dzf_k = kvec(dzf, 2, nf)    # dzf[kf]
    dzhiq_k = kvec(grid.j("dzhiq"), 1, nf)
    dzhi_k = kvec(grid.j("dzhi"), 1, nf)
    dzfi = grid.j("dzfi_g")
    dzfi_k = kvec(dzfi, 2, nf)   # 1/dzf[kf]
    dzfi_km = kvec(dzfi, 1, nf)  # 1/dzf[kf-1]

    # cells: (di,dj,dk) with dk=1 the cell above the face, dk=0 below
    emom = (dzf_km * (C(ekm, 0, 0, 1) + C(ekm, -1, 0, 1))
            + dzf_k * (C(ekm, 0, 0, 0) + C(ekm, -1, 0, 0))) * dzhiq_k
    eomm = (dzf_km * (C(ekm, 0, 0, 1) + C(ekm, 0, -1, 1))
            + dzf_k * (C(ekm, 0, 0, 0) + C(ekm, 0, -1, 0))) * dzhiq_k
    eopm = (dzf_km * (C(ekm, 0, 0, 1) + C(ekm, 0, 1, 1))
            + dzf_k * (C(ekm, 0, 0, 0) + C(ekm, 0, 1, 0))) * dzhiq_k
    epom = (dzf_km * (C(ekm, 0, 0, 1) + C(ekm, 1, 0, 1))
            + dzf_k * (C(ekm, 0, 0, 0) + C(ekm, 1, 0, 0))) * dzhiq_k

    one = 1.0
    if M is not None:
        Mf = lambda di, dj: M[h + di: h + di + nx, h + dj: h + dj + ny,
                              1: 1 + nf]
        mip, mim, mjp, mjm = Mf(1, 0), Mf(-1, 0), Mf(0, 1), Mf(0, -1)
    else:
        mip = mim = mjp = mjm = one
    wc = wf(0, 0, 0)
    t_x = (epom * ((wf(1, 0, 0) - wc) * dxi * mip
                   + (C(u, 1, 0, 1) - C(u, 1, 0, 0)) * dzhi_k)
           - emom * ((wc - wf(-1, 0, 0)) * dxi * mim
                     + (C(u, 0, 0, 1) - C(u, 0, 0, 0)) * dzhi_k)) * dxi
    t_y = (eopm * ((wf(0, 1, 0) - wc) * dyi * mjp
                   + (C(v, 0, 1, 1) - C(v, 0, 1, 0)) * dzhi_k)
           - eomm * ((wc - wf(0, -1, 0)) * dyi * mjm
                     + (C(v, 0, 0, 1) - C(v, 0, 0, 0)) * dzhi_k)) * dyi
    t_z = (C(ekm, 0, 0, 1) * (wf(0, 0, 1) - wc) * dzfi_k
           - C(ekm, 0, 0, 0) * (wc - wf(0, 0, -1)) * dzfi_km) * 2.0 * dzhi_k
    tend = t_x + t_y + t_z
    zeros = jnp.zeros((nx, ny, 1), tend.dtype)
    return jnp.concatenate([zeros, tend, zeros], axis=2)


def fused_diffusion(g, grid: Grid):
    """diffu + diffv + diffw (modsubgrid.f90:672-997) in flux-difference
    form: interpolate ekm to the three edge families once (Exy/Exz/Eyz ==
    the reference's empo/emom/eomm... stencils), form the shared fluxes
    F11..F23 = ekm * S, and difference them.  Each flux feeds BOTH sweeps
    that use it (e.g. F12 -> diffu t_y and diffv t_x), cutting the stencil
    op count vs the standalone `diff_u/v/w`.

    Layout choices (not yet measured on the H100):
      - everything is computed inside THIS one multi-output fusion from
        the 4 ghosted fields (4 HBM reads) instead of reusing the
        closure's materialized GradPack across the ekm-halo boundary,
      - no intermediate carries nz+1 cells along z: each z-edge flux is
        evaluated at the two face offsets (a = faces 0..nz-1, b = faces
        1..nz) as separate nz-long arrays, still shared between the two
        sweeps that difference them."""
    nx, ny, nz = grid.shape
    u, v, w, e = g.u, g.v, g.w, g.ekm
    dxi, dyi = grid.dxi, grid.dyi
    dzf = grid.j("dzf_g")
    dzhiq = grid.j("dzhiq")
    dzhi = grid.j("dzhi")
    dzfi_k = kvec(grid.j("dzfi"), 0, nz)
    kv = lambda a, lo: a[lo: lo + nz][None, None, :]

    # --- xy-edge family (nz cells along z throughout) -----------------
    S12 = ((u[1:, 1:, 1:1 + nz] - u[1:, :-1, 1:1 + nz]) * dyi
           + (v[1:, 1:, 1:1 + nz] - v[:-1, 1:, 1:1 + nz]) * dxi)
    Exy = 0.25 * (e[1:, 1:, 1:1 + nz] + e[:-1, 1:, 1:1 + nz]
                  + e[1:, :-1, 1:1 + nz] + e[:-1, :-1, 1:1 + nz])
    F12 = Exy * S12                       # (nx+1, ny+1, nz)

    # --- diagonal fluxes (nz cells along z) ---------------------------
    D11 = (u[1:, 1:1 + ny, 1:1 + nz] - u[:-1, 1:1 + ny, 1:1 + nz]) * dxi
    D22 = (v[1:1 + nx, 1:, 1:1 + nz] - v[1:1 + nx, :-1, 1:1 + nz]) * dyi
    D33 = (w[1:1 + nx, 1:1 + ny, 1:] - w[1:1 + nx, 1:1 + ny, :-1]) * dzfi_k
    F11 = e[: 1 + nx, 1:1 + ny, 1:1 + nz] * D11
    F22 = e[1:1 + nx, : 1 + ny, 1:1 + nz] * D22
    F33 = e[1:1 + nx, 1:1 + ny, 1:1 + nz] * D33

    # --- xz-edge family at the two face offsets ------------------------
    def F13_at(lo):   # faces lo .. lo+nz-1, (nx+1, ny, nz)
        S = ((u[1:, 1:1 + ny, 1 + lo: 1 + lo + nz]
              - u[1:, 1:1 + ny, lo: lo + nz]) * kv(dzhi, lo)
             + (w[1:, 1:1 + ny, lo: lo + nz]
                - w[:-1, 1:1 + ny, lo: lo + nz]) * dxi)
        E = ((kv(dzf, lo) * (e[1:, 1:1 + ny, 1 + lo: 1 + lo + nz]
                             + e[:-1, 1:1 + ny, 1 + lo: 1 + lo + nz])
              + kv(dzf, 1 + lo) * (e[1:, 1:1 + ny, lo: lo + nz]
                                   + e[:-1, 1:1 + ny, lo: lo + nz]))
             * kv(dzhiq, lo))
        return E * S

    def F23_at(lo):   # (nx, ny+1, nz)
        S = ((v[1:1 + nx, 1:, 1 + lo: 1 + lo + nz]
              - v[1:1 + nx, 1:, lo: lo + nz]) * kv(dzhi, lo)
             + (w[1:1 + nx, 1:, lo: lo + nz]
                - w[1:1 + nx, :-1, lo: lo + nz]) * dyi)
        E = ((kv(dzf, lo) * (e[1:1 + nx, 1:, 1 + lo: 1 + lo + nz]
                             + e[1:1 + nx, :-1, 1 + lo: 1 + lo + nz])
              + kv(dzf, 1 + lo) * (e[1:1 + nx, 1:, lo: lo + nz]
                                   + e[1:1 + nx, :-1, lo: lo + nz]))
             * kv(dzhiq, lo))
        return E * S

    F13a, F13b = F13_at(0), F13_at(1)     # faces k and k+1
    F23a, F23b = F23_at(0), F23_at(1)

    tu = ((F11[1:] - F11[:-1]) * (2.0 * dxi)
          + (F12[:-1, 1:] - F12[:-1, :-1]) * dyi
          + (F13b[:-1] - F13a[:-1]) * dzfi_k)
    tv = ((F12[1:, :-1] - F12[:-1, :-1]) * dxi
          + (F22[:, 1:] - F22[:, :-1]) * (2.0 * dyi)
          + (F23b[:, :-1] - F23a[:, :-1]) * dzfi_k)
    # w faces kf = 1..nz-1 (interior); faces 0 and nz stay zero.
    # F13b[..., m] sits at face m+1 -> slice m = 0..nz-2 covers kf=1..nz-1.
    dzhi_f = dzhi[1:nz][None, None, :]
    tw = ((F13b[1:, :, : nz - 1] - F13b[:-1, :, : nz - 1]) * dxi
          + (F23b[:, 1:, : nz - 1] - F23b[:, :-1, : nz - 1]) * dyi
          + (F33[:, :, 1:] - F33[:, :, :-1]) * (2.0 * dzhi_f))
    zeros = jnp.zeros((nx, ny, 1), tw.dtype)
    tw = jnp.concatenate([zeros, tw, zeros], axis=2)
    return tu, tv, tw


def diff_c(gc, gekh, grid: Grid, M=None):
    """Scalar diffusion (modsubgrid.f90:540-623, LES branch). `gc` ghosted
    h=1/hk=1.  `M`: ghosted c-point fluid mask (ibm.pmask_c) — folds
    diffc_corr (modibm.f90:1120-1164): every flux is masked by the
    opposite cell's fluid flag, see diff_u."""
    nx, ny, nz = grid.shape
    S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
    dzf = grid.j("dzf_g")
    dzf_k = kvec(dzf, 1, nz); dzf_kp = kvec(dzf, 2, nz); dzf_km = kvec(dzf, 0, nz)
    dzh2i = grid.j("dzh2i")
    dzh2i_k = kvec(dzh2i, 0, nz); dzh2i_kp = kvec(dzh2i, 1, nz)
    dzfi_k = kvec(grid.j("dzfi"), 0, nz)
    c = S(gc, 0, 0, 0)
    e = S(gekh, 0, 0, 0)
    one = 1.0
    m = (lambda di, dj, dk: S(M, di, dj, dk)) if M is not None \
        else (lambda di, dj, dk: one)
    t = 0.5 * (
        ((S(gekh, 1, 0, 0) + e) * (S(gc, 1, 0, 0) - c) * m(1, 0, 0)
         - (e + S(gekh, -1, 0, 0)) * (c - S(gc, -1, 0, 0)) * m(-1, 0, 0))
        * grid.dx2i
        + ((S(gekh, 0, 1, 0) + e) * (S(gc, 0, 1, 0) - c) * m(0, 1, 0)
           - (e + S(gekh, 0, -1, 0)) * (c - S(gc, 0, -1, 0)) * m(0, -1, 0))
        * grid.dy2i
        + ((dzf_kp * e + dzf_k * S(gekh, 0, 0, 1)) * (S(gc, 0, 0, 1) - c)
           * dzh2i_kp * m(0, 0, 1)
           - (dzf_km * e + dzf_k * S(gekh, 0, 0, -1))
           * (c - S(gc, 0, 0, -1)) * dzh2i_k * m(0, 0, -1)) * dzfi_k)
    return t


def diff_e(g, grid: Grid):
    """TKE diffusion with doubled coefficient (modsubgrid.f90:627-667)."""
    nx, ny, nz = grid.shape
    S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
    gekm, ge = g.ekm, g.e12
    dzf = grid.j("dzf_g")
    dzf_k = kvec(dzf, 1, nz); dzf_kp = kvec(dzf, 2, nz); dzf_km = kvec(dzf, 0, nz)
    dzh2i = grid.j("dzh2i")
    dzh2i_k = kvec(dzh2i, 0, nz); dzh2i_kp = kvec(dzh2i, 1, nz)
    dzfi_k = kvec(grid.j("dzfi"), 0, nz)
    c = S(ge, 0, 0, 0)
    e = S(gekm, 0, 0, 0)
    t = 1.0 * (
        ((S(gekm, 1, 0, 0) + e) * (S(ge, 1, 0, 0) - c)
         - (e + S(gekm, -1, 0, 0)) * (c - S(ge, -1, 0, 0))) * grid.dx2i
        + ((S(gekm, 0, 1, 0) + e) * (S(ge, 0, 1, 0) - c)
           - (e + S(gekm, 0, -1, 0)) * (c - S(ge, 0, -1, 0))) * grid.dy2i
        + ((dzf_kp * e + dzf_k * S(gekm, 0, 0, 1)) * (S(ge, 0, 0, 1) - c) * dzh2i_kp
           - (dzf_km * e + dzf_k * S(gekm, 0, 0, -1)) * (c - S(ge, 0, 0, -1)) * dzh2i_k
           ) * dzfi_k)
    return t
