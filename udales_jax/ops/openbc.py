"""Open (inflow/outflow) lateral boundaries in x.

Re-derivation of the reference's non-periodic x machinery:
  - profile inlet `xmi_profile`/`xTi_profile`/... (modboundary.f90:688-905)
  - driver inlet `xmi_driver` etc. with time-interpolated precursor planes
    (moddriver.f90 readdriverfile/drivergen)
  - convective outlet `xmo_convective` etc. (modboundary.f90:908-996):
    the ie+1 ghost planes (and the extra outlet u face) are *prognostic*,
    advected out with d()/dt + uouttot d()/dx = 0
  - projected-velocity BCs `bcpup` (modboundary.f90:1247-1305).

State: the outlet planes live in an `XPlanes` pytree carried by each Fields
set (c and m evolve separately, exactly like the reference's u0/um ghosts).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import BC_DRIVER, BC_PERIODIC, BC_PROFILE, Config
from ..grid import Grid

BC_RECYCLE = 5  # rescale-recycle inlet (modinlet.f90 inletgen, Lund 1998)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class XPlanes:
    """Outlet (x = xlen) boundary planes."""
    u: Any    # (ny, nz)   u face at x=nx (prognostic, tstep:262-264)
    v: Any    # (ny, nz)   v ghost at ie+1
    w: Any    # (ny, nz+1) w ghost at ie+1
    thl: Any  # (ny, nz)
    qt: Any   # (ny, nz)
    e12: Any  # (ny, nz)
    sv: Any   # (nsv, ny, nz)


def init_xplanes(fields, grid: Grid) -> XPlanes:
    """Initialize outlet planes from the last interior column."""
    return XPlanes(u=fields.u[-1], v=fields.v[-1], w=fields.w[-1],
                   thl=fields.thl[-1], qt=fields.qt[-1], e12=fields.e12[-1],
                   sv=fields.sv[:, -1])


@dataclass(frozen=True)
class Inlet:
    """Static or time-interpolated inlet condition. For BC_PROFILE the planes
    are z-profiles broadcast along y; for BC_DRIVER they are (j,k) planes
    interpolated in time from a recorded series."""
    mode: int
    uprof: Any = None      # (nz,)
    vprof: Any = None
    thlprof: Any = None
    qtprof: Any = None
    e12prof: Any = None
    svprof: Any = None     # (nsv, nz)
    # driver series
    t: Any = None          # (nt,)
    u: Any = None          # (nt, ny, nz)
    v: Any = None
    w: Any = None          # (nt, ny, nz+1)
    thl: Any = None
    qt: Any = None
    sv: Any = None         # (nt, nsv, ny, nz)
    # recycle inlet
    irecy: int = 0         # recycle plane index (reference irecy=ib+iplane)

    def planes(self, timee, ny: int, nz: int):
        """Return dict of inlet planes at time `timee` (linear interpolation
        for the driver mode, moddriver.f90 drivergen idriver==2)."""
        if self.mode == BC_PROFILE:
            b = lambda p: jnp.broadcast_to(p[None, :], (ny, nz))
            return dict(
                u=b(self.uprof), v=b(self.vprof),
                w=jnp.zeros((ny, nz + 1), self.uprof.dtype),
                thl=b(self.thlprof), qt=b(self.qtprof),
                e12=b(self.e12prof),
                sv=(jnp.broadcast_to(self.svprof[:, None, :],
                                     (self.svprof.shape[0], ny, nz))
                    if self.svprof is not None and self.svprof.shape[0]
                    else jnp.zeros((0, ny, nz), self.uprof.dtype)))
        # driver: clamp + lerp
        t = self.t
        idx = jnp.clip(jnp.searchsorted(t, timee, side="right") - 1,
                       0, t.shape[0] - 2)
        t0 = t[idx]
        t1 = t[idx + 1]
        a = jnp.clip((timee - t0) / jnp.maximum(t1 - t0, 1e-12), 0.0, 1.0)
        lerp = lambda f: (1.0 - a) * f[idx] + a * f[idx + 1]
        # thl/qt planes are absent for neutral/dry precursors (the reference
        # only writes h/qdriver under ltempeq&lhdriver / lmoist&lqdriver,
        # moddriver.f90:885-920) — fall back to zeros of the u-plane shape
        zero = lambda: jnp.zeros(self.u.shape[1:], self.u.dtype)
        return dict(u=lerp(self.u), v=lerp(self.v), w=lerp(self.w),
                    thl=(lerp(self.thl) if self.thl is not None
                         else zero()),
                    qt=(lerp(self.qt) if self.qt is not None else zero()),
                    sv=(lerp(self.sv) if self.sv is not None
                        else jnp.zeros((0,) + self.u.shape[1:],
                                       self.u.dtype)),
                    e12=None)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DriverWindow:
    """Rolling device window of a precursor driver series (the lchunkread
    equivalent, moddriver.f90:933).  Carried as a State leaf so the host
    can swap chunks between jitted steps without recompiling; all leaves
    keep fixed shapes (W = chunkread_size records)."""
    t: Any     # (W,) record times
    u: Any     # (W, ny, nz)
    v: Any     # (W, ny, nz)
    w: Any     # (W, ny, nz+1)
    thl: Any   # (W, ny, nz)  zeros when the precursor wrote no hdriver
    qt: Any    # (W, ny, nz)
    sv: Any    # (W, nsv, ny, nz)


def driver_window_planes(drv: DriverWindow, timee):
    """Inlet planes at `timee` from the current window (clamp + lerp, the
    drivergen interpolation of moddriver.f90 idriver==2)."""
    t = drv.t
    idx = jnp.clip(jnp.searchsorted(t, timee, side="right") - 1,
                   0, t.shape[0] - 2)
    t0 = t[idx]
    t1 = t[idx + 1]
    a = jnp.clip((timee - t0) / jnp.maximum(t1 - t0, 1e-12), 0.0, 1.0)
    a = a.astype(drv.u.dtype)
    lerp = lambda f: (1.0 - a) * f[idx] + a * f[idx + 1]
    return dict(u=lerp(drv.u), v=lerp(drv.v), w=lerp(drv.w),
                thl=lerp(drv.thl), qt=lerp(drv.qt), sv=lerp(drv.sv),
                e12=None)


def recycle_planes(inlet: Inlet, c, ny: int, nz: int):
    """Rescale-recycle inlet (compact Lund-1998, modinlet.f90 inletgen:202):
    the inlet plane is the target mean profile plus the de-meaned
    fluctuations sampled at the recycle plane. The full inner/outer
    boundary-layer-thickness blending of the reference is condensed to a
    uniform rescale, which preserves its two essential properties (target
    mean, recycled turbulence)."""
    ir = inlet.irecy % c.u.shape[0]
    fl = lambda plane: plane - plane.mean(axis=0, keepdims=True)
    b = lambda p: jnp.broadcast_to(p[None, :], (ny, nz))
    return dict(
        u=b(inlet.uprof) + fl(c.u[ir]),
        v=b(inlet.vprof) + fl(c.v[ir]),
        w=fl(c.w[ir]),
        thl=b(inlet.thlprof) + fl(c.thl[ir]),
        qt=b(inlet.qtprof) + fl(c.qt[ir]),
        e12=b(inlet.e12prof),
        sv=(jnp.broadcast_to(inlet.svprof[:, None, :],
                             (inlet.svprof.shape[0], ny, nz))
            if inlet.svprof is not None and inlet.svprof.shape[0]
            else jnp.zeros((0, ny, nz), c.u.dtype)))


def uouttot_value(cfg: Config, u0av, grid: Grid):
    """Outflow advection velocity (modboundary.f90:142-161)."""
    if cfg.physics.luvolflowr:
        return jnp.asarray(cfg.physics.uflowrate, u0av.dtype)
    dzf = jnp.asarray(grid.j("dzf"))
    # float(): numpy f64 scalar would promote the f32 result
    return jnp.sum(u0av * dzf) / float(grid.zh[-1] - grid.zh[1])


def vouttot_value(cfg: Config, v0av, grid: Grid):
    """Outflow advection velocity for open-y (y mirror of uouttot)."""
    if cfg.physics.lvvolflowr:
        return jnp.asarray(cfg.physics.vflowrate, v0av.dtype)
    dzf = jnp.asarray(grid.j("dzf"))
    return jnp.sum(v0av * dzf) / float(grid.zh[-1] - grid.zh[1])


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class YPlanes:
    """Outlet (y = ylen) boundary planes — the y mirror of XPlanes
    (ymo_convective and friends, modboundary.f90:1100-1190)."""
    u: Any    # (nx, nz)   u ghost at je+1
    v: Any    # (nx, nz)   v face at y=ny (prognostic)
    w: Any    # (nx, nz+1) w ghost at je+1
    thl: Any
    qt: Any
    e12: Any
    sv: Any   # (nsv, nx, nz)


def init_yplanes(fields, grid: Grid) -> YPlanes:
    return YPlanes(u=fields.u[:, -1], v=fields.v[:, -1], w=fields.w[:, -1],
                   thl=fields.thl[:, -1], qt=fields.qt[:, -1],
                   e12=fields.e12[:, -1], sv=fields.sv[:, :, -1])


def convect_planes_y(by: YPlanes, fields, grid: Grid, rk3coef, vouttot,
                     inlet_planes) -> YPlanes:
    """Convective outlet update in y (ymo/yTo/yqo/yso_convective,
    modboundary.f90:1100-1190)."""
    fac = grid.dyi * rk3coef * vouttot
    cv = lambda g, i: g - (g - i) * fac
    return YPlanes(
        u=cv(by.u, fields.u[:, -1]),
        v=by.v,
        w=cv(by.w, fields.w[:, -1]),
        thl=cv(by.thl, fields.thl[:, -1]),
        qt=cv(by.qt, fields.qt[:, -1]),
        e12=cv(by.e12, fields.e12[:, -1]),
        sv=cv(by.sv, fields.sv[:, :, -1]) if by.sv.shape[0] else by.sv,
    )


def pad_x_open(f, lo_plane, hi_plane, h: int = 1):
    """Pad axis 0 with explicit ghost planes (each (ny[,+halo], nz...))."""
    parts = []
    for _ in range(h):
        parts.append(lo_plane[None])
    parts = parts[:1] if h == 1 else [lo_plane[None]] * h
    return jnp.concatenate([*parts, f, *( [hi_plane[None]] * h )], axis=0)


def load_driver_inlet(path, dtype) -> Inlet:
    """Load a recorded precursor-plane series (native .npz written by
    sim.DriverRecorder; the reference's per-y-rank unformatted ?driver files
    are the Fortran equivalent, moddriver.f90:515/750)."""
    with np.load(path) as f:
        get = lambda k: (jnp.asarray(f[k], dtype) if k in f else None)
        return Inlet(mode=BC_DRIVER, t=jnp.asarray(f["t"], dtype),
                     u=get("u"), v=get("v"), w=get("w"),
                     thl=get("thl"), qt=get("qt"), sv=get("sv"))


def convect_planes(bx: XPlanes, fields, grid: Grid, rk3coef, uouttot,
                   inlet_planes) -> XPlanes:
    """Convective outlet update (xmo/xTo/xqo/xso_convective,
    modboundary.f90:908-996): ghost -= (ghost - interior_last) * dxi *
    rk3coef * uouttot. The outlet u face itself is integrated in the main
    update; here only the ghost planes advect."""
    fac = grid.dxi * rk3coef * uouttot
    cv = lambda g, i: g - (g - i) * fac
    return XPlanes(
        u=bx.u,
        v=cv(bx.v, fields.v[-1]),
        w=cv(bx.w, fields.w[-1]),
        thl=cv(bx.thl, fields.thl[-1]),
        qt=cv(bx.qt, fields.qt[-1]),
        e12=cv(bx.e12, fields.e12[-1]),
        sv=cv(bx.sv, fields.sv[:, -1]) if bx.sv.shape[0] else bx.sv,
    )
