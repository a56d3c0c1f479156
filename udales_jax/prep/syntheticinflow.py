"""Synthetic turbulent inflow generation (digital-filter method).

Replaces tools/syntheticInflow/modSyntheticInflow.f90 (1388 LoC): generates
time-correlated inlet planes with prescribed mean profile and Reynolds
stresses (Klein et al. 2003 / Xie & Castro 2008 digital filter + Lund
Cholesky transform), written in the driverdata.<exp>.npz format consumed by
ops.openbc.load_driver_inlet (the idriver=2 inflow path).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def _gauss_kernel(L, d, support=2.0):
    """1-D filter with Gaussian autocorrelation of integral scale L on
    spacing d (Klein 2003: b_k ~ exp(-pi k^2 / (2 n^2)), n = L/d)."""
    n = max(L / max(d, 1e-12), 1e-3)
    N = max(int(np.ceil(support * n)), 1)
    k = np.arange(-N, N + 1)
    b = np.exp(-np.pi * k ** 2 / (2.0 * n ** 2))
    return b / np.sqrt((b ** 2).sum())


def _filter2d(r, by, bz):
    """Separable filtering in (y, z) with periodic y and clamped z."""
    from scipy.ndimage import convolve1d
    f = convolve1d(r, by, axis=0, mode="wrap")
    f = convolve1d(f, bz, axis=1, mode="nearest")
    return f


def generate_synthetic_inflow(
        path: str | Path, ny: int, nz: int, dy: float, dzf: np.ndarray,
        t_end: float, dt: float,
        u_mean: np.ndarray, v_mean: np.ndarray | None = None,
        uu: np.ndarray | None = None, vv: np.ndarray | None = None,
        ww: np.ndarray | None = None, uw: np.ndarray | None = None,
        Ly: float = 1.0, Lz: float = 1.0, Tscale: float = 1.0,
        thl_mean: np.ndarray | None = None, qt_mean: np.ndarray | None = None,
        tt: np.ndarray | None = None, wth: np.ndarray | None = None,
        qq: np.ndarray | None = None, wq: np.ndarray | None = None,
        sv_mean: np.ndarray | None = None, ss: np.ndarray | None = None,
        fortran_dir: str | Path | None = None, expnr: str = "000",
        seed: int = 0):
    """Write a driverdata .npz with synthetic turbulent inlet planes.

    Profiles are (nz,): u_mean and the Reynolds stresses <u'u'>, <v'v'>,
    <w'w'>, <u'w'>. Ly/Lz are integral length scales, Tscale the Lagrangian
    time scale for the exponential time correlation (Xie-Castro 2008).

    Temperature/moisture/scalar planes (modSyntheticInflow.f90 temperature
    pathway): fluctuations are generated with the Lund-style extension
    th' = (wth/a33) psi_w + sqrt(tt - (wth/a33)^2) psi_th, reproducing the
    prescribed variance <th'th'> = tt and flux <w'th'> = wth; same for qt
    (qq, wq) and scalars (sv_mean (nsv,nz), variances ss (nsv,nz)).

    With `fortran_dir` the planes are ALSO written as the reference's
    Fortran direct-access ?driver_* file set (moddriver.f90:515) so a
    reference main run can consume them."""
    from ..io.restart import save_npz
    rng = np.random.default_rng(seed)
    nt = int(np.ceil(t_end / dt)) + 1
    z = lambda: np.zeros(nz)
    uu = uu if uu is not None else z()
    vv = vv if vv is not None else z()
    ww = ww if ww is not None else z()
    uw = uw if uw is not None else z()
    v_mean = v_mean if v_mean is not None else z()
    # Lund transform coefficients (Cholesky of the stress tensor with
    # uv = vw = 0, the standard boundary-layer form)
    a11 = np.sqrt(np.maximum(uu, 0.0))
    a21 = np.zeros(nz)
    a22 = np.sqrt(np.maximum(vv, 0.0))
    a31 = np.divide(uw, np.maximum(a11, 1e-12),
                    out=np.zeros(nz), where=a11 > 1e-12)
    a33 = np.sqrt(np.maximum(ww - a31 ** 2, 0.0))

    by = _gauss_kernel(Ly, dy)
    bz = _gauss_kernel(Lz, float(np.mean(dzf)))
    c1 = np.exp(-np.pi * dt / (2.0 * Tscale))
    c2 = np.sqrt(1.0 - np.exp(-np.pi * dt / Tscale))

    nsv = 0 if sv_mean is None else np.atleast_2d(sv_mean).shape[0]
    if sv_mean is not None:
        sv_mean = np.atleast_2d(sv_mean)
        ss = (np.atleast_2d(ss) if ss is not None
              else np.zeros_like(sv_mean))
    nfield = 3 + (thl_mean is not None) + (qt_mean is not None) + nsv
    psi = [_filter2d(rng.standard_normal((ny, nz)), by, bz)
           for _ in range(nfield)]

    def scalar_coefs(var, flux):
        var = np.zeros(nz) if var is None else np.asarray(var, float)
        flux = np.zeros(nz) if flux is None else np.asarray(flux, float)
        b_w = np.divide(flux, np.maximum(a33, 1e-12),
                        out=np.zeros(nz), where=a33 > 1e-12)
        b_s = np.sqrt(np.maximum(var - b_w ** 2, 0.0))
        return b_w, b_s
    th_w, th_s = scalar_coefs(tt, wth)
    qt_w, qt_s = scalar_coefs(qq, wq)
    times = np.arange(nt) * dt
    U = np.zeros((nt, ny, nz), np.float32)
    V = np.zeros((nt, ny, nz), np.float32)
    W = np.zeros((nt, ny, nz + 1), np.float32)
    TH = (np.zeros((nt, ny, nz), np.float32)
          if thl_mean is not None else None)
    QT = (np.zeros((nt, ny, nz), np.float32)
          if qt_mean is not None else None)
    SV = np.zeros((nt, nsv, ny, nz), np.float32) if nsv else None
    for it in range(nt):
        for c in range(nfield):
            r = _filter2d(rng.standard_normal((ny, nz)), by, bz)
            psi[c] = c1 * psi[c] + c2 * r
        # normalize each plane to unit variance before the Lund transform
        ps = [p / max(p.std(), 1e-12) for p in psi]
        up = a11 * ps[0]
        vp = a22 * ps[1]
        wp = a31 * ps[0] + a33 * ps[2]
        U[it] = (u_mean + up).astype(np.float32)
        V[it] = (v_mean + vp).astype(np.float32)
        W[it, :, :nz] = wp.astype(np.float32)
        nf = 3
        if TH is not None:
            TH[it] = (thl_mean + th_w * ps[2] + th_s * ps[nf]).astype(
                np.float32)
            nf += 1
        if QT is not None:
            QT[it] = (qt_mean + qt_w * ps[2] + qt_s * ps[nf]).astype(
                np.float32)
            nf += 1
        for m in range(nsv):
            SV[it, m] = (sv_mean[m]
                         + np.sqrt(np.maximum(ss[m], 0.0)) * ps[nf + m]
                         ).astype(np.float32)
    planes = {"t": times, "u": U, "v": V, "w": W, "thl": TH, "qt": QT,
              "sv": SV}
    save_npz(path, {k: v for k, v in planes.items() if v is not None})
    if fortran_dir is not None:
        from ..io.driverfiles import write_driver_files
        planes = {"u": U, "v": V, "w": W}
        if TH is not None:
            planes["thl"] = TH
        if QT is not None:
            planes["qt"] = QT
        planes["sv"] = SV
        write_driver_files(fortran_dir, expnr, times, planes, ny, nz)
    return times
