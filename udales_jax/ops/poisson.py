"""FFT-based pressure-Poisson solver.

Redesign of src/modpois.f90 (POISS_FFT2D path, :419-712):
the reference transposes z->y->x pencils and runs 1-D FFTW transforms per
line; here the solve is expressed as whole-array batched FFTs + a vertical
tridiagonal solve, and XLA inserts the all-to-all reshard collectives when the
arrays are sharded over a device mesh (the direct analogue of the 2DECOMP
transposes, SURVEY.md section 2.3).

  rhs(x,y,z) --rfft(x)--> --fft(y)--> modal tridiag in k --> inverse path

Eigenvalues follow modpois.f90:99-146; tridiagonal coefficients and the
Neumann/Dirichlet closure follow modpois.f90:148-220; the singular (0,0) mode
is pinned with the reference's Dirichlet-across-the-top-cell trick
(modpois.f90:208-220).  The Thomas solve is reformulated as two first-order
linear recurrences evaluated with `lax.associative_scan` (log depth in k).

Non-periodic directions use DCT-II/DCT-III implemented with an even-extension
rFFT (XLA has no native DCT).
"""
from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from ..config import BC_PERIODIC, Config
from ..grid import Grid


# ---------------------------------------------------------------------------
# DCT via even extension (for Neumann directions, modpois.f90 REDFT10/01)
# ---------------------------------------------------------------------------

def dct2(x, axis: int):
    """DCT-II along `axis` (unnormalized, FFTW REDFT10 convention)."""
    n = x.shape[axis]
    ext = jnp.concatenate([x, jnp.flip(x, axis)], axis=axis)
    X = jnp.fft.fft(ext, axis=axis)
    k = jnp.arange(n)
    shape = [1] * x.ndim
    shape[axis] = n
    tw = jnp.exp(-1j * jnp.pi * k / (2 * n)).reshape(shape)
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(0, n)
    return jnp.real(X[tuple(sl)] * tw)


def dct2_fast(x, axis: int):
    """DCT-II via the Makhoul fold: reorder to v = [x0,x2,...,x5,x3,x1],
    one length-n FFT, twiddle. Half the transform length of the
    even-extension form."""
    n = x.shape[axis]
    x = jnp.moveaxis(x, axis, -1)
    v = jnp.concatenate([x[..., ::2], x[..., 1::2][..., ::-1]], axis=-1)
    V = jnp.fft.fft(v, axis=-1)
    k = jnp.arange(n)
    tw = 2.0 * jnp.exp(-1j * jnp.pi * k / (2 * n))
    X = jnp.real(V * tw)
    return jnp.moveaxis(X, -1, axis)


def idct2_fast(x, axis: int):
    """Exact inverse of dct2_fast (scaled DCT-III via inverse fold)."""
    n = x.shape[axis]
    x = jnp.moveaxis(x, axis, -1).astype(
        jnp.complex64 if x.dtype == jnp.float32 else jnp.complex128)
    k = jnp.arange(n)
    tw = jnp.exp(1j * jnp.pi * k / (2 * n)) / 2.0
    # rebuild the complex spectrum of the folded sequence:
    # V_k = tw_k * (X_k - i X_{n-k}), X_n := 0
    xr = x.real
    xflip = jnp.concatenate([jnp.zeros_like(xr[..., :1]),
                             xr[..., 1:][..., ::-1]], axis=-1)
    V = tw * (xr - 1j * xflip)
    v = jnp.fft.ifft(V, axis=-1)
    out = jnp.zeros_like(xr)
    out = out.at[..., ::2].set(jnp.real(v[..., : (n + 1) // 2]))
    out = out.at[..., 1::2].set(jnp.real(v[..., (n + 1) // 2:][..., ::-1]))
    return jnp.moveaxis(out, -1, axis)


def idct2(x, axis: int):
    """Exact inverse of :func:`dct2` (= DCT-III / 2n, FFTW REDFT01).

    Reconstructs the length-2n spectrum G[k] = X[k] e^{i pi k / 2n} with the
    even-extension symmetries G[n]=0, G[2n-k]=conj(G[k]), inverts with ifft,
    and keeps the first n samples."""
    n = x.shape[axis]
    k = jnp.arange(n)
    shape = [1] * x.ndim
    shape[axis] = n
    tw = jnp.exp(1j * jnp.pi * k / (2 * n)).reshape(shape)
    G = x * tw
    zshape = list(x.shape)
    zshape[axis] = 1
    z = jnp.zeros(zshape, G.dtype)
    sl_tail = [slice(None)] * x.ndim
    sl_tail[axis] = slice(1, n)
    Gtail = jnp.conj(jnp.flip(G[tuple(sl_tail)], axis))
    Gfull = jnp.concatenate([G, z, Gtail], axis=axis)
    ext = jnp.real(jnp.fft.ifft(Gfull, axis=axis))
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(0, n)
    return ext[tuple(sl)]


# ---------------------------------------------------------------------------
# Transform-by-matmul
#
# Every transform below is a dense (N x N) matrix application built once at
# init: 2N FLOPs per point, which the matrix units run far above the memory
# roofline for the transform sizes this solver meets (N <= a few thousand).
# Inverses are exact matrix inverses, so round-trips are identity to
# machine precision.  Whether cuFFT beats the dense form on the H100, per
# axis length, is not yet measured.
# ---------------------------------------------------------------------------

def _dctII_matrix(n):
    """FFTW REDFT10: X_k = 2 sum_m x_m cos(pi k (2m+1) / (2n))."""
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    return 2.0 * np.cos(np.pi * k * (2 * m + 1) / (2 * n))


# Accumulation scheme of the real float32 transform matmuls, per platform.
# "highest" is full-f32 accumulation; "x3" is three bf16 passes with f32
# accumulation (DotAlgorithmPreset.BF16_BF16_F32_X3).  Plain bf16 or TF32
# (one pass) is not safe: it loses ~3 decimal digits and shows up directly
# as O(1e-4) post-projection divergence.  The CPU keeps "highest" so float64
# oracle runs are bit-stable.  On the H100 "x3" is 0.4-0.6 ms faster per
# 256^3 solve, but its stretched-z error (9.8e-6 relative L2 against
# float64) leaves chip_smoke.py's 1e-5 tolerance a margin no larger than
# float32 summation-order noise, so the GPU keeps "highest" (PERF.md).
_PRECISION_BY_PLATFORM = {"cpu": "highest", "gpu": "highest"}


def _poisson_precision(platform: str | None = None):
    """Matmul precision of the real float32 transforms on `platform`
    (default: JAX's default backend).  `UDALES_POIS_PREC=highest|x3`
    overrides the table on every platform; a platform missing from the
    table is an error, not a silent default."""
    mode = os.environ.get("UDALES_POIS_PREC", "").lower()
    if not mode:
        platform = platform or jax.default_backend()
        if platform not in _PRECISION_BY_PLATFORM:
            raise ValueError(f"no Poisson matmul precision chosen for "
                             f"platform {platform!r}")
        mode = _PRECISION_BY_PLATFORM[platform]
    if mode == "highest":
        return jax.lax.Precision.HIGHEST
    if mode == "x3":
        return jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
    raise ValueError(f"UDALES_POIS_PREC={mode!r}: expected highest or x3")


def _mm(x, M, axis, out_axis_name="f"):
    """Apply matrix M (out,in) along `axis` of x via einsum (one matmul)."""
    letters = "abcde"
    nd = x.ndim
    subs_in = "".join(letters[i] for i in range(nd))
    subs_out = subs_in.replace(letters[axis], "F")
    # the bf16 dot-algorithm presets are real-operand schemes and would
    # destroy f64, so complex and float64 matmuls always run at HIGHEST;
    # the hot paths below are all real-pair f32 form
    prec = (jax.lax.Precision.HIGHEST
            if jnp.iscomplexobj(x) or x.dtype == jnp.float64
            else _poisson_precision())
    return jnp.einsum(f"{subs_in},F{letters[axis]}->{subs_out}", x, M,
                      precision=prec)


def _cmm(S, Mre, Mim, axis):
    """Complex matmul in real-pair form: S is a stacked (2, ...) array of
    (re, im) planes, M = Mre + i·Mim applied along `axis` of the unstacked
    field.  Four real matmuls — the same work XLA's complex dot does,
    but expressed in real dots so bf16 accumulation presets apply."""
    re = _mm(S[0], Mre, axis) - _mm(S[1], Mim, axis)
    im = _mm(S[0], Mim, axis) + _mm(S[1], Mre, axis)
    return jnp.stack([re, im])


def _fwd_r2c(x, Mre, Mim, axis):
    """Real field -> stacked (re, im) spectral planes: two real matmuls
    (a complex dot on a zero-imag input wastes half its passes)."""
    return jnp.stack([_mm(x, Mre, axis), _mm(x, Mim, axis)])


def _inv_c2r(S, Mre, Mim, axis):
    """Stacked (re, im) spectral planes -> real field (only the real part
    of the inverse transform is needed): two real matmuls."""
    return _mm(S[0], Mre, axis) - _mm(S[1], Mim, axis)


class PoissonSolver:
    """Precomputed spectral-tridiagonal solver (reference initpois,
    modpois.f90:66-226)."""

    def __init__(self, grid: Grid, cfg: Config, rhobf=None, rhobh=None,
                 mesh=None):
        self.grid = grid
        self.cfg = cfg
        self.mesh = mesh  # jax.sharding.Mesh for explicit pencil resharding
        nx, ny, nz = grid.shape
        self.per_x = cfg.bc.BCxm == BC_PERIODIC
        self.per_y = cfg.bc.BCym == BC_PERIODIC
        rhobf = np.ones(nz) if rhobf is None else np.asarray(rhobf)
        rhobh = np.ones(nz + 1) if rhobh is None else np.asarray(rhobh)

        dxi, dyi = grid.dxi, grid.dyi
        # eigenvalues (modpois.f90:100-146); complex-FFT indexing
        if self.per_x:
            mx = np.arange(nx // 2 + 1)
            xrt = -4.0 * dxi * dxi * np.sin(np.pi * mx / nx) ** 2
        else:
            mx = np.arange(nx)
            xrt = -4.0 * dxi * dxi * np.sin(np.pi * mx / (2 * nx)) ** 2
        if self.per_y:
            my = np.arange(ny)
            yrt = -4.0 * dyi * dyi * np.sin(np.pi * my / ny) ** 2
        else:
            my = np.arange(ny)
            yrt = -4.0 * dyi * dyi * np.sin(np.pi * my / (2 * ny)) ** 2

        # tridiagonal coefficients (modpois.f90:153-177)
        dzf = grid.dzf
        dzh = grid.dzh
        a = rhobh[:nz] / (dzf * dzh[:nz])
        c = rhobh[1:] / (dzf * dzh[1:])
        b = -(a + c)
        b_top_N = b[-1] + c[-1]
        b_top_D = b[-1] - c[-1]
        b = b.copy()
        b[0] = b[0] + a[0]       # Neumann bottom
        b[-1] = b_top_N          # Neumann top
        a = a.copy(); c = c.copy()
        a[0] = 0.0
        c[-1] = 0.0

        lam = xrt[:, None] + yrt[None, :]                   # (mx, my)
        D = b[None, None, :] + rhobf[None, None, :] * lam[:, :, None]
        # pin the singular (0,0) mode via Dirichlet across the top cell
        # (modpois.f90:208-220)
        zero = np.isclose(lam, 0.0)
        D[..., -1] = np.where(zero, b_top_D, D[..., -1])

        # precompute Thomas factors: w_k = 1/(D_k - a_k cp_{k-1}), cp_k = c_k w_k
        w = np.empty_like(D)
        cp = np.empty_like(D)
        w[..., 0] = 1.0 / D[..., 0]
        cp[..., 0] = c[0] * w[..., 0]
        for k in range(1, nz):
            w[..., k] = 1.0 / (D[..., k] - a[k] * cp[..., k - 1])
            cp[..., k] = c[k] * w[..., k]

        fdt = np.float32 if grid.dtype == np.float32 else np.float64
        self.a = jnp.asarray(a, fdt)
        self.w = jnp.asarray(w, fdt)
        self.cp = jnp.asarray(cp, fdt)
        self.Af = jnp.asarray(-(a[None, None, :] * w), fdt)  # forward multiplier

        # Fully-diagonal fast path: uniform z + Boussinesq density + simple
        # top BC lets the z direction be diagonalized by a DCT-II
        # (modpois.f90 BCzp==2 eigenvalues, :182-187) instead of the
        # tridiagonal solve. The mean mode differs from the reference's
        # Dirichlet-top pin only by an additive constant in p, which the
        # projection gradient cancels.
        from ..config import BCTOPM_PRESSURE, POISS_FFT3D
        # POISS_FFT3D (modpois.f90:300-320, 808-882): fully periodic in z
        # too — diagonalized by a plain FFT with periodic z eigenvalues
        # zrt(k) = -4 dzi^2 sin^2(pi k / ktot) (assumes uniform z).
        self.fft3d = cfg.dynamics.ipoiss == POISS_FFT3D
        if self.fft3d:
            if not (self.per_x and self.per_y):
                raise ValueError("POISS_FFT3D requires periodic x and y")
            if not np.allclose(dzf, dzf[0], rtol=1e-12):
                raise ValueError("POISS_FFT3D assumes an equidistant z grid")
            dzi = 1.0 / dzf[0]
            kz = np.arange(nz)
            zrt = -4.0 * dzi * dzi * np.sin(np.pi * kz / nz) ** 2
            lam3 = rhobf[None, None, :] * (
                xrt[:, None, None] + yrt[None, :, None]
                + zrt[None, None, :])
            inv = np.where(np.abs(lam3) > 1e-300, 1.0 / np.where(
                np.abs(lam3) > 1e-300, lam3, 1.0), 0.0)
            inv[0, 0, 0] = 0.0   # zero mode -> 0 (modpois.f90:869-873)
            fdt3 = np.float32 if grid.dtype == np.float32 else np.float64
            self.inv_lam3d = jnp.asarray(inv, fdt3)

        self.diag_z = (not self.fft3d
                       and self.per_x and self.per_y
                       and np.allclose(dzf, dzf[0], rtol=1e-12)
                       and np.allclose(rhobf, 1.0)
                       and np.allclose(rhobh, 1.0)
                       and cfg.bc.BCtopm != BCTOPM_PRESSURE
                       and cfg.bc.BCzp == 1)
        # BCzp==2 (modpois.f90:179-193, 556-591): replace the tridiagonal
        # z solve by a cosine transform with eigenvalues
        # zrt(k) = -4 dzi^2 sin^2((k-1) pi / (2 ktot)); the modal divide is
        # by xyzrt = rhobf(k)*(xrt+yrt+zrt(k)), zero modes -> 0.  Requires
        # an equidistant z grid (the reference uses dzfi(1) throughout).
        self.bczp2 = (not self.fft3d) and cfg.bc.BCzp == 2
        if self.bczp2:
            if not np.allclose(dzf, dzf[0], rtol=1e-12):
                raise ValueError("BCzp=2 assumes an equidistant z grid "
                                 "(modpois.f90:184)")
            dzi = 1.0 / dzf[0]
            kz = np.arange(nz)
            zrt = -4.0 * dzi * dzi * np.sin(np.pi * kz / (2 * nz)) ** 2
            lam3 = rhobf[None, None, :] * (lam[:, :, None]
                                           + zrt[None, None, :])
            inv = np.where(np.abs(lam3) > 1e-300, 1.0 / np.where(
                np.abs(lam3) > 1e-300, lam3, 1.0), 0.0)
            self.inv_lam_z2 = jnp.asarray(inv, fdt)
        if self.diag_z:
            dzi = 1.0 / dzf[0]
            kz = np.arange(nz)
            zrt = -4.0 * dzi * dzi * np.sin(np.pi * kz / (2 * nz)) ** 2
            lam3 = lam[:, :, None] + zrt[None, None, :]
            inv = np.where(np.abs(lam3) > 1e-300, 1.0 / np.where(
                np.abs(lam3) > 1e-300, lam3, 1.0), 0.0)
            inv[0, 0, 0] = 0.0   # pin the global mean mode
            self.inv_lam3 = jnp.asarray(inv, fdt)

        self._build_transform_matrices()

    def _build_transform_matrices(self):
        """Dense DFT/DCT matrices for the transform-by-matmul path (see
        the note above _dctII_matrix). Built in float64, cast to the solve
        dtype."""
        grid = self.grid
        nx, ny, nz = grid.shape
        fdt = np.float32 if grid.dtype == np.float32 else np.float64
        cdt = np.complex64 if fdt == np.float32 else np.complex128
        mats = {}
        if self.per_x:
            f = np.arange(nx // 2 + 1)[:, None]
            m = np.arange(nx)[None, :]
            mats["Rx"] = np.exp(-2j * np.pi * f * m / nx).astype(cdt)
            w = np.full(nx // 2 + 1, 2.0)
            w[0] = 1.0
            if nx % 2 == 0:
                w[-1] = 1.0
            mats["iRx"] = (np.exp(2j * np.pi * m.T * f.T / nx)
                           * w[None, :] / nx).astype(cdt)   # (nx, nx/2+1)
            for key in ("Rx", "iRx"):
                mats[key + "_re"] = np.ascontiguousarray(mats[key].real)
                mats[key + "_im"] = np.ascontiguousarray(mats[key].imag)
        else:
            C = _dctII_matrix(nx)
            mats["Cx"] = C.astype(fdt)
            mats["iCx"] = np.linalg.inv(C).astype(fdt)
        if self.per_y:
            g = np.arange(ny)[:, None]
            m = np.arange(ny)[None, :]
            mats["Wy"] = np.exp(-2j * np.pi * g * m / ny).astype(cdt)
            mats["iWy"] = (np.exp(2j * np.pi * m.T * g.T / ny) / ny
                           ).astype(cdt)
            for key in ("Wy", "iWy"):
                mats[key + "_re"] = np.ascontiguousarray(mats[key].real)
                mats[key + "_im"] = np.ascontiguousarray(mats[key].imag)
        else:
            C = _dctII_matrix(ny)
            mats["Cy"] = C.astype(fdt)
            mats["iCy"] = np.linalg.inv(C).astype(fdt)
        if self.diag_z or self.bczp2:
            C = _dctII_matrix(nz)
            mats["Cz"] = C.astype(fdt)
            mats["iCz"] = np.linalg.inv(C).astype(fdt)
        if getattr(self, "fft3d", False):
            f = np.arange(nz)[:, None]
            m = np.arange(nz)[None, :]
            mats["Wz"] = np.exp(-2j * np.pi * f * m / nz).astype(cdt)
            mats["iWz"] = (np.exp(2j * np.pi * m.T * f.T / nz) / nz
                           ).astype(cdt)
        self.mats = mats

    def _tridiag(self, rhs):
        """Solve per-mode tridiagonal systems; rhs is (mx, my, nz) complex
        (the Thomas coefficients are real, so a stacked re/im solve would
        also be valid — but the complex scan measures ~8% faster on the
        950 replay than scanning a stacked (2, ...) array, so `_solve_k`
        bridges stacked input to complex around this call)."""
        # forward: y_k = Af_k y_{k-1} + (rhs_k w_k)
        B = rhs * self.w
        Af = jnp.broadcast_to(self.Af, B.shape).astype(B.dtype)

        def combine(l, r):
            al, bl = l
            ar, br = r
            return al * ar, ar * bl + br

        zax = B.ndim - 1
        _, y = jax.lax.associative_scan(combine, (Af, B), axis=zax)
        # backward: x_k = (-cp_k) x_{k+1} + y_k  (scan reversed)
        Ab = jnp.broadcast_to(-self.cp, y.shape).astype(B.dtype)
        _, x = jax.lax.associative_scan(combine, (Ab, y), axis=zax,
                                        reverse=True)
        return x

    def _solve_k(self, F):
        """Vertical part of the modal solve: tridiagonal Thomas (BCzp==1,
        modpois.f90:552) or the z-cosine-transform diagonal divide (BCzp==2,
        modpois.f90:556-591).  Accepts (mx, my, nz) or stacked
        (2, mx, my, nz) input (z is always the last axis)."""
        if not self.bczp2:
            if F.ndim == 4 and not jnp.iscomplexobj(F):
                # stacked (re, im): run the scans complex (see _tridiag)
                X = self._tridiag(jax.lax.complex(F[0], F[1]))
                return jnp.stack([jnp.real(X), jnp.imag(X)])
            return self._tridiag(F)
        M = self.mats
        zax = F.ndim - 1
        G = _mm(F, M["Cz"], zax) * self.inv_lam_z2
        return _mm(G, M["iCz"], zax)

    def solve(self, rhs):
        """rhs (nx, ny, nz) -> pressure correction p (nx, ny, nz).

        Periodic-x/periodic-y path: rfft in x, fft in y, modal tridiag in k,
        inverse transforms. Sharding constraints re-create the z->x->y pencil
        dance of the reference when run on a mesh."""
        if not (self.per_x and self.per_y):
            return self._solve_neumann(rhs)
        cplx = jnp.complex64 if rhs.dtype == jnp.float32 else jnp.complex128
        xp = self._pencil("x")   # i local (x-pencil): P(None, 'y', 'x')
        yp = self._pencil("y")   # j local (y-pencil): P('x', None, 'y')
        zp = self._pencil("z")   # k local (z-pencil): P('x', 'y', None)
        M = self.mats
        if self.fft3d:
            # fully periodic: DFT(x) -> DFT(y) -> DFT(z) -> divide -> back
            F = xp(_mm(xp(rhs).astype(cplx), M["Rx"], 0))
            F = yp(_mm(yp(F), M["Wy"], 1))
            F = zp(_mm(zp(F), M["Wz"], 2))
            X = F * self.inv_lam3d
            X = zp(_mm(zp(X), M["iWz"], 2))
            X = yp(_mm(yp(X), M["iWy"], 1))
            p = jnp.real(xp(_mm(xp(X), M["iRx"], 0)))
            return zp(p).astype(rhs.dtype)
        # the complex DFTs run in real-pair form (stacked (re, im) planes,
        # _cmm/_fwd_r2c/_inv_c2r): a complex dot on a zero-imag input or a
        # real-part-only output wastes half its real matmuls, and the bf16
        # accumulation presets (UDALES_POIS_PREC=x3) only apply to real dots
        if self.diag_z:
            # fully diagonal: DCT(z) -> DFT(x) -> DFT(y) -> divide -> back
            G = zp(_mm(zp(rhs), M["Cz"], 2))
            S = xp(_fwd_r2c(xp(G), M["Rx_re"], M["Rx_im"], 0))
            S = yp(_cmm(S, M["Wy_re"], M["Wy_im"], 1))
            X = zp(S) * self.inv_lam3
            X = yp(_cmm(X, M["iWy_re"], M["iWy_im"], 1))
            Gp = _inv_c2r(xp(X), M["iRx_re"], M["iRx_im"], 0)
            p = zp(_mm(zp(Gp), M["iCz"], 2))
            return p.astype(rhs.dtype)
        # the per-pencil sharding constraints keep each transform axis local
        # (the reshards between pencils become all-to-alls, exactly the
        # 2DECOMP transposes of modpois.f90:459-548)
        S = xp(_fwd_r2c(xp(rhs), M["Rx_re"], M["Rx_im"], 0))
        S = yp(_cmm(S, M["Wy_re"], M["Wy_im"], 1))
        X = self._solve_k(zp(S))
        X = yp(_cmm(X, M["iWy_re"], M["iWy_im"], 1))
        p = _inv_c2r(xp(X), M["iRx_re"], M["iRx_im"], 0)
        return zp(p).astype(rhs.dtype)

    def _pencil(self, which: str):
        """Resharding constraint factory re-creating the 2DECOMP pencil
        transposes (modpois.f90:459-548) as GSPMD all-to-alls.  Identity when
        no mesh is attached (single-device)."""
        if self.mesh is None:
            return lambda x: x
        from jax.sharding import NamedSharding, PartitionSpec as P
        axes = {"x": (None, "y", "x"), "y": ("x", None, "y"),
                "z": ("x", "y", None)}[which]
        sh3 = NamedSharding(self.mesh, P(*axes))
        # stacked real-pair spectral fields carry a leading (re, im) axis
        sh4 = NamedSharding(self.mesh, P(None, *axes))
        return lambda x: jax.lax.with_sharding_constraint(
            x, sh4 if x.ndim == 4 else sh3)

    def _solve_neumann(self, rhs):
        """Inflow/outflow (Neumann) directions via DCT (modpois.f90 REDFT
        branches): DCT along each open direction, DFT along each periodic
        one, modal tridiagonal solve in k."""
        nx, ny, nz = self.grid.shape
        M = self.mats
        # forward: real transforms (DCT) first; the (at most one) complex
        # DFT runs in real-pair form (see solve())
        F = rhs if self.per_x else _mm(rhs, M["Cx"], 0)
        F = F if self.per_y else _mm(F, M["Cy"], 1)
        if self.per_x:
            S = _fwd_r2c(F, M["Rx_re"], M["Rx_im"], 0)
            X = _inv_c2r(self._solve_k(S), M["iRx_re"], M["iRx_im"], 0)
        elif self.per_y:
            S = _fwd_r2c(F, M["Wy_re"], M["Wy_im"], 1)
            X = _inv_c2r(self._solve_k(S), M["iWy_re"], M["iWy_im"], 1)
        else:
            X = self._solve_k(F)
        X = X if self.per_y else _mm(X, M["iCy"], 1)
        p = X if self.per_x else _mm(X, M["iCx"], 0)
        return p.astype(rhs.dtype)
