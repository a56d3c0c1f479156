"""Postprocessing — a full udbase analogue (tools/python/udbase.py).

The reference ships an xarray-based `UDBase` class for reading its NetCDF
outputs; the files this framework writes use the same family and variable
names, so the reference tooling works on them directly.  `UDPost` here is a
dependency-free (numpy + scipy) equivalent covering the same API surface:
case/geometry/facet loading, every output family, facet-property mapping,
area averages, SEB assembly, facet->field conversion, and frontal-area /
blockage diagnostics (udbase.py:37-1744).
"""
from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np
from scipy.io import netcdf_file


class NCData:
    """Dict-like view of one output file; arrays are returned in solver
    (x, y, z) order with a leading time axis."""

    def __init__(self, path: str | Path):
        self.path = str(path)
        self.f = netcdf_file(self.path, "r", mmap=False)
        self.time = np.array(self.f.variables["time"][:])
        self.dims = {k: v for k, v in self.f.dimensions.items()}

    def coords(self, name):
        return np.array(self.f.variables[name][:])

    def var(self, name):
        v = self.f.variables[name]
        a = np.array(v[:])
        if a.ndim == 4:              # (t, z, y, x) -> (t, x, y, z)
            a = a.transpose(0, 3, 2, 1)
        elif a.ndim == 3 and v.dimensions[1][0] in "zyx":
            a = a.transpose(0, 2, 1)
        return a

    def __getitem__(self, name):
        return self.var(name)

    def variables(self):
        return [k for k in self.f.variables if k not in
                ("time", "xt", "xm", "yt", "ym", "zt", "zm", "facet",
                 "layer")]

    def close(self):
        self.f.close()


def load_case_outputs(outdir: str | Path, expnr: str):
    """Open every output family present in a run directory."""
    outdir = Path(outdir)
    out = {}
    for fam in ("fielddump", "xytdump", "tdump", "mintdump", "xydump",
                "ytdump", "ydump", "tkedump", "treedump", "kslicedump",
                "islicedump", "jslicedump", "fac", "facT", "facEB"):
        p = outdir / f"{fam}.{expnr}.nc"
        if p.exists():
            out[fam] = NCData(p)
    return out


class UDPost:
    """Full postprocessing class for udales_jax (and reference) runs.

    Mirrors the reference `UDBase(expnr, path)` behavior
    (tools/python/udbase.py:60-184): reads namoptions, the grid, solid
    masks, facet data and facet sections from the case directory, and the
    NetCDF output families from `outdir` (defaults to the case directory).
    """

    def __init__(self, expnr: str | int, path: str | Path,
                 outdir: str | Path | None = None):
        self.expnr = f"{int(expnr):03d}" if not isinstance(expnr, str) \
            else expnr
        self.path = Path(path)
        self.outdir = Path(outdir) if outdir is not None else self.path
        self._read_namoptions()
        self._load_grid()
        self._load_facet_data()
        self._load_facet_sections()
        self._vis = None

    @property
    def vis(self):
        """Visualization front-end, mirroring the reference's `sim.vis`
        (tools/python/udvis/udbase_vis.py:37)."""
        if self._vis is None:
            from .vis import UDVis
            self._vis = UDVis(self)
        return self._vis

    # -- case inputs --------------------------------------------------------
    def _read_namoptions(self):
        from .config import load_namoptions
        self.cfg = load_namoptions(
            self.path / f"namoptions.{self.expnr}")
        dom = self.cfg.domain
        self.itot, self.jtot, self.ktot = dom.itot, dom.jtot, dom.ktot
        self.xlen, self.ylen = dom.xlen, dom.ylen
        self.nfcts = self.cfg.walls.nfcts
        self.nsv = self.cfg.scalars.nsv

    def _load_grid(self):
        """Grid coordinates from prof.inp (udbase._load_grid:298-342)."""
        from .grid import Grid
        self.grid = Grid.from_prof_inp(
            self.path / f"prof.inp.{self.expnr}", self.itot, self.jtot,
            self.ktot, self.xlen, self.ylen)
        g = self.grid
        self.xt, self.yt = np.asarray(g.xf), np.asarray(g.yf)
        self.zt = np.asarray(g.zf)
        self.dzt = np.asarray(g.dzf)
        self.dx = self.xlen / self.itot
        self.dy = self.ylen / self.jtot
        self.zsize = float(np.asarray(g.zh)[-1])

    def load_prof(self):
        from .io.inputs import read_prof_inp
        return read_prof_inp(self.path / f"prof.inp.{self.expnr}",
                             self.ktot)

    def load_lscale(self):
        from .io.inputs import read_lscale_inp
        return read_lscale_inp(self.path / f"lscale.inp.{self.expnr}",
                               self.ktot)

    def load_solid_masks(self):
        """0/1 solid masks per staggered grid (udbase:369-399)."""
        from .io.inputs import read_sparse_ijk
        out = {}
        for s in "uvwc":
            p = self.path / f"solid_{s}.txt"
            if not p.exists():
                continue
            m = np.zeros((self.itot, self.jtot, self.ktot), bool)
            ijk = read_sparse_ijk(p)
            if len(ijk):
                m[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = True
            out[s] = m
        return out

    def _load_facet_data(self):
        """facets.inp + factypes.inp + facetarea.inp (udbase:400-515)."""
        self.facets = self.facnorm = self.faca = self.factypes = None
        fp = self.path / f"facets.inp.{self.expnr}"
        if fp.exists():
            from .io.inputs import read_facets_inp, read_column_file
            self.facets, self.facnorm = read_facets_inp(fp)
            ap = self.path / f"facetarea.inp.{self.expnr}"
            if ap.exists():
                self.faca = read_column_file(ap)
        tp = self.path / f"factypes.inp.{self.expnr}"
        if tp.exists():
            ft = np.loadtxt(tp, skiprows=3, ndmin=2)
            self.factypes = {int(r[0]): r for r in ft}

    def _load_facet_sections(self):
        """facet_sections_* + fluid_boundary_* (udbase:516-557).  Each
        entry: facid (0-based), area, locs (0-based ijk), distance."""
        from .io.inputs import read_facet_sections, read_sparse_ijk
        self.facsec = {}
        for s in "uvwc":
            sp = self.path / f"facet_sections_{s}.txt"
            bp = self.path / f"fluid_boundary_{s}.txt"
            if not (sp.exists() and bp.exists()):
                continue
            try:
                fid, area, bnd, dist = read_facet_sections(sp)
                if len(fid) == 0:
                    continue
                pts = read_sparse_ijk(bp)
                self.facsec[s] = {
                    "facid": np.asarray(fid, int),
                    "area": np.asarray(area, float),
                    "locs": pts[np.asarray(bnd, int)],
                    "distance": np.asarray(dist, float),
                }
            except Exception as e:   # pragma: no cover - malformed inputs
                warnings.warn(f"facet sections {s}: {e}")

    def load_scalar_sources(self):
        """Point/line source tables (udbase:688-714)."""
        out = {"point": {}, "line": {}}
        for n in range(1, self.nsv + 1):
            pp = self.path / f"scalarsourcep.inp.{n}.{self.expnr}"
            lp = self.path / f"scalarsourcel.inp.{n}.{self.expnr}"
            if pp.exists():
                out["point"][n] = np.loadtxt(pp, skiprows=2, ndmin=2)
            if lp.exists():
                out["line"][n] = np.loadtxt(lp, skiprows=2, ndmin=2)
        return out

    def load_veg(self):
        """Vegetation cells + parameters (udbase:616-687)."""
        from .io.inputs import read_sparse_ijk
        vp = self.path / f"veg.inp.{self.expnr}"
        if not vp.exists():
            return None
        out = {"ijk": read_sparse_ijk(vp)}
        pp = self.path / f"veg_params.inp.{self.expnr}"
        if pp.exists():
            out["params"] = np.loadtxt(pp, skiprows=2, ndmin=2)
        sp = self.path / f"sveg.inp.{self.expnr}"
        if sp.exists():
            out["sveg"] = np.loadtxt(sp, skiprows=1, ndmin=1)
        return out

    # -- output families ----------------------------------------------------
    def _open(self, fam: str) -> NCData:
        p = self.outdir / f"{fam}.{self.expnr}.nc"
        if not p.exists():
            raise FileNotFoundError(p)
        return NCData(p)

    def load_field(self, var: str | None = None):
        """Instantaneous 3-D dumps (udbase.load_field:817)."""
        d = self._open("fielddump")
        return d if var is None else d[var]

    def load_stat_xyt(self, var: str | None = None):
        d = self._open("xytdump")
        return d if var is None else d[var]

    def load_stat_t(self, var: str | None = None):
        d = self._open("tdump")
        return d if var is None else d[var]

    def load_stat_tree(self, var: str | None = None):
        d = self._open("treedump")
        return d if var is None else d[var]

    def load_slice(self, plane: str, var: str | None = None):
        """k/i/j slice dumps (udbase.load_slice:908)."""
        d = self._open(f"{plane}slicedump")
        return d if var is None else d[var]

    def load_fac_momentum(self, var: str | None = None):
        d = self._open("fac")
        return d if var is None else d[var]

    def load_fac_temperature(self, var: str | None = None):
        d = self._open("facT")
        return d if var is None else d[var]

    def load_fac_eb(self, var: str | None = None):
        d = self._open("facEB")
        return d if var is None else d[var]

    def load_seb(self):
        """Assemble all SEB terms (udbase.load_seb:1033-1102).  Arrays are
        (nfcts, time) in the reference's sign convention."""
        eb = self._open("facEB")
        t = eb.time
        K = eb["netsw"].T
        Lin = eb["LWin"].T
        Lout = eb["LWout"].T
        H = eb["hf"].T
        E = eb["ef"].T
        fT = self._open("facT")
        T = fT["T"]            # (time, facet, layer) as written
        dTdz = fT["dTdz"]
        lam = self.assign_prop_to_fac("lam")
        G = -lam[None, :, 0] * dTdz[:, :, 0]     # (time, nfcts)
        return {
            "Kstar": K, "Lstar": Lin - Lout, "Lin": Lin, "Lout": Lout,
            "H": -H, "E": -E, "G": G.T, "Tsurf": T[:, :, 0].T, "t": t,
        }

    # -- facet utilities ----------------------------------------------------
    def assign_prop_to_fac(self, prop: str) -> np.ndarray:
        """Map a factypes property onto each facet
        (udbase.assign_prop_to_fac:1104-1176).  Scalar props return
        (nfcts,); layered props (d/C/lam) return (nfcts, nfaclyrs)."""
        if self.facets is None or self.factypes is None:
            raise ValueError("facets.inp / factypes.inp not loaded")
        L = self.cfg.eb.nfaclyrs
        scalar_cols = {"lGR": 1, "z0": 2, "z0h": 3, "al": 4, "em": 5}
        if prop in scalar_cols:
            c = scalar_cols[prop]
            return np.array([self.factypes[int(t)][c] for t in self.facets])
        layer_off = {"d": 6, "C": 6 + L, "lam": 6 + 2 * L}
        if prop not in layer_off:
            raise KeyError(prop)
        o = layer_off[prop]
        return np.array([[self.factypes[int(t)][o + j] for j in range(L)]
                         for t in self.facets])

    def area_average_fac(self, var: np.ndarray,
                         sel: np.ndarray | None = None) -> np.ndarray:
        """Area-weighted facet average (udbase.area_average_fac:1177).
        `var` is (nfcts,) or (nfcts, time); `sel` an optional facet mask or
        index array."""
        if self.faca is None:
            # facetarea.inp absent (it is a preprocessing output): fall back
            # to summed wetted c-section areas per facet, which equals the
            # facet area for grid-conforming geometry
            if "c" in self.facsec:
                fs = self.facsec["c"]
                a = np.zeros(self.nfcts)
                np.add.at(a, fs["facid"], fs["area"])
                a = np.where(a > 0, a, np.nan)
                a = np.where(np.isnan(a), np.nanmean(a), a)
                self.faca = a
            else:
                raise ValueError("facetarea.inp not loaded")
        a = self.faca
        v = np.asarray(var)
        if sel is not None:
            a = a[sel]
            v = v[sel]
        w = a / a.sum()
        return np.tensordot(w, v, axes=(0, 0))

    def area_average_seb(self, seb: dict) -> dict:
        out = {}
        for k, v in seb.items():
            if k == "t":
                out[k] = v
            else:
                out[k] = self.area_average_fac(v)
        return out

    @staticmethod
    def time_average(var: np.ndarray, t: np.ndarray | None = None,
                     axis: int = -1):
        """Trapezoid-weighted time mean (udbase.time_average:1291)."""
        v = np.asarray(var)
        if t is None or len(t) < 2:
            return v.mean(axis=axis)
        return np.trapezoid(v, t, axis=axis) / (t[-1] - t[0])

    @staticmethod
    def merge_stat(X, *args, Y=None, XpXp=None, XpYp=None):
        """Merge short-window statistics into longer windows
        (udbase.merge_stat:1296 -> udstats.merge_stat:53).  Patterns:
        ``(X, n)``, ``(X, XpXp, n)``, ``(X, Y, XpYp, n)`` and the keyword
        forms.  Variances/covariances combine the mean within-window
        contribution with the between-window variance of the short means
        (law of total variance); the oldest samples that do not fill a
        complete window are discarded."""
        return merge_stat(X, *args, Y=Y, XpXp=XpXp, XpYp=XpYp)

    @staticmethod
    def coarsegrain_field(var, Lflt, xm, ym):
        """2-D periodic box filter of a 3-D field
        (udbase.coarsegrain_field:1303 -> udstats.coarsegrain_field:166).
        Returns (nx, ny, nz, n_filters)."""
        return coarsegrain_field(var, Lflt, xm, ym)

    # -- facet <-> field conversion ----------------------------------------
    def convert_fac_to_field(self, var: np.ndarray, facsec=None,
                             grid_type: str = "c") -> np.ndarray:
        """Scatter per-facet values onto the 3-D grid; cells touched by
        several sections get the area-weighted mean
        (udbase.convert_fac_to_field:1379)."""
        fs = facsec or self.facsec.get(grid_type)
        if fs is None:
            raise ValueError("facet section data unavailable")
        num = np.zeros((self.itot, self.jtot, self.ktot))
        den = np.zeros_like(num)
        i, j, k = fs["locs"].T
        np.add.at(num, (i, j, k), np.asarray(var)[fs["facid"]] * fs["area"])
        np.add.at(den, (i, j, k), fs["area"])
        with np.errstate(invalid="ignore"):
            out = np.where(den > 0, num / np.maximum(den, 1e-300), np.nan)
        return out

    def convert_facflx_to_field(self, var: np.ndarray, facsec=None,
                                dz: np.ndarray | None = None) -> np.ndarray:
        """Facet fluxes -> volumetric density field: sum(var*area)/cellvol
        (udbase.convert_facflx_to_field:1478)."""
        fs = facsec or self.facsec.get("c")
        if fs is None:
            raise ValueError("facet section data unavailable")
        dz = self.dzt if dz is None else dz
        out = np.zeros((self.itot, self.jtot, self.ktot))
        i, j, k = fs["locs"].T
        np.add.at(out, (i, j, k), np.asarray(var)[fs["facid"]] * fs["area"])
        return out / (self.dx * self.dy * dz[None, None, :])

    def calculate_frontal_properties(self) -> dict:
        """Skylines, frontal areas, blockage ratios
        (udbase.calculate_frontal_properties:1602-1717)."""
        if self.facnorm is None:
            raise ValueError("facets.inp (normals) required")
        if "c" not in self.facsec:
            raise ValueError("facet_sections_c required")
        norms = np.asarray(self.facnorm, float)
        phix = -np.minimum(norms @ np.array([1.0, 0, 0]), 0)
        phiy = -np.minimum(norms @ np.array([0, 1.0, 0]), 0)
        rhoLx = self.convert_facflx_to_field(phix)
        rhoLy = self.convert_facflx_to_field(phiy)
        Ibx = (rhoLx.sum(axis=0) > 0).astype(float)   # (jtot, ktot)
        Iby = (rhoLy.sum(axis=1) > 0).astype(float)   # (itot, ktot)
        cellv = self.dx * self.dy * self.dzt[None, None, :]
        Afx = float((rhoLx * cellv).sum())
        Afy = float((rhoLy * cellv).sum())
        brx = float((Ibx * self.dy * self.dzt[None, :]).sum()
                    / (self.ylen * self.zsize))
        bry = float((Iby * self.dx * self.dzt[None, :]).sum()
                    / (self.xlen * self.zsize))
        return {"skylinex": Ibx, "skyliney": Iby, "Afx": Afx, "Afy": Afy,
                "brx": brx, "bry": bry}

    # -- misc ---------------------------------------------------------------
    def describe(self) -> str:
        lines = [
            f"UDPost(expnr={self.expnr}, path={self.path})",
            f"  grid: {self.itot} x {self.jtot} x {self.ktot}"
            f"  ({self.xlen} x {self.ylen} x {self.zsize} m)",
            f"  facets: {self.nfcts}, scalars: {self.nsv}",
            f"  facet sections: "
            + ", ".join(f"{k}:{len(v['facid'])}"
                        for k, v in self.facsec.items()),
        ]
        avail = [fam for fam in
                 ("fielddump", "xytdump", "tdump", "mintdump", "xydump",
                  "ytdump", "ydump", "tkedump", "treedump", "kslicedump",
                  "islicedump", "jslicedump", "fac", "facT", "facEB")
                 if (self.outdir / f"{fam}.{self.expnr}.nc").exists()]
        lines.append("  outputs: " + (", ".join(avail) or "(none)"))
        return "\n".join(lines)

    def __repr__(self):
        return self.describe()


# ---------------------------------------------------------------------------
# statistics utilities (udstats.py)
# ---------------------------------------------------------------------------

def merge_stat(X, *args, Y=None, XpXp=None, XpYp=None):
    """Merge short-term statistics into longer windows
    (tools/python/udstats.py:53-164 semantics; re-derivation).

    Positional patterns: ``(X, n)``, ``(X, XpXp, n)`` (MATLAB style),
    ``(X, Y, XpYp, n)``; or ``(X, n, XpXp=...)`` / ``(X, n, Y=...,
    XpYp=...)``.  The trailing axis is time.  Returns ``Xmean`` /
    ``(Xmean, var)`` / ``(Xmean, Ymean, cov)``: the merged second moments
    are mean(within-window contribution) + moment of the short means
    inside each merged window."""
    X = np.asarray(X)
    if len(args) == 1:
        n = int(args[0])
    elif len(args) == 2 and Y is None:
        XpXp = np.asarray(args[0])
        n = int(args[1])
    elif len(args) == 3:
        Y = np.asarray(args[0])
        XpYp = np.asarray(args[1])
        n = int(args[2])
    else:
        raise ValueError("merge_stat expects 1, 2, or 3 positional "
                         "arguments after X")
    if n <= 0:
        raise ValueError("n must be positive")
    if X.shape[-1] < n:
        raise ValueError("Not enough samples to form a single merged "
                         "window")
    nwin = X.shape[-1] // n
    start = X.shape[-1] - nwin * n     # drop the OLDEST incomplete window
    grp = lambda a: a[..., start:].reshape(*a.shape[:-1], nwin, n)
    Xg = grp(X)
    Xm = Xg.mean(axis=-1)
    if Y is None:
        if XpXp is None:
            return Xm
        XpXp = np.asarray(XpXp)
        if XpXp.shape[-1] != X.shape[-1]:
            raise ValueError("XpXp must match X in the last dimension")
        var = grp(XpXp).mean(axis=-1) \
            + ((Xg - Xm[..., None]) ** 2).mean(axis=-1)
        return Xm, var
    Y = np.asarray(Y)
    if Y.shape[-1] != X.shape[-1]:
        raise ValueError("X and Y must share the last dimension")
    Yg = grp(Y)
    Ym = Yg.mean(axis=-1)
    between = ((Xg - Xm[..., None]) * (Yg - Ym[..., None])).mean(axis=-1)
    if XpYp is None:
        return Xm, Ym, between
    XpYp = np.asarray(XpYp)
    if XpYp.shape[-1] != X.shape[-1]:
        raise ValueError("XpYp must match X and Y in the last dimension")
    return Xm, Ym, grp(XpYp).mean(axis=-1) + between


def coarsegrain_field(var, Lflt, xm, ym):
    """2-D periodic box filters of a 3-D field
    (tools/python/udstats.py:166-221 semantics): for each filter length L
    the kernel is the periodic half-width box round((L/dx)/2) (min 1
    cell), applied per level by FFT convolution.
    Returns (nx, ny, nz, n_filters)."""
    var = np.asarray(var)
    if var.ndim != 3:
        raise ValueError("var must be 3D with shape (nx, ny, nz)")
    xm = np.asarray(xm).ravel()
    ym = np.asarray(ym).ravel()
    if xm.size < 2 or ym.size < 2:
        raise ValueError("xm and ym must contain at least two points")
    dx = float(np.mean(np.diff(xm)))
    dy = float(np.mean(np.diff(ym)))
    if dx <= 0 or dy <= 0:
        raise ValueError("Grid spacings must be positive")
    L_arr = np.atleast_1d(Lflt)
    nx, ny, nz = var.shape
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    di = np.minimum(ii, nx - ii)
    dj = np.minimum(jj, ny - jj)
    out = np.empty((nx, ny, nz, len(L_arr)))
    vhat = np.fft.fftn(var, axes=(0, 1))
    for i, L in enumerate(L_arr):
        ngx = max(int(round((L / dx) / 2.0)), 1)
        ngy = max(int(round((L / dy) / 2.0)), 1)
        kernel = ((di <= ngx) & (dj <= ngy)).astype(float)
        kernel /= kernel.sum()
        khat = np.fft.fftn(kernel)
        out[..., i] = np.real(np.fft.ifftn(vhat * khat[:, :, None],
                                           axes=(0, 1)))
    return out
