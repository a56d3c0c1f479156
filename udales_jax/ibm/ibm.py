"""Immersed boundary method: solid masks, facet-section wall functions,
diffusion corrections.

Re-derivation of src/modibm.f90.  The reference keeps per-rank
sparse point lists and loops over them; here the static geometry is
precomputed on the host into

  - dense 0/1 fluid masks (mask_u/v/w/c; createmasks :2102 and initibm :150)
  - flat section arrays per staggered grid (facet id, area, boundary-point
    ijk, wall distance, static skip flags; initibmwallfun :273)

and the runtime operators are whole-array mask arithmetic plus
gather -> transfer-coefficient -> segment/scatter-add over sections
(wallfunmom :1286, wallfunheat :1436, diffu/v/w/c_corr :990-1164,
ibmnorm/solid :697-826).

The reconstruction-point path (lcomprec=false, initibmwallfun :384-533) is
fully static: for sections whose boundary point sits too deep in the
roughness layer (log(dist/z0) <= 1) the sampling point is moved out of the
cell along the facet normal at load time, and the trilinear interpolation
reduces to an 8-corner gather with precomputed indices and weights
(trilinear_interp_var :1609).  Setting `lnorec` in &WALLS skips those
sections instead, matching the reference switch.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config, const
from ..grid import Grid
from ..io.inputs import (read_column_file, read_facet_sections,
                         read_facets_inp, read_sparse_ijk)
from .wallfn import UMIN


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Masks:
    """Dense 0/1 fluid masks. u/v/c are cell-count shaped; w is face-shaped
    with face 0 (the domain floor) masked solid (modibm.f90:156, 2177)."""
    u: Any
    v: Any
    w: Any
    c: Any


@dataclass(frozen=True)
class SecData:
    """Facet sections for one staggered grid (static, host-side)."""
    ijk: np.ndarray      # (S,3) 0-based boundary-point indices
    area: np.ndarray     # (S,)
    dist: np.ndarray     # (S,) effective wall distance (incl. rec extension)
    fac: np.ndarray      # (S,) facet id, 0-based
    active: np.ndarray   # (S,) bool: not skipped (modibm.f90:371-380, 1364)
    rec: np.ndarray = None       # (S,) bool: sample at reconstruction point
    interp: dict = None          # grid key -> (idx (S,8,3), wgt (S,8))


def _tri_axis(coord, x, n, clamp=False):
    """Base index + fraction along one axis of a trilinear interpolation
    (initibmwallfun findloc calls, modibm.f90:432-451).

    ``coord`` is the 1-D coordinate array searched (with the reference's
    one ghost entry for cell-centre grids); field corner indices wrap
    periodically in x/y and clamp at the top in z."""
    i0 = np.searchsorted(coord, x, side="right") - 1
    ok = (i0 >= 0) & (i0 <= len(coord) - 2)
    i0c = np.clip(i0, 0, len(coord) - 2)
    t = (x - coord[i0c]) / (coord[i0c + 1] - coord[i0c])
    d = np.array([0, 1])
    idx = i0c[:, None] + d[None, :]
    idx = np.minimum(idx, n - 1) if clamp else idx % n
    return idx, np.clip(t, 0.0, 1.0), ok


def _reconstruction_data(ijk, dist, norms, z0, dir_align, grid):
    """Static reconstruction points + trilinear gather tables
    (initibmwallfun, modibm.f90:384-533).

    For each section: exit point of the segment (cell centre ->
    centre + n*sqrt(3)*(dx dy dz)^(1/3)) through the boundary cell's six
    faces, the extended wall distance, and per-staggered-grid corner
    indices/weights for trilinear interpolation at that point.  Returns
    (ok, recdist, interp)."""
    nx, ny, nz = grid.shape
    dx, dy = grid.dx, grid.dy
    dz0 = float(grid.j("dzf")[0])   # reference assumes equidistant z here
    xh, xf, yh, yf = grid.xh, grid.xf, grid.yh, grid.yf
    zf, zh = np.asarray(grid.j("zf")), np.asarray(grid.j("zh"))

    # staggered cell centre of the boundary point (p0)
    cgrid = {1: (xh, yf, zf), 2: (xf, yh, zf),
             3: (xf, yf, zh), 0: (xf, yf, zf)}[dir_align]
    p0 = np.stack([cgrid[0][ijk[:, 0]], cgrid[1][ijk[:, 1]],
                   cgrid[2][ijk[:, 2]]], axis=1)            # (S,3)
    L = np.sqrt(3.0) * (dx * dy * dz0) ** (1.0 / 3.0)
    seg = norms * L                                          # (S,3)

    # first intersection with the 6 cell-face planes (x +- dx/2 ...)
    half = np.array([dx / 2, dy / 2, dz0 / 2])
    t_best = np.full(len(ijk), np.inf)
    for ax in range(3):
        for sgn in (-1.0, 1.0):
            D = seg[:, ax]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (sgn * half[ax]) / D
            valid = (np.abs(D) > const.eps1) & (t >= 0.0) & (t <= 1.0)
            t_best = np.where(valid & (t < t_best), t, t_best)
    ok = np.isfinite(t_best)
    t_best = np.where(ok, t_best, 0.0)
    recpt = p0 + t_best[:, None] * seg                       # (S,3)
    recdist = dist + t_best * L

    # runtime guard made static (wallfunmom:1364): still too shallow -> skip
    with np.errstate(divide="ignore", invalid="ignore"):
        ok &= np.log(np.maximum(recdist, 1e-30)
                     / np.maximum(z0, 1e-30)) > 1.0

    # per-grid trilinear tables; x/y ghost centres mirror the reference's
    # halo cells (periodic), z gets one ghost centre above the domain
    xf_e = np.append(xf, xf[-1] + dx)
    yf_e = np.append(yf, yf[-1] + dy)
    zf_e = np.append(zf, zf[-1] + (zh[-1] - zf[-1]) * 2)
    axes = {"xh": (xh, nx, False), "xf": (xf_e, nx, False),
            "yh": (yh, ny, False), "yf": (yf_e, ny, False),
            "zf": (zf_e, nz, True), "zh": (zh, nz + 1, True)}
    grids = {"u": ("xh", "yf", "zf"), "v": ("xf", "yh", "zf"),
             "w": ("xf", "yf", "zh"), "c": ("xf", "yf", "zf")}
    interp = {}
    di = np.array([0, 0, 0, 0, 1, 1, 1, 1])
    dj = np.array([0, 0, 1, 1, 0, 0, 1, 1])
    dk = np.array([0, 1, 0, 1, 0, 1, 0, 1])
    for key, (ax, ay, az) in grids.items():
        ix, tx, okx = _tri_axis(axes[ax][0], recpt[:, 0], axes[ax][1],
                                clamp=axes[ax][2])
        iy, ty, oky = _tri_axis(axes[ay][0], recpt[:, 1], axes[ay][1],
                                clamp=axes[ay][2])
        iz, tz, okz = _tri_axis(axes[az][0], recpt[:, 2], axes[az][1],
                                clamp=axes[az][2])
        ok &= okx & oky & okz
        idx = np.stack([ix[:, di], iy[:, dj], iz[:, dk]], axis=2)  # (S,8,3)
        wx = np.stack([1 - tx, tx], 1)[:, di]
        wy = np.stack([1 - ty, ty], 1)[:, dj]
        wz = np.stack([1 - tz, tz], 1)[:, dk]
        interp[key] = (idx.astype(np.int32), wx * wy * wz)
    return ok, recdist, interp


class IBM:
    def __init__(self, cfg: Config, grid: Grid, masks: Masks,
                 sec_u: SecData, sec_v: SecData, sec_w: SecData,
                 sec_c: SecData, facnorm, facz0, facz0h, facT, faca,
                 bndpts_c: Optional[np.ndarray] = None, faclGR=None):
        self.cfg = cfg
        self.grid = grid
        self.masks = masks
        self.sec = {"u": sec_u, "v": sec_v, "w": sec_w, "c": sec_c}
        self.facnorm = facnorm       # (nfcts,3)
        self.facz0 = facz0
        self.facz0h = facz0h
        self.facT = jnp.asarray(facT, grid.dtype)  # evolves with EB later
        self.faca = faca
        self.nfcts = len(facz0)
        self.bndpts_c = bndpts_c
        self.faclGR_dev = (np.asarray(faclGR, bool) if faclGR is not None
                           else np.zeros(self.nfcts, bool))
        # profiling-only ablation switches (prof_urban.py): subsets of
        # {"mom", "heat", "diffcorr", "fill", "advcorr", "masks"} skip the
        # corresponding IBM term at TRACE time so a chained-scan A/B
        # attributes the urban step cost term by term.  Never set in
        # production; also settable via UDALES_ABLATE=term1,term2.
        self.ablate = frozenset(
            t for t in os.environ.get("UDALES_ABLATE", "").split(",") if t)
        # diffusion corrections folded into the main sweeps as {0,1} flux
        # masks (subgrid.diff_u docstring) — exact, one pass instead of
        # three; UDALES_NO_DIFFFOLD=1 restores the
        # separate correction passes (A/B + equivalence tests)
        self.fold_diffcorr = os.environ.get("UDALES_NO_DIFFFOLD") != "1"
        self._prep()

    # ------------------------------------------------------------------
    # Loading (initibm + initfac readers)
    # ------------------------------------------------------------------
    @classmethod
    def load(cls, case_dir: str | Path, expnr: str, cfg: Config, grid: Grid):
        case_dir = Path(case_dir)
        nx, ny, nz = grid.shape

        def mask_from(fname, shape, n_expected):
            m = np.ones(shape, np.float32)
            p = case_dir / fname
            if p.exists() and n_expected != 0:
                pts = read_sparse_ijk(p)
                m[pts[:, 0], pts[:, 1], pts[:, 2]] = 0.0
            return m

        w = cfg.walls
        mask_u = mask_from("solid_u.txt", (nx, ny, nz), w.nsolpts_u)
        mask_v = mask_from("solid_v.txt", (nx, ny, nz), w.nsolpts_v)
        mask_w = mask_from("solid_w.txt", (nx, ny, nz + 1), w.nsolpts_w)
        mask_c = mask_from("solid_c.txt", (nx, ny, nz), w.nsolpts_c)
        mask_w[:, :, 0] = 0.0   # floor faces always solid (modibm.f90:156)

        # facet data (initfac.readfacetfiles)
        walltype, facnorm = read_facets_inp(case_dir / f"facets.inp.{expnr}")
        ft = np.loadtxt(case_dir / f"factypes.inp.{expnr}", skiprows=3,
                        ndmin=2)
        # columns: wallid lGR z0 z0h al em ... (initfac.f90:166-193)
        typemap = {int(r[0]): r for r in ft}
        facz0 = np.array([typemap[int(t)][2] for t in walltype])
        facz0h = np.array([typemap[int(t)][3] for t in walltype])
        faca_p = case_dir / f"facetarea.inp.{expnr}"
        faca = (read_column_file(faca_p) if faca_p.exists()
                else np.ones(len(facz0)))
        tfac_p = case_dir / f"Tfacinit.inp.{expnr}"
        facT = (read_column_file(tfac_p) if tfac_p.exists()
                else np.full(len(facz0), cfg.bc.thls if cfg.bc.thls > 0
                             else 288.0))

        def load_sec(sfx, dir_align):
            bnd_p = case_dir / f"fluid_boundary_{sfx}.txt"
            sec_p = case_dir / f"facet_sections_{sfx}.txt"
            if not sec_p.exists():
                z = np.zeros(0)
                return SecData(np.zeros((0, 3), np.int64), z, z,
                               np.zeros(0, np.int64), z.astype(bool)), None
            bndpts = read_sparse_ijk(bnd_p)
            fac, area, bnd_id, dist = read_facet_sections(sec_p)
            ijk = bndpts[bnd_id]
            if sfx == "w":
                ijk = ijk.copy()  # Fortran w index k is face zh(k) = 0-based face k-1...
                # read_sparse_ijk already subtracted 1, so ijk[:,2] is the
                # 0-based face index directly (Fortran w(k) at zh(k)).
            # static skip logic (initibmwallfun:371-383 + wallfunmom:1364)
            norm_align = _alignment(facnorm[fac])
            skip = np.zeros(len(fac), bool)
            if dir_align != 0:
                skip |= (norm_align == dir_align)
            skip |= facz0[fac] < const.eps1
            with np.errstate(divide="ignore", invalid="ignore"):
                close = ~(np.log(np.maximum(dist, 1e-30)
                                 / facz0[fac]) > 1.0) & ~skip
            rec = np.zeros(len(fac), bool)
            interp = None
            dist_eff = dist
            if cfg.walls.lnorec or not close.any():
                skip |= close
            else:
                # reconstruction path (initibmwallfun:384-533)
                ok, recdist, interp = _reconstruction_data(
                    ijk, dist, facnorm[fac], facz0[fac], dir_align, grid)
                rec = close & ok
                skip |= close & ~ok
                dist_eff = np.where(rec, recdist, dist)
            return SecData(ijk=ijk, area=area, dist=dist_eff, fac=fac,
                           active=~skip, rec=rec, interp=interp), bndpts

        sec_u, _ = load_sec("u", 1)
        sec_v, _ = load_sec("v", 2)
        sec_w, _ = load_sec("w", 3)
        sec_c, bndpts_c = load_sec("c", 0)

        masks = Masks(u=jnp.asarray(mask_u, grid.dtype),
                      v=jnp.asarray(mask_v, grid.dtype),
                      w=jnp.asarray(mask_w, grid.dtype),
                      c=jnp.asarray(mask_c, grid.dtype))
        faclGR = np.array(
            [abs(typemap[int(t)][1] - 1.0) < 1e-5 for t in walltype])
        return cls(cfg, grid, masks, sec_u, sec_v, sec_w, sec_c,
                   facnorm, facz0, facz0h, facT, faca, bndpts_c,
                   faclGR=faclGR)

    def _prep(self):
        """Precompute the runtime layouts.

        The wall-function hot path is laid out DENSELY: each staggered grid
        gets `K = max sections per cell` stacked parameter fields shaped
        (K, nx, ny, nz[+1]) and the whole of wallfunmom/wallfunheat
        (modibm.f90:1286-1606) becomes masked vector arithmetic with zero
        runtime gathers.  Only reconstruction-point sections (rare; none in
        the shipped examples) stay on the sparse gather path in `self.dev`.
        Whether dense slots or gathers are faster on the H100 is not yet
        measured.
        """
        g = self.grid
        self.dev = {}
        self.dense = {}
        for name, s in self.sec.items():
            if len(s.fac) == 0:
                self.dev[name] = None
                self.dense[name] = None
                continue
            rec = s.rec if s.rec is not None else np.zeros(len(s.fac), bool)
            act = s.active & rec          # sparse path: rec sections only
            self.dense[name] = self._build_dense(name, s, s.active & ~rec)
            if not act.any():
                self.dev[name] = None
                continue
            d = dict(
                i=jnp.asarray(s.ijk[act, 0], jnp.int32),
                jj=jnp.asarray(s.ijk[act, 1], jnp.int32),
                k=jnp.asarray(s.ijk[act, 2], jnp.int32),
                area=jnp.asarray(s.area[act], g.dtype),
                dist=jnp.asarray(s.dist[act], g.dtype),
                fac=jnp.asarray(s.fac[act], jnp.int32),
                norm=jnp.asarray(self.facnorm[s.fac[act]], g.dtype),
                z0=jnp.asarray(self.facz0[s.fac[act]], g.dtype),
                z0h=jnp.asarray(self.facz0h[s.fac[act]], g.dtype),
            )
            # reconstruction-point gather tables (static; see module doc)
            if rec[act].any():
                d["rec"] = jnp.asarray(rec[act])
                for key, (idx, wgt) in s.interp.items():
                    d[f"rci_{key}"] = jnp.asarray(idx[act], jnp.int32)
                    d[f"rcw_{key}"] = jnp.asarray(wgt[act], g.dtype)
            self.dev[name] = d
        # static dense surface temperatures (used whenever no facet-EB state
        # overrides them); EB runs rebuild these via rebuild_dense_surf
        self._surf_static = {}
        for name, dn in self.dense.items():
            if dn is not None and "tsurf_static" in dn:
                self._surf_static[name] = dn.pop("tsurf_static")
        self._prep_pmasks()

    def params(self):
        """The large static parameter pytree, to be carried in State.ibmp.

        These arrays total O(100 MB)+ and MUST enter jitted functions as
        arguments — embedding them as closed-over constants blows up the
        serialized HLO and its compile time."""
        return {"dense": self.dense, "surf": self._surf_static}

    def _build_dense(self, which, s: SecData, act: np.ndarray):
        """Slot-stacked dense parameter fields for the non-rec sections of
        one staggered grid (the dense-slot layout of initibmwallfun's
        per-section lists, modibm.f90:273-383)."""
        if not act.any():
            return None
        g = self.grid
        nx, ny, nz = g.shape
        shape = (nx, ny, nz + 1) if which == "w" else (nx, ny, nz)
        N = int(np.prod(shape))
        ijk0 = s.ijk[act]
        area0 = s.area[act]
        dist0 = s.dist[act]
        fid0 = s.fac[act]
        flat0 = np.ravel_multi_index((ijk0[:, 0], ijk0[:, 1], ijk0[:, 2]),
                                     shape)

        # --- exact coplanar merge (K-slot compaction) --------------------
        # STL geometry triangulates every quad, so most multi-section cells
        # hold 2+ sections of the SAME plane (equal normal/dist/z0/z0h/
        # surface temperature); their wallfun contributions are linear in
        # area, so summing areas per (cell, plane) group is exact and cuts
        # the slot count K — the dense stacks cost K * n^3 HBM reads per
        # substep (the urban bench case carries K=5..6 with slot
        # occupancies 1.6%/0.2%/~0).  Under lEB facets evolve their own
        # temperatures, so merging only groups sections of identical facet
        # id there (i.e. no cross-facet merge).
        norms0 = self.facnorm[fid0]
        z0_0 = np.maximum(self.facz0[fid0], 1e-30)
        z0h_0 = np.maximum(self.facz0h[fid0], 1e-30)
        facT0 = np.asarray(self.facT)[fid0]
        cols = [flat0,
                np.round(norms0[:, 0], 6), np.round(norms0[:, 1], 6),
                np.round(norms0[:, 2], 6), np.round(dist0, 9),
                np.round(np.log(z0_0), 9), np.round(np.log(z0h_0), 9),
                np.round(facT0, 6)]
        if self.cfg.eb.lEB:
            cols.append(fid0)    # per-facet surf state: no cross-facet merge
        if which == "c" and self.cfg.physics.lmoist:
            cols.append(self.faclGR_dev[fid0].astype(np.float64))
        key = np.stack(cols, axis=1)
        _, first, grp = np.unique(key, axis=0, return_index=True,
                                  return_inverse=True)
        M = len(first)
        area = np.bincount(grp, weights=area0, minlength=M)
        ijk = ijk0[first]
        dist = dist0[first]
        fid = fid0[first]
        flat = flat0[first]

        order = np.argsort(flat, kind="stable")
        sf = flat[order]
        starts = np.r_[0, np.flatnonzero(np.diff(sf)) + 1]
        counts = np.diff(np.r_[starts, len(sf)])
        within = np.arange(len(sf)) - np.repeat(starts, counts)
        slot = np.empty(len(sf), np.int64)
        slot[order] = within
        K = int(counts.max())

        # --- K cap: route deep slots to a sparse tail --------------------
        # Real-city STL geometry can put 20+ distinct planes in one cell
        # (examples/950: K=19..22 -> 8.6 GB of stacks).
        # Slots >= KCAP become per-section vectors processed with ONE
        # gather (from the stacked interpolated fields the dense path
        # computes anyway) + ONE scatter-add per component per substep,
        # instead of streaming near-empty dense slots.  The default of 3
        # is not yet measured on the H100.
        KCAP = int(os.environ.get("UDALES_IBM_KCAP", "3"))
        tail_m = slot >= KCAP                     # over merged entries
        tail = None
        ijk_tail = None
        if tail_m.any():
            tm = tail_m
            ijk_tail = ijk[tm]
            kcell_t = (ijk[tm, 2] if which != "w"
                       else np.minimum(ijk[tm, 2], nz - 1))
            dzf_t = np.asarray(g.j("dzf"))[kcell_t]
            vol_t = g.dx * g.dy * dzf_t
            norms_t = self.facnorm[fid[tm]]
            z0_t = np.maximum(self.facz0[fid[tm]], 1e-30)
            z0h_t = np.maximum(self.facz0h[fid[tm]], 1e-30)
            logdz_t = np.log(np.maximum(dist[tm], 1e-30) / z0_t)
            j32 = lambda a: jnp.asarray(a, jnp.int32)
            jf = lambda a: jnp.asarray(a, g.dtype)
            tail = dict(
                fac=j32(fid[tm]),
                n0=jf(norms_t[:, 0]), n1=jf(norms_t[:, 1]),
                n2=jf(norms_t[:, 2]),
                area=jf(area[tm]), dist=jf(dist[tm]), logdz=jf(logdz_t),
                logzh=jf(np.log(z0_t / z0h_t)),
                ctm_neutral=jf((const.fkar / logdz_t) ** 2),
                tsurf=jf(np.asarray(self.facT)[fid[tm]]),
            )
            if which != "c":
                tail["avol"] = jf(area[tm] / vol_t)
            else:
                dzh_t = np.asarray(g.j("dzh"))[ijk[tm, 2]]
                tail["awgt"] = jf(area[tm] / (g.dx * g.dy * dzh_t))
                tail["areaK"] = jf(area[tm])
                if self.cfg.physics.lmoist:
                    tail["lGR"] = jf(
                        self.faclGR_dev[fid[tm]].astype(np.float64))
            # shrink the dense part to the kept slots
            keep_m = ~tail_m
            keep_sections = keep_m[grp]           # over original sections
            grp_keep = np.cumsum(keep_m) - 1      # merged -> kept position
            ijk, area, dist, fid, flat = (ijk[keep_m], area[keep_m],
                                          dist[keep_m], fid[keep_m],
                                          flat[keep_m])
            slot = slot[keep_m]
            grp = grp_keep[grp]                   # sections -> kept entries
            # (tail sections keep grp pointing at a kept slot only via
            # keep_sections gating below)
            K = min(K, KCAP)
        else:
            keep_sections = np.ones(len(grp), bool)

        # --- z-major slab layout ----------------------------------------
        # Sections only exist up to the tallest building, but z is the
        # minor (contiguous) dimension of the (K, nx, ny, nz) layout.
        # Storing the stacks as (K, kz, ny, nx) instead makes z a major
        # dim: the slab restriction cuts the streamed bytes by kz/nz —
        # the wall functions are bandwidth-bound on exactly these reads —
        # while nx stays the contiguous dim.  The interpolated fields are
        # transposed into this layout at run time (a few small copies).
        kz = int(ijk[:, 2].max()) + 1 if len(ijk) else 1
        kz = min(kz, shape[2])
        Nt = kz * ny * nx
        flat_t = np.ravel_multi_index(
            (ijk[:, 2], ijk[:, 1], ijk[:, 0]), (kz, ny, nx))
        if tail is not None:
            # tail cells are a subset of kept cells (a cell only overflows
            # into the tail once its first KCAP slots are kept), so every
            # tail index fits in the z-major slab — gathers/scatters then
            # run against the slab views the dense path materializes
            # anyway, and the FULL-field interpolated velocities never
            # materialize at all (a full-field gather would force them)
            tail["idx"] = jnp.asarray(np.ravel_multi_index(
                (ijk_tail[:, 2], ijk_tail[:, 1], ijk_tail[:, 0]),
                (kz, ny, nx)), jnp.int32)

        def densify(vals, pad):
            a = np.full((K, Nt), pad, np.float64)
            a[slot, flat_t] = vals
            return jnp.asarray(a.reshape((K, kz, ny, nx)), g.dtype)

        norms = self.facnorm[fid]
        z0 = np.maximum(self.facz0[fid], 1e-30)
        z0h = np.maximum(self.facz0h[fid], 1e-30)
        kcell = ijk[:, 2] if which != "w" else np.minimum(ijk[:, 2], nz - 1)
        dzf = np.asarray(g.j("dzf"))
        vol = g.dx * g.dy * dzf[kcell]
        logdz = np.log(np.maximum(dist, 1e-30) / z0)
        cfg = self.cfg
        # only the parameters the configured physics actually reads are
        # built — the stacks are O(100 MB) and every extra field costs HBM
        # bandwidth each substep (padding slots are encoded by avol/awgt=0)
        need_stab = (cfg.walls.iwallmom == 2 if which != "c"
                     else (cfg.walls.iwalltemp == 2
                           or (cfg.physics.lmoist
                               and cfg.walls.iwallmoist == 2)))
        d = dict(
            n0=densify(norms[:, 0], 0.0),
            n1=densify(norms[:, 1], 0.0),
            n2=densify(norms[:, 2], 0.0),
        )
        if which != "c":
            d["avol"] = densify(area / vol, 0.0)
        if need_stab:
            d["dist"] = densify(dist, 1.0)
            d["logdz"] = densify(logdz, 2.0)
            d["logzh"] = densify(np.log(z0 / z0h), 0.0)
            # sqdz = sqrt(dist/z0) is derived as exp(logdz/2) at run time —
            # one transcendental instead of a K*n^3 param read
            d["tsurf_static"] = densify(np.asarray(self.facT)[fid], 288.0)
        elif which != "c":
            d["ctm_neutral"] = densify((const.fkar / logdz) ** 2, 0.0)
        if cfg.eb.lEB:
            facid_d = np.zeros((K, Nt), np.int32)
            facid_d[slot, flat_t] = fid
            d["facid"] = jnp.asarray(facid_d.reshape((K, kz, ny, nx)))
            if "tsurf_static" not in d:
                d["tsurf_static"] = densify(np.asarray(self.facT)[fid], 288.0)
        if which == "c":
            dzh = np.asarray(g.j("dzh"))
            d["awgt"] = densify(area / (g.dx * g.dy * dzh[ijk[:, 2]]), 0.0)
            if cfg.physics.lmoist:
                # needed by both moisture modes: green-roof gating applies to
                # the fixed-flux (iwallmoist=1) branch too (modibm.f90:1555)
                d["lGR"] = densify(self.faclGR_dev[fid].astype(np.float64),
                                   0.0)
        if which == "c" or cfg.walls.lwritefac:
            # per-SECTION flat indices into the (K,)+shape slot stacks (the
            # unmerged list, each pointing at its merged slot with its own
            # area weight, so per-facet sums stay exact) — used for the
            # per-facet EB flux sums and the lwritefac facet-stress output
            # (one gather + one segment_sum, gated to substep 3).  Tail
            # sections are excluded here; their per-facet sums come from
            # the tail vectors directly (segment_sum over tail["fac"]).
            ks = keep_sections
            flat0_t = np.ravel_multi_index(
                (ijk0[ks, 2], ijk0[ks, 1], ijk0[ks, 0]), (kz, ny, nx))
            d["_hsec_idx"] = jnp.asarray(slot[grp[ks]] * Nt + flat0_t,
                                         jnp.int32)
            d["_hsec_fac"] = jnp.asarray(fid0[ks], jnp.int32)
            d["_hsec_area"] = jnp.asarray(area0[ks], g.dtype)
        if tail is not None:
            d["_tail"] = tail
        return d

    def rebuild_dense_surf(self, T1, qsat=None, hurel=None, f=None,
                           dense=None):
        """Dense surface-parameter stacks from evolving facet state (fired
        from the EB update; the gathers here are amortized over the dtEB
        interval)."""
        dense = dense if dense is not None else self.dense
        out = {}
        for which, dn in dense.items():
            if dn is not None and "facid" in dn:
                out[which] = T1[dn["facid"]].astype(T1.dtype)
            if dn is not None and "_tail" in dn:
                out["_tail_" + which] = T1[dn["_tail"]["fac"]].astype(
                    T1.dtype)
        dnc = dense.get("c")
        if dnc is not None and "facid" in dnc and qsat is not None:
            fid = dnc["facid"]
            out["qwall"] = qsat[fid]
            out["hurel"] = hurel[fid]
            out["resc"] = f[:, 3][fid]
            out["ress"] = f[:, 4][fid]
        return out

    def _prep_pmasks(self):
        # padded masks for neighbour logic (periodic x/y; k ghosts: bottom
        # solid, top fluid — modibm.f90:156-159)
        def padm(m, wface=False):
            mp = jnp.pad(m, ((1, 1), (1, 1), (0, 0)), mode="wrap")
            bot = jnp.zeros_like(mp[:, :, :1])
            top = jnp.ones_like(mp[:, :, :1])
            return jnp.concatenate([bot, mp, top], axis=2)
        self.pmask_u = padm(self.masks.u)
        self.pmask_v = padm(self.masks.v)
        self.pmask_c = padm(self.masks.c)
        # w: face array (nx,ny,nz+1); pad xy only + one top ghost (fluid)
        mw = jnp.pad(self.masks.w, ((1, 1), (1, 1), (0, 0)), mode="wrap")
        self.pmask_w = jnp.concatenate(
            [mw, jnp.ones_like(mw[:, :, :1])], axis=2)

        # --- z-major mask slabs for ibmnorm (solid_fill / advec corr) ----
        # Solids only exist up to the tallest building; like the wall-fn
        # stacks, these stencils are computed on a z-major slab
        # (kz, ny, nx) with periodic x/y as ROLLS (no wrap-padded copies
        # of the contiguous dim).  kz covers every non-fluid
        # point + 1 neighbour row.
        nz = self.grid.ktot
        solid_k = []
        for m in (self.masks.c, self.masks.u, self.masks.v, self.masks.w):
            s = np.asarray(m) < 0.5
            solid_k.append(int(np.argwhere(s)[:, 2].max()) if s.any()
                           else -1)
        kzs = max(solid_k) + 2
        if 0 < kzs <= nz - 1:
            self._kz_slab = kzs
            T = lambda a: jnp.transpose(a, (2, 1, 0))
            # c-mask slab with bottom ghost row (solid) + cells 0..kzs
            Mc = self.masks.c
            self._slab_Mc = jnp.concatenate(
                [jnp.zeros((1, Mc.shape[1], Mc.shape[0]), Mc.dtype),
                 T(Mc[:, :, : kzs + 1])], axis=0)
            Mu = self.masks.u
            self._slab_Mu = jnp.concatenate(
                [jnp.zeros((1, Mu.shape[1], Mu.shape[0]), Mu.dtype),
                 T(Mu[:, :, : kzs + 1])], axis=0)
            Mv = self.masks.v
            self._slab_Mv = jnp.concatenate(
                [jnp.zeros((1, Mv.shape[1], Mv.shape[0]), Mv.dtype),
                 T(Mv[:, :, : kzs + 1])], axis=0)
            # w faces 0..kzs+1 (face kzs+1 exists since kzs <= nz-1)
            self._slab_Mw = T(self.masks.w[:, :, : kzs + 2])
        else:
            self._kz_slab = None

    # ------------------------------------------------------------------
    # Initial conditions
    # ------------------------------------------------------------------
    def apply_initial_masks(self, f):
        import dataclasses
        return dataclasses.replace(
            f, u=f.u * self.masks.u, v=f.v * self.masks.v,
            w=f.w * self.masks.w)

    # ------------------------------------------------------------------
    # Wall functions (ibmwallfun)
    # ------------------------------------------------------------------
    def wallfun(self, g, c, grid: Grid, cfg: Config,
                du, dv, dw, dthl, dqt, dsv, fac=None, bctf=None,
                need_fac: bool = False, ibmp=None,
                need_facstats: bool = False, pres=None):
        """Facet-section wall stresses + heat fluxes + diffusion corrections
        (modibm.f90:1167-1283).

        Returns tendencies + per-facet flux sums fachf/facef ((nfcts,) or
        None unless `need_fac`) + domain-total sensible/latent wall fluxes
        hf_tot/ef_tot (always; for periodicEBcorr) + the lwritefac facet
        diagnostics dict (None unless `need_facstats`; modibm.f90:1416-1430,
        1475-1476, 1539-1540).  Hot path is fully dense (see `_prep`); the
        sparse path only covers reconstruction-point sections."""
        facT = fac.T[:, 0] if fac is not None else self.facT
        ibmp = ibmp if ibmp is not None else self.params()
        dense = ibmp["dense"]
        surf = (fac.dense if fac is not None
                and getattr(fac, "dense", None) is not None
                else ibmp["surf"])
        fachf = facef = None
        zt = jnp.zeros((), c.u.dtype)
        hf_tot, ef_tot = zt, zt
        fstats = {} if need_facstats else None
        if cfg.walls.iwallmom > 1 and "mom" not in self.ablate:
            if need_facstats:
                # fac_tau_{x,y,z}: per-facet signed stress sums / facet area
                for which, key in (("u", "tau_x"), ("v", "tau_y"),
                                   ("w", "tau_z")):
                    t, slots, tsum = self._wallfunmom_dense(
                        which, g, cfg, surf, dense, ret_slots=True)
                    if which == "u":
                        du = du + t
                    elif which == "v":
                        dv = dv + t
                    else:
                        dw = dw + t
                    fsum = (jnp.zeros(self.nfcts, c.u.dtype)
                            if slots is None else
                            self._facsum(dense[which], slots))
                    if tsum is not None:
                        fsum = fsum + tsum
                    fstats[key] = fsum / self.faca
            else:
                du = du + self._wallfunmom_dense("u", g, cfg, surf, dense)
                dv = dv + self._wallfunmom_dense("v", g, cfg, surf, dense)
                dw = dw + self._wallfunmom_dense("w", g, cfg, surf, dense)
            for which, add in (("u", 0), ("v", 1), ("w", 2)):
                if self.dev[which] is not None:
                    t = self._wallfunmom(which, c, grid, cfg, facT)
                    if add == 0:
                        du = du + t
                    elif add == 1:
                        dv = dv + t
                    else:
                        dw = dw + t
        if "diffcorr" not in self.ablate and not self.fold_diffcorr:
            du = du + self._diffu_corr(g, grid)
            dv = dv + self._diffv_corr(g, grid)
            dw = dw + self._diffw_corr(g, grid)
        if (cfg.physics.ltempeq or cfg.physics.lmoist) \
                and "heat" not in self.ablate:
            (hthl, hqt, hf_tot, ef_tot, fachf, facef,
             heat_slots) = self._wallfunheat_dense(
                g, c, cfg, surf, dense, fac, bctf, need_fac,
                ret_slots=need_facstats)
            dthl = dthl + hthl
            dqt = dqt + hqt
            if need_facstats and heat_slots is not None:
                dnc = dense["c"]
                for key in ("htc", "cth"):
                    fstats[key] = (self._facsum(dnc, heat_slots[key])
                                   / self.faca)
            if self.dev["c"] is not None:
                sthl, sqt, sfhf, sfef = self._wallfunheat(
                    c, grid, cfg, facT, fac, bctf)
                dthl = dthl + sthl
                dqt = dqt + sqt
                hf_tot = hf_tot + jnp.sum(sfhf)
                ef_tot = ef_tot + jnp.sum(sfef)
                if need_fac:
                    fachf = fachf + sfhf
                    facef = facef + sfef
            sep = "diffcorr" not in self.ablate and not self.fold_diffcorr
            if cfg.physics.ltempeq and sep:
                dthl = dthl + self._diffc_corr(g.thl, g.ekh, grid)
            if cfg.physics.lmoist and sep:
                dqt = dqt + self._diffc_corr(g.qt, g.ekh, grid)
        if dsv.shape[0] > 0 and not self.fold_diffcorr:
            gsv1 = jax.vmap(lambda s: s[1:-1, 1:-1, 1:-1])(g.sv)
            dsv = dsv + jax.vmap(
                lambda gc: self._diffc_corr(gc, g.ekh, grid))(gsv1)
        if need_facstats:
            # fac_pres/fac_pres2: pres0 at the c-section cells
            # (modibm.f90:1475-1476)
            dnc = dense.get("c")
            nf = self.nfcts
            zf = jnp.zeros(nf, c.u.dtype)
            if dnc is not None and pres is not None:
                N = int(np.prod(pres.shape))
                pcell = pres.ravel()[dnc["_hsec_idx"] % N]
                pa = jax.ops.segment_sum(
                    pcell * dnc["_hsec_area"], dnc["_hsec_fac"],
                    num_segments=nf)
                p2a = jax.ops.segment_sum(
                    pcell * pcell * dnc["_hsec_area"], dnc["_hsec_fac"],
                    num_segments=nf)
                fstats["pres"] = (pa / self.faca).astype(c.u.dtype)
                fstats["pres2"] = (p2a / self.faca).astype(c.u.dtype)
            else:
                fstats["pres"] = zf
                fstats["pres2"] = zf
            for key in ("tau_x", "tau_y", "tau_z", "htc", "cth"):
                fstats.setdefault(key, zf)
        return (du, dv, dw, dthl, dqt, dsv, fachf, facef, hf_tot, ef_tot,
                fstats)

    def _facsum(self, dn, slots):
        """Per-facet area-weighted sum of a (K,)+shape slot stack."""
        vals = slots.ravel()[dn["_hsec_idx"]] * dn["_hsec_area"]
        return jax.ops.segment_sum(vals, dn["_hsec_fac"],
                                   num_segments=self.nfcts)

    # -- dense hot path ---------------------------------------------------
    def _dense_uvwT(self, which, g, grid: Grid):
        """Dense interpolated velocity vector + air temperature at every
        point of one staggered grid (the stencil form of
        interp_velocity_*/interp_temperature_*, modibm.f90:1737-1829)."""
        from functools import partial
        from ..ops.stencil import sh
        nx, ny, nz = grid.shape
        S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
        W = lambda di, dj, dk: g.w[1 + di: 1 + di + nx,
                                   1 + dj: 1 + dj + ny, dk: dk + nz]
        Mc = self.pmask_c
        thl = g.thl if g.thl is not None else None

        def Tpair(t0, t1, m0, m1):
            if thl is None:
                return jnp.full_like(m0, 288.0)
            return 0.5 * (t0 * m0 * (2.0 - m1) + t1 * m1 * (2.0 - m0))

        if which == "u":
            uu = S(g.u, 0, 0, 0)
            vv = 0.25 * (S(g.v, 0, 0, 0) + S(g.v, 0, 1, 0)
                         + S(g.v, -1, 0, 0) + S(g.v, -1, 1, 0))
            ww = 0.25 * (W(0, 0, 0) + W(0, 0, 1) + W(-1, 0, 0) + W(-1, 0, 1))
            Ta = Tpair(S(thl, 0, 0, 0) if thl is not None else None,
                       S(thl, -1, 0, 0) if thl is not None else None,
                       S(Mc, 0, 0, 0), S(Mc, -1, 0, 0))
        elif which == "v":
            uu = 0.25 * (S(g.u, 0, 0, 0) + S(g.u, 1, 0, 0)
                         + S(g.u, 0, -1, 0) + S(g.u, 1, -1, 0))
            vv = S(g.v, 0, 0, 0)
            ww = 0.25 * (W(0, 0, 0) + W(0, 0, 1) + W(0, -1, 0) + W(0, -1, 1))
            Ta = Tpair(S(thl, 0, 0, 0) if thl is not None else None,
                       S(thl, 0, -1, 0) if thl is not None else None,
                       S(Mc, 0, 0, 0), S(Mc, 0, -1, 0))
        elif which == "w":
            # face-shaped (nx, ny, nz+1): cell kc=min(k,nz-1), kmc=max(k-1,0)
            ext_top = lambda X: jnp.concatenate([X, X[:, :, -1:]], axis=2)
            ext_bot = lambda X: jnp.concatenate([X[:, :, :1], X], axis=2)
            uu_c = 0.25 * (S(g.u, 0, 0, 0) + S(g.u, 1, 0, 0)
                           + S(g.u, 0, -1, 0) + S(g.u, 1, -1, 0))
            uu = ext_top(uu_c)
            vv = ext_top(S(g.v, 0, 0, 0))
            wfull = lambda di, dj: g.w[1 + di: 1 + di + nx,
                                       1 + dj: 1 + dj + ny, :]
            w0 = wfull(0, 0)
            wjm = wfull(0, -1)
            wkp = jnp.concatenate([w0[:, :, 1:], w0[:, :, -1:]], axis=2)
            wjmkp = jnp.concatenate([wjm[:, :, 1:], wjm[:, :, -1:]], axis=2)
            ww = 0.25 * (w0 + wkp + wjm + wjmkp)
            m_kc = ext_top(S(Mc, 0, 0, 0))
            m_kmc = ext_bot(S(Mc, 0, 0, 0))
            if thl is None:
                Ta = jnp.full_like(m_kc, 288.0)
            else:
                t = S(thl, 0, 0, 0)
                Ta = Tpair(ext_top(t), ext_bot(t), m_kc, m_kmc)
        else:  # c
            uu = 0.5 * (S(g.u, 0, 0, 0) + S(g.u, 1, 0, 0))
            vv = 0.5 * (S(g.v, 0, 0, 0) + S(g.v, 0, 1, 0))
            ww = 0.5 * (W(0, 0, 0) + W(0, 0, 1))
            Ta = (S(thl, 0, 0, 0) if thl is not None
                  else jnp.full((nx, ny, nz), 288.0, g.u.dtype))
        return uu, vv, ww, Ta

    @staticmethod
    def _dense_tangent(dn, uu, vv, ww):
        """Per-slot streamwise unit vector + tangential speed (the cross
        products of wallfunmom, modibm.f90:1330-1350) by broadcasting the
        (X,Y,Z) velocity fields against the (K,X,Y,Z) facet normals."""
        n0, n1, n2 = dn["n0"], dn["n1"], dn["n2"]
        sx = n1 * ww - n2 * vv
        sy = n2 * uu - n0 * ww
        sz = n0 * vv - n1 * uu
        sn = jnp.sqrt(sx * sx + sy * sy + sz * sz)
        ok = sn > const.eps1
        sni = 1.0 / jnp.maximum(sn, const.eps1)
        sx, sy, sz = sx * sni, sy * sni, sz * sni
        tx = sy * n2 - sz * n1
        ty = sz * n0 - sx * n2
        tz = sx * n1 - sy * n0
        utan = tx * uu + ty * vv + tz * ww
        return (tx, ty, tz), utan, ok

    def _wallfunmom_dense(self, which, g, cfg: Config, surf, dense,
                          ret_slots: bool = False):
        """Dense wallfunmom (modibm.f90:1286-1433): K-slot masked arithmetic,
        no gathers/scatters.  With `ret_slots` also returns the per-slot
        signed stress (for the lwritefac facet output)."""
        grid = self.grid
        nx, ny, nz = grid.shape
        dtype = g.u.dtype
        shape = (nx, ny, nz + 1) if which == "w" else (nx, ny, nz)
        dn = dense[which]
        if dn is None:
            z = jnp.zeros(shape, dtype)
            return (z, None, None) if ret_slots else z
        uu, vv, ww, Ta = self._dense_uvwT(which, g, grid)
        # z-major slab views of the interpolated fields (see _build_dense:
        # the stacks are (K, kz, ny, nx) so only the building slab streams)
        kz = dn["n0"].shape[1]
        T = lambda a: jnp.transpose(a[:, :, :kz], (2, 1, 0))
        uu_s, vv_s, ww_s, Ta_s = T(uu), T(vv), T(ww), T(Ta)
        (tx, ty, tz), utan, ok = self._dense_tangent(dn, uu_s, vv_s, ww_s)
        if cfg.walls.iwallmom == 2:
            ctm = _mom_coef_stability_pre(
                utan, dn["dist"], dn["logdz"], dn["logzh"],
                jnp.exp(0.5 * dn["logdz"]), Ta_s, surf[which],
                cfg.walls.prandtlturb)
        else:
            ctm = dn["ctm_neutral"]
        stress = ctm * utan * utan
        a = {"u": tx, "v": ty, "w": tz}[which]
        ua = {"u": uu_s, "v": vv_s, "w": ww_s}[which]
        stress_dir = jnp.sign(ua) * jnp.abs(a * stress)
        # padding slots carry avol=0, so `ok` alone masks the rest
        contrib = jnp.where(ok, -stress_dir * dn["avol"], 0.0)
        slab_sum = jnp.sum(contrib, axis=0)            # (kz, ny, nx)
        tail_facsum = None
        if "_tail" in dn:
            # tail gathers/scatters stay in slab space (tail["idx"] is
            # slab-flat, _build_dense) — the full interpolated fields are
            # never materialized
            t = dn["_tail"]
            tvals = self._tail_fields(t, uu_s, vv_s, ww_s, Ta_s)
            sdir_t, ok_t = self._tail_stress(
                which, t, tvals, cfg, surf.get("_tail_" + which))
            add = jnp.where(ok_t, -sdir_t * t["avol"], 0.0)
            slab_sum = slab_sum.reshape(-1).at[t["idx"]].add(add).reshape(
                slab_sum.shape)
            if ret_slots:
                # tail sections' contribution to the lwritefac per-facet
                # stress sums (the dense slots only cover kept sections)
                tail_facsum = jax.ops.segment_sum(
                    jnp.where(ok_t, sdir_t, 0.0) * t["area"], t["fac"],
                    num_segments=self.nfcts).astype(dtype)
        out_s = jnp.transpose(slab_sum, (2, 1, 0))
        out = jnp.pad(out_s, ((0, 0), (0, 0), (0, shape[2] - kz))
                      ).astype(dtype)
        if ret_slots:
            return out, jnp.where(ok, stress_dir, 0.0), tail_facsum
        return out

    @staticmethod
    def _tail_fields(t, uu, vv, ww, Ta):
        """One gather for all four interpolated fields at the tail cells."""
        S = jnp.stack([uu.reshape(-1), vv.reshape(-1), ww.reshape(-1),
                       Ta.reshape(-1)])
        return S[:, t["idx"]]

    @staticmethod
    def _tail_tangent(t, tvals):
        """Streamwise unit vector + tangential speed for the tail vectors
        (1-D form of `_dense_tangent`)."""
        uu, vv, ww, _ = tvals
        sx = t["n1"] * ww - t["n2"] * vv
        sy = t["n2"] * uu - t["n0"] * ww
        sz = t["n0"] * vv - t["n1"] * uu
        sn = jnp.sqrt(sx * sx + sy * sy + sz * sz)
        ok = sn > const.eps1
        sni = 1.0 / jnp.maximum(sn, const.eps1)
        sx, sy, sz = sx * sni, sy * sni, sz * sni
        txv = sy * t["n2"] - sz * t["n1"]
        tyv = sz * t["n0"] - sx * t["n2"]
        tzv = sx * t["n1"] - sy * t["n0"]
        utan = txv * uu + tyv * vv + tzv * ww
        return (txv, tyv, tzv), utan, ok

    def _tail_stress(self, which, t, tvals, cfg, tsurf_live=None):
        """Per-tail-section signed stress (the vector form of the dense
        slot math; same formulas)."""
        uu, vv, ww, Ta = tvals
        (txv, tyv, tzv), utan, ok = self._tail_tangent(t, tvals)
        if cfg.walls.iwallmom == 2:
            Ts = tsurf_live if tsurf_live is not None else t["tsurf"]
            ctm = _mom_coef_stability_pre(
                utan, t["dist"], t["logdz"], t["logzh"],
                jnp.exp(0.5 * t["logdz"]), Ta, Ts, cfg.walls.prandtlturb)
        else:
            ctm = t["ctm_neutral"]
        stress = ctm * utan * utan
        a = {"u": txv, "v": tyv, "w": tzv}[which]
        ua = {"u": uu, "v": vv, "w": ww}[which]
        return jnp.sign(ua) * jnp.abs(a * stress), ok

    def _wallfunheat_dense(self, g, c, cfg: Config, surf, dense, fac, bctf,
                           need_fac, ret_slots: bool = False):
        """Dense wallfunheat (modibm.f90:1436-1606). Returns
        (dthl, dqt, hf_tot, ef_tot, fachf, facef, heat_slots)."""
        grid = self.grid
        nx, ny, nz = grid.shape
        dtype = c.thl.dtype
        zfld = jnp.zeros((nx, ny, nz), dtype)
        zt = jnp.zeros((), dtype)
        nf0 = jnp.zeros(self.nfcts, dtype) if need_fac else None
        dn = dense["c"]
        if dn is None:
            return zfld, zfld, zt, zt, nf0, nf0, None
        uu, vv, ww, Ta = self._dense_uvwT("c", g, grid)
        # z-major slab views (see _build_dense / _wallfunmom_dense)
        kz = dn["n0"].shape[1]
        Tz = lambda a: jnp.transpose(a[:, :, :kz], (2, 1, 0))
        uu_s, vv_s, ww_s, Ta_s = Tz(uu), Tz(vv), Tz(ww), Tz(Ta)
        _, utan, ok = self._dense_tangent(dn, uu_s, vv_s, ww_s)
        valid = ok  # padding slots carry awgt=0/area=0
        dzh_k = jnp.asarray(grid.j("dzh"))[:kz][None, :, None, None]
        areaK = dn["awgt"] * (grid.dx * grid.dy) * dzh_k
        dthl, dqt = zfld, zfld
        hf_tot, ef_tot = zt, zt
        fachf, facef = nf0, nf0
        fl = None
        mfl = None
        htc = jnp.zeros_like(utan)
        cth = jnp.zeros_like(utan)
        if cfg.physics.ltempeq:
            if cfg.walls.iwalltemp == 1:
                # fixed flux per orientation (modibm.f90:1519-1535; the
                # reference assigns bctfxm for -yhat too — kept)
                if bctf is None:
                    bxm, bxp, bym, byp, bz = (cfg.bc.bctfxm, cfg.bc.bctfxp,
                                              cfg.bc.bctfym, cfg.bc.bctfyp,
                                              cfg.bc.bctfz)
                else:
                    bxm, bxp, bym, byp, bz = bctf
                n0, n1, n2 = dn["n0"], dn["n1"], dn["n2"]
                e = const.eps1
                flux = jnp.where(jnp.abs(n0 - 1) < e, bxp,
                        jnp.where(jnp.abs(n0 + 1) < e, bxm,
                        jnp.where(jnp.abs(n1 - 1) < e, byp,
                        jnp.where(jnp.abs(n1 + 1) < e, bxm,
                        jnp.where(jnp.abs(n2 - 1) < e, bz, 0.0)))))
                flux = flux * jnp.ones_like(utan)
                cth = jnp.zeros_like(utan)
            else:
                cth, flux, htc = _heat_coef_flux_pre(
                    utan, dn["dist"], dn["logdz"], dn["logzh"],
                    jnp.exp(0.5 * dn["logdz"]), Ta_s, surf["c"],
                    cfg.walls.prandtlturb)
            fl = jnp.where(valid, flux, 0.0)
            thl_acc = -jnp.sum(fl * dn["awgt"], axis=0)    # (kz, ny, nx)
            hf_tot = jnp.sum(fl * areaK).astype(dtype)
        else:
            thl_acc = None

        # latent heat on green-roof facets (modibm.f90:1555-1589)
        if (cfg.physics.lmoist and cfg.walls.iwallmoist == 1
                and "lGR" in dn):
            # fixed moisture flux per orientation (modibm.f90:1556-1568)
            b = cfg.bc
            n0, n1, n2 = dn["n0"], dn["n1"], dn["n2"]
            e = const.eps1
            mflux = jnp.where(jnp.abs(n0 - 1) < e, b.bcqfxp,
                     jnp.where(jnp.abs(n0 + 1) < e, b.bcqfxm,
                     jnp.where(jnp.abs(n1 - 1) < e, b.bcqfyp,
                     jnp.where(jnp.abs(n1 + 1) < e, b.bcqfym,
                     jnp.where(jnp.abs(n2 - 1) < e, b.bcqfz, 0.0)))))
            mfl = jnp.where(valid & (dn["lGR"] > 0.0),
                            mflux * jnp.ones_like(utan), 0.0)
            qt_acc = -jnp.sum(mfl * dn["awgt"], axis=0)
            ef_tot = jnp.sum(mfl * areaK).astype(dtype)
        elif (cfg.physics.lmoist and fac is not None
                and cfg.walls.iwallmoist == 2 and "qwall" in surf):
            qtair = 0.0 * utan + Tz(g.qt[1:-1, 1:-1, 1:-1])
            qwall, hurel = surf["qwall"], surf["hurel"]
            resa = 1.0 / jnp.maximum(htc * jnp.abs(utan), 1e-10)
            resc, ress = surf["resc"], surf["ress"]
            cveg = 0.8
            mflux = jnp.minimum(
                0.0, cveg * (qtair - qwall) / (resa + resc)
                + (1.0 - cveg) * (qtair - qwall * hurel) / (resa + ress))
            mfl = jnp.where(valid & (dn["lGR"] > 0.0)
                            & (htc * jnp.abs(utan) > 0.0), mflux, 0.0)
            qt_acc = -jnp.sum(mfl * dn["awgt"], axis=0)
            ef_tot = jnp.sum(mfl * areaK).astype(dtype)
        else:
            qt_acc = None

        # sparse tail sections (K-cap overflow of real-city geometry)
        fl_t = mfl_t = None
        t = dn.get("_tail")
        if t is not None:
            # slab-space tail (see _wallfunmom_dense): gathers read the
            # transposed slab views, scatters land in the slab accumulators
            tvals = self._tail_fields(t, uu_s, vv_s, ww_s, Ta_s)
            uu_t, vv_t, ww_t, Ta_t = tvals
            _, utan_t, ok_t = self._tail_tangent(t, tvals)
            htc_t = jnp.zeros_like(utan_t)
            if cfg.physics.ltempeq:
                if cfg.walls.iwalltemp == 1:
                    e = const.eps1
                    flux_t = jnp.where(jnp.abs(t["n0"] - 1) < e, bxp,
                              jnp.where(jnp.abs(t["n0"] + 1) < e, bxm,
                              jnp.where(jnp.abs(t["n1"] - 1) < e, byp,
                              jnp.where(jnp.abs(t["n1"] + 1) < e, bxm,
                              jnp.where(jnp.abs(t["n2"] - 1) < e, bz,
                                        0.0))))) * jnp.ones_like(utan_t)
                else:
                    Ts = surf.get("_tail_c")
                    Ts = Ts if Ts is not None else t["tsurf"]
                    _, flux_t, htc_t = _heat_coef_flux_pre(
                        utan_t, t["dist"], t["logdz"], t["logzh"],
                        jnp.exp(0.5 * t["logdz"]), Ta_t, Ts,
                        cfg.walls.prandtlturb)
                fl_t = jnp.where(ok_t, flux_t, 0.0)
                thl_acc = thl_acc.reshape(-1).at[t["idx"]].add(
                    -fl_t * t["awgt"]).reshape(thl_acc.shape)
                hf_tot = hf_tot + jnp.sum(fl_t * t["areaK"]).astype(dtype)
            if (cfg.physics.lmoist and cfg.walls.iwallmoist == 1
                    and "lGR" in t):
                b = cfg.bc
                e = const.eps1
                mflux_t = jnp.where(jnp.abs(t["n0"] - 1) < e, b.bcqfxp,
                           jnp.where(jnp.abs(t["n0"] + 1) < e, b.bcqfxm,
                           jnp.where(jnp.abs(t["n1"] - 1) < e, b.bcqfyp,
                           jnp.where(jnp.abs(t["n1"] + 1) < e, b.bcqfym,
                           jnp.where(jnp.abs(t["n2"] - 1) < e, b.bcqfz,
                                     0.0)))))
                mfl_t = jnp.where(ok_t & (t["lGR"] > 0.0),
                                  mflux_t * jnp.ones_like(utan_t), 0.0)
            elif (cfg.physics.lmoist and fac is not None
                    and cfg.walls.iwallmoist == 2 and "lGR" in t):
                qtair_t = Tz(g.qt[1:-1, 1:-1, 1:-1]).reshape(-1)[t["idx"]]
                qwall_t = fac.qsat[t["fac"]]
                hurel_t = fac.hurel[t["fac"]]
                resa_t = 1.0 / jnp.maximum(htc_t * jnp.abs(utan_t), 1e-10)
                resc_t = fac.f[t["fac"], 3]
                ress_t = fac.f[t["fac"], 4]
                cveg = 0.8
                mflux_t = jnp.minimum(
                    0.0, cveg * (qtair_t - qwall_t) / (resa_t + resc_t)
                    + (1.0 - cveg) * (qtair_t - qwall_t * hurel_t)
                    / (resa_t + ress_t))
                mfl_t = jnp.where(ok_t & (t["lGR"] > 0.0)
                                  & (htc_t * jnp.abs(utan_t) > 0.0),
                                  mflux_t, 0.0)
            if mfl_t is not None:
                if qt_acc is None:
                    qt_acc = jnp.zeros((kz, ny, nx), dtype)
                qt_acc = qt_acc.reshape(-1).at[t["idx"]].add(
                    -mfl_t * t["awgt"]).reshape(qt_acc.shape)
                ef_tot = ef_tot + jnp.sum(mfl_t * t["areaK"]).astype(dtype)

        def _pad_acc(acc):
            return jnp.pad(jnp.transpose(acc, (2, 1, 0)),
                           ((0, 0), (0, 0), (0, nz - kz))).astype(dtype)
        if thl_acc is not None:
            dthl = _pad_acc(thl_acc)
        if qt_acc is not None:
            dqt = _pad_acc(qt_acc)

        if need_fac:
            # per-facet sums for the EB: one gather + one segment_sum,
            # amortized (only fires on the accumulation substep)
            vals = []
            segs = []
            if fl is not None:
                vals.append(fl.ravel()[dn["_hsec_idx"]] * dn["_hsec_area"])
                segs.append(dn["_hsec_fac"])
            if fl_t is not None:
                vals.append(fl_t * t["areaK"])
                segs.append(t["fac"])
            if mfl is not None:
                vals.append(mfl.ravel()[dn["_hsec_idx"]] * dn["_hsec_area"])
                segs.append(dn["_hsec_fac"] + self.nfcts)
            if mfl_t is not None:
                vals.append(mfl_t * t["areaK"])
                segs.append(t["fac"] + self.nfcts)
            if vals:
                tot = jax.ops.segment_sum(
                    jnp.concatenate(vals), jnp.concatenate(segs),
                    num_segments=2 * self.nfcts)
                fachf = tot[:self.nfcts].astype(dtype)
                facef = tot[self.nfcts:].astype(dtype)
        heat_slots = None
        if ret_slots:
            heat_slots = {"htc": jnp.where(valid, htc, 0.0),
                          "cth": jnp.where(valid, cth, 0.0)}
        return dthl, dqt, hf_tot, ef_tot, fachf, facef, heat_slots

    def _gather_uvw(self, which, c, grid):
        """Interpolated velocity vector + air temperature at the active
        boundary points of one staggered grid (interp_velocity_* and
        interp_temperature_*, modibm.f90:1737-1829)."""
        d = self.dev[which]
        nx, ny, nz = grid.shape
        i, j, k = d["i"], d["jj"], d["k"]
        im, ip = (i - 1) % nx, (i + 1) % nx
        jm, jp = (j - 1) % ny, (j + 1) % ny
        u, v, w, thl = c.u, c.v, c.w, c.thl
        G = lambda f, ii, jjj, kk: f[ii, jjj, kk]
        mc = self.masks.c

        if which == "u":
            uu = G(u, i, j, k)
            vv = 0.25 * (G(v, i, j, k) + G(v, i, jp, k)
                         + G(v, im, j, k) + G(v, im, jp, k))
            ww = 0.25 * (G(w, i, j, k) + G(w, i, j, k + 1)
                         + G(w, im, j, k) + G(w, im, j, k + 1))
            m0, m1 = G(mc, i, j, k), G(mc, im, j, k)
            Ta = 0.5 * (G(thl, i, j, k) * m0 * (2.0 - m1)
                        + G(thl, im, j, k) * m1 * (2.0 - m0))
        elif which in ("v", "w"):
            uu = 0.25 * (G(u, i, j, k) + G(u, ip, j, k)
                         + G(u, i, jm, k) + G(u, ip, jm, k))
            vv = G(v, i, j, k)
            ww = 0.25 * (G(w, i, j, k) + G(w, i, j, k + 1)
                         + G(w, i, jm, k) + G(w, i, jm, k + 1))
            if which == "v":
                m0, m1 = G(mc, i, j, k), G(mc, i, jm, k)
                Ta = 0.5 * (G(thl, i, j, k) * m0 * (2.0 - m1)
                            + G(thl, i, jm, k) * m1 * (2.0 - m0))
            else:
                # w lives on faces: k is the face index; cells k and k-1
                kc = jnp.minimum(k, nz - 1)
                kmc = jnp.maximum(k - 1, 0)
                vv = G(v, i, j, kc)
                uu = 0.25 * (G(u, i, j, kc) + G(u, ip, j, kc)
                             + G(u, i, jm, kc) + G(u, ip, jm, kc))
                ww = 0.25 * (G(w, i, j, k)
                             + G(w, i, j, jnp.minimum(k + 1, nz))
                             + G(w, i, jm, k)
                             + G(w, i, jm, jnp.minimum(k + 1, nz)))
                m0, m1 = G(mc, i, j, kc), G(mc, i, j, kmc)
                Ta = 0.5 * (G(thl, i, j, kc) * m0 * (2.0 - m1)
                            + G(thl, i, j, kmc) * m1 * (2.0 - m0))
        else:  # c
            uu = 0.5 * (G(u, i, j, k) + G(u, ip, j, k))
            vv = 0.5 * (G(v, i, j, k) + G(v, i, jp, k))
            ww = 0.5 * (G(w, i, j, k) + G(w, i, j, k + 1))
            Ta = G(thl, i, j, k)

        # reconstruction-point sampling where the boundary point is too
        # deep in the roughness layer (wallfunmom:1352-1363)
        if "rec" in d:
            r = d["rec"]
            uu = jnp.where(r, self._tri(u, d, "u"), uu)
            vv = jnp.where(r, self._tri(v, d, "v"), vv)
            ww = jnp.where(r, self._tri(w, d, "w"), ww)
            Ta = jnp.where(r, self._tri(thl, d, "c"), Ta)
        return uu, vv, ww, Ta

    @staticmethod
    def _tri(f, d, key):
        """Trilinear interpolation as a static 8-corner gather
        (trilinear_interp_var, modibm.f90:1609-1660)."""
        idx = d[f"rci_{key}"]
        return jnp.sum(f[idx[..., 0], idx[..., 1], idx[..., 2]]
                       * d[f"rcw_{key}"], axis=-1)

    def _local_stress(self, which, c, grid, cfg):
        """Per-section tangential stress pieces shared by mom/heat paths."""
        d = self.dev[which]
        uu, vv, ww, Ta = self._gather_uvw(which, c, grid)
        uvec = jnp.stack([uu, vv, ww], axis=-1)             # (S,3)
        norm = d["norm"]
        span = jnp.cross(norm, uvec)
        span_n = jnp.linalg.norm(span, axis=-1)
        valid = span_n > const.eps1
        span = span / jnp.maximum(span_n, const.eps1)[:, None]
        strm = jnp.cross(span, norm)
        utan = jnp.sum(uvec * strm, axis=-1)
        return d, uvec, norm, strm, utan, Ta, valid

    def _wallfunmom(self, which, c, grid: Grid, cfg: Config, facT):
        """wallfunmom (modibm.f90:1286-1433), lcomprec/lnorec path."""
        d = self.dev[which]
        nx, ny, nz = grid.shape
        dtype = c.u.dtype
        shape = (nx, ny, nz + 1) if which == "w" else (nx, ny, nz)
        out = jnp.zeros(shape, dtype)
        if d is None:
            return out
        d, uvec, norm, strm, utan, Ta, valid = self._local_stress(
            which, c, grid, cfg)
        axis = {"u": 0, "v": 1, "w": 2}[which]
        if cfg.walls.iwallmom == 2:
            Tsurf = facT[d["fac"]]
            ctm = _mom_coef_stability(utan, d["dist"], d["z0"], d["z0h"],
                                      Ta, Tsurf)
        else:
            ctm = (const.fkar / jnp.log(d["dist"] / d["z0"])) ** 2
        stress = ctm * utan ** 2
        a = strm[:, axis]
        stress_dir = jnp.sign(uvec[:, axis]) * jnp.abs(a * stress)
        # cell volume: dzf at the cell (w sections use the face's upper cell,
        # wallfunmom:1411 with Fortran dzf(k))
        kcell = d["k"] if which != "w" else jnp.minimum(d["k"], nz - 1)
        dzf = jnp.asarray(grid.j("dzf"))[kcell]
        vol = grid.dx * grid.dy * dzf
        contrib = jnp.where(valid, -stress_dir * d["area"] / vol, 0.0)
        out = out.at[d["i"], d["jj"], d["k"]].add(contrib.astype(dtype))
        return out

    def _wallfunheat(self, c, grid: Grid, cfg: Config, facT, fac=None,
                     bctf=None):
        """wallfunheat (modibm.f90:1436-1606): sensible + latent wall fluxes
        at c-sections; returns (dthl, dqt, fachf, facef)."""
        d = self.dev["c"]
        nx, ny, nz = grid.shape
        dtype = c.thl.dtype
        zthl = jnp.zeros((nx, ny, nz), dtype)
        zq = jnp.zeros((nx, ny, nz), dtype)
        zf = jnp.zeros(self.nfcts, dtype)
        if d is None:
            return zthl, zq, zf, zf
        d, uvec, norm, strm, utan, Ta, valid = self._local_stress(
            "c", c, grid, cfg)
        flux = jnp.zeros_like(utan)
        htc = jnp.zeros_like(utan)
        fachf = zf
        facef = zf
        dzh = jnp.asarray(grid.j("dzh"))[d["k"]]
        wgt = d["area"] / (grid.dx * grid.dy * dzh)
        if cfg.physics.ltempeq:
            if cfg.walls.iwalltemp == 1:
                # fixed flux per orientation (modibm.f90:1519-1535;
                # note the reference assigns bctfxm for -yhat too — kept)
                n = d["norm"]
                e = const.eps1
                if bctf is None:
                    bxm, bxp, bym, byp, bz = (cfg.bc.bctfxm, cfg.bc.bctfxp,
                                              cfg.bc.bctfym, cfg.bc.bctfyp,
                                              cfg.bc.bctfz)
                else:  # time-interpolated (modtimedep.timedepsurf)
                    bxm, bxp, bym, byp, bz = bctf
                flux = jnp.where(jnp.abs(n[:, 0] - 1) < e, bxp,
                        jnp.where(jnp.abs(n[:, 0] + 1) < e, bxm,
                        jnp.where(jnp.abs(n[:, 1] - 1) < e, byp,
                        jnp.where(jnp.abs(n[:, 1] + 1) < e, bxm,
                        jnp.where(jnp.abs(n[:, 2] - 1) < e, bz,
                                  0.0)))))
                flux = flux.astype(dtype)
            else:
                Tsurf = facT[d["fac"]]
                cth, flux, htc = _heat_coef_flux(utan, d["dist"], d["z0"],
                                                 d["z0h"], Ta, Tsurf)
            fl = jnp.where(valid, flux, 0.0)
            zthl = zthl.at[d["i"], d["jj"], d["k"]].add(
                (-fl * wgt).astype(dtype))
            fachf = jax.ops.segment_sum(fl * d["area"], d["fac"],
                                        num_segments=self.nfcts)

        # latent heat on green-roof facets (modibm.f90:1555-1589)
        if cfg.physics.lmoist and fac is not None and cfg.walls.iwallmoist == 2:
            lGR = jnp.asarray(self.faclGR_dev)[d["fac"]]
            qtair = c.qt[d["i"], d["jj"], d["k"]]
            if "rec" in d:
                qtair = jnp.where(d["rec"], self._tri(c.qt, d, "c"), qtair)
            qwall = fac.qsat[d["fac"]]
            hurel = fac.hurel[d["fac"]]
            resa = 1.0 / jnp.maximum(htc * jnp.abs(utan), 1e-10)
            resc = fac.f[d["fac"], 3]
            ress = fac.f[d["fac"], 4]
            cveg = 0.8
            mflux = jnp.minimum(
                0.0, cveg * (qtair - qwall) / (resa + resc)
                + (1.0 - cveg) * (qtair - qwall * hurel) / (resa + ress))
            mfl = jnp.where(valid & lGR & (htc * jnp.abs(utan) > 0),
                            mflux, 0.0)
            zq = zq.at[d["i"], d["jj"], d["k"]].add(
                (-mfl * wgt).astype(dtype))
            facef = jax.ops.segment_sum(mfl * d["area"], d["fac"],
                                        num_segments=self.nfcts)
        return zthl, zq, fachf, facef

    # ------------------------------------------------------------------
    # Diffusion corrections across solid faces (dense mask arithmetic)
    # ------------------------------------------------------------------
    def _diffu_corr(self, g, grid: Grid):
        """diffu_corr (modibm.f90:990-1030): cancel SGS fluxes through faces
        whose opposite u-point is solid. Dense: the correction is zero
        wherever all neighbours are fluid, so it can be evaluated at every
        fluid u-point."""
        from functools import partial
        from ..ops.stencil import sh, shw, kvec
        nx, ny, nz = grid.shape
        S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
        u, ekm = g.u, g.ekm
        M = self.pmask_u
        dzf = grid.j("dzf_g")
        dzf_k = kvec(dzf, 1, nz); dzf_kp = kvec(dzf, 2, nz); dzf_km = kvec(dzf, 0, nz)
        dzhiq = grid.j("dzhiq"); dzhi = grid.j("dzhi")
        dzhiq_k = kvec(dzhiq, 0, nz); dzhiq_kp = kvec(dzhiq, 1, nz)
        dzhi_k = kvec(dzhi, 0, nz); dzhi_kp = kvec(dzhi, 1, nz)
        dzfi_k = kvec(grid.j("dzfi"), 0, nz)

        ekm_c = S(ekm, 0, 0, 0); ekm_im = S(ekm, -1, 0, 0)
        empo = 0.25 * (ekm_c + S(ekm, 0, 1, 0) + ekm_im + S(ekm, -1, 1, 0))
        emmo = 0.25 * (ekm_c + S(ekm, 0, -1, 0) + S(ekm, -1, -1, 0) + ekm_im)
        emop = (dzf_kp * (ekm_c + ekm_im)
                + dzf_k * (S(ekm, 0, 0, 1) + S(ekm, -1, 0, 1))) * dzhiq_kp
        emom = (dzf_km * (ekm_c + ekm_im)
                + dzf_k * (S(ekm, 0, 0, -1) + S(ekm, -1, 0, -1))) * dzhiq_k

        solid_jp = 1.0 - S(M, 0, 1, 0)
        solid_jm = 1.0 - S(M, 0, -1, 0)
        solid_kp = 1.0 - S(M, 0, 0, 1)
        solid_km = 1.0 - S(M, 0, 0, -1)
        uc = S(u, 0, 0, 0)
        corr = (
            - solid_jp * empo * (S(u, 0, 1, 0) - uc) * grid.dy2i
            + solid_jm * emmo * (uc - S(u, 0, -1, 0)) * grid.dy2i
            - solid_kp * emop * (S(u, 0, 0, 1) - uc) * dzhi_kp * dzfi_k
            + solid_km * emom * (uc - S(u, 0, 0, -1)) * dzhi_k * dzfi_k
        )
        # only at fluid u-points (solid points are zeroed by ibmnorm anyway)
        return corr * self.masks.u

    def _diffv_corr(self, g, grid: Grid):
        from functools import partial
        from ..ops.stencil import sh, kvec
        nx, ny, nz = grid.shape
        S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
        v, ekm = g.v, g.ekm
        M = self.pmask_v
        dzf = grid.j("dzf_g")
        dzf_k = kvec(dzf, 1, nz); dzf_kp = kvec(dzf, 2, nz); dzf_km = kvec(dzf, 0, nz)
        dzhiq = grid.j("dzhiq"); dzhi = grid.j("dzhi")
        dzhiq_k = kvec(dzhiq, 0, nz); dzhiq_kp = kvec(dzhiq, 1, nz)
        dzhi_k = kvec(dzhi, 0, nz); dzhi_kp = kvec(dzhi, 1, nz)
        dzfi_k = kvec(grid.j("dzfi"), 0, nz)

        ekm_c = S(ekm, 0, 0, 0); ekm_jm = S(ekm, 0, -1, 0)
        epmo = 0.25 * (ekm_c + ekm_jm + S(ekm, 1, -1, 0) + S(ekm, 1, 0, 0))
        emmo = 0.25 * (ekm_c + ekm_jm + S(ekm, -1, -1, 0) + S(ekm, -1, 0, 0))
        eomp = (dzf_kp * (ekm_c + ekm_jm)
                + dzf_k * (S(ekm, 0, 0, 1) + S(ekm, 0, -1, 1))) * dzhiq_kp
        eomm = (dzf_km * (ekm_c + ekm_jm)
                + dzf_k * (S(ekm, 0, 0, -1) + S(ekm, 0, -1, -1))) * dzhiq_k

        vc = S(v, 0, 0, 0)
        corr = (
            - (1.0 - S(M, 1, 0, 0)) * epmo * (S(v, 1, 0, 0) - vc) * grid.dx2i
            + (1.0 - S(M, -1, 0, 0)) * emmo * (vc - S(v, -1, 0, 0)) * grid.dx2i
            - (1.0 - S(M, 0, 0, 1)) * eomp * (S(v, 0, 0, 1) - vc) * dzhi_kp * dzfi_k
            + (1.0 - S(M, 0, 0, -1)) * eomm * (vc - S(v, 0, 0, -1)) * dzhi_k * dzfi_k
        )
        return corr * self.masks.v

    def _diffw_corr(self, g, grid: Grid):
        from ..ops.stencil import kvec
        nx, ny, nz = grid.shape
        w, ekm = g.w, g.ekm
        h = 1
        nf = nz - 1
        wf = lambda di, dj, dk: w[h + di: h + di + nx, h + dj: h + dj + ny,
                                  1 + dk: 1 + dk + nf]
        C = lambda A, di, dj, dk: A[h + di: h + di + nx, h + dj: h + dj + ny,
                                    1 + dk: 1 + dk + nf]
        # face-mask (no xy pad needed beyond pmask_w)
        Mw = self.pmask_w
        Mf = lambda di, dj: Mw[h + di: h + di + nx, h + dj: h + dj + ny,
                               1: 1 + nf]
        dzf = grid.j("dzf_g")
        dzf_km = kvec(dzf, 1, nf)
        dzf_k = kvec(dzf, 2, nf)
        dzhiq_k = kvec(grid.j("dzhiq"), 1, nf)

        epom = (dzf_km * (C(ekm, 0, 0, 1) + C(ekm, 1, 0, 1))
                + dzf_k * (C(ekm, 0, 0, 0) + C(ekm, 1, 0, 0))) * dzhiq_k
        emom = (dzf_km * (C(ekm, 0, 0, 1) + C(ekm, -1, 0, 1))
                + dzf_k * (C(ekm, 0, 0, 0) + C(ekm, -1, 0, 0))) * dzhiq_k
        eopm = (dzf_km * (C(ekm, 0, 0, 1) + C(ekm, 0, 1, 1))
                + dzf_k * (C(ekm, 0, 0, 0) + C(ekm, 0, 1, 0))) * dzhiq_k
        eomm = (dzf_km * (C(ekm, 0, 0, 1) + C(ekm, 0, -1, 1))
                + dzf_k * (C(ekm, 0, 0, 0) + C(ekm, 0, -1, 0))) * dzhiq_k
        wc = wf(0, 0, 0)
        corr = (
            - (1.0 - Mf(1, 0)) * epom * (wf(1, 0, 0) - wc) * grid.dx2i
            + (1.0 - Mf(-1, 0)) * emom * (wc - wf(-1, 0, 0)) * grid.dx2i
            - (1.0 - Mf(0, 1)) * eopm * (wf(0, 1, 0) - wc) * grid.dy2i
            + (1.0 - Mf(0, -1)) * eomm * (wc - wf(0, -1, 0)) * grid.dy2i
        )
        zeros = jnp.zeros((nx, ny, 1), corr.dtype)
        corr = jnp.concatenate([zeros, corr, zeros], axis=2)
        return corr * self.masks.w

    def _diffc_corr(self, gc, gekh, grid: Grid):
        """diffc_corr (modibm.f90:1120-1164)."""
        from functools import partial
        from ..ops.stencil import sh, kvec
        nx, ny, nz = grid.shape
        S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
        M = self.pmask_c
        dzf = grid.j("dzf_g")
        dzf_k = kvec(dzf, 1, nz); dzf_kp = kvec(dzf, 2, nz); dzf_km = kvec(dzf, 0, nz)
        dzh2i = grid.j("dzh2i")
        dzh2i_k = kvec(dzh2i, 0, nz); dzh2i_kp = kvec(dzh2i, 1, nz)
        dzfi_k = kvec(grid.j("dzfi"), 0, nz)
        cc = S(gc, 0, 0, 0)
        e = S(gekh, 0, 0, 0)
        corr = (
            - (1.0 - S(M, 1, 0, 0)) * 0.5 * (S(gekh, 1, 0, 0) + e)
            * (S(gc, 1, 0, 0) - cc) * grid.dx2i
            + (1.0 - S(M, -1, 0, 0)) * 0.5 * (e + S(gekh, -1, 0, 0))
            * (cc - S(gc, -1, 0, 0)) * grid.dx2i
            - (1.0 - S(M, 0, 1, 0)) * 0.5 * (S(gekh, 0, 1, 0) + e)
            * (S(gc, 0, 1, 0) - cc) * grid.dy2i
            + (1.0 - S(M, 0, -1, 0)) * 0.5 * (e + S(gekh, 0, -1, 0))
            * (cc - S(gc, 0, -1, 0)) * grid.dy2i
            - (1.0 - S(M, 0, 0, 1)) * 0.5
            * (dzf_kp * e + dzf_k * S(gekh, 0, 0, 1))
            * (S(gc, 0, 0, 1) - cc) * dzh2i_kp * dzfi_k
            + (1.0 - S(M, 0, 0, -1)) * 0.5
            * (dzf_km * e + dzf_k * S(gekh, 0, 0, -1))
            * (cc - S(gc, 0, 0, -1)) * dzh2i_k * dzfi_k
        )
        return corr * self.masks.c

    # ------------------------------------------------------------------
    # ibmnorm: zero solid velocities, fill solid scalar cells
    # ------------------------------------------------------------------
    def solid_fill(self, var, rhs, val):
        """`solid` with a mask (modibm.f90:748-826): set solid cells to the
        average of their fluid neighbours (both the value and the tendency),
        or to `val` when fully enclosed.  Computed on the z-major building
        slab with x/y rolls when possible (see _prep_pmasks); above the
        slab every cell is fluid and the fill is the identity."""
        kzs = getattr(self, "_kz_slab", None)
        if kzs is not None:
            return self._solid_fill_slab(var, rhs, val, kzs)
        return self._solid_fill_full(var, rhs, val)

    def _solid_fill_slab(self, var, rhs, val, kzs):
        Mg = self._slab_Mc                      # (kzs+2, ny, nx)
        # rows: [bottom ghost] + cells 0..kzs; interior output rows 1..kzs
        mk = lambda f: jnp.transpose(
            jnp.concatenate([f[:, :, :1], f[:, :, : kzs + 1]], axis=2),
            (2, 1, 0))
        sN = lambda a, dk, dj, di: jnp.roll(
            a, (-dj, -di), axis=(1, 2))[1 + dk: 1 + dk + kzs]

        def navg_t(ft):
            tot = (sN(ft, 0, 0, 1) * sN(Mg, 0, 0, 1)
                   + sN(ft, 0, 0, -1) * sN(Mg, 0, 0, -1)
                   + sN(ft, 0, 1, 0) * sN(Mg, 0, 1, 0)
                   + sN(ft, 0, -1, 0) * sN(Mg, 0, -1, 0)
                   + sN(ft, 1, 0, 0) * sN(Mg, 1, 0, 0)
                   + sN(ft, -1, 0, 0) * sN(Mg, -1, 0, 0))
            cnt = (sN(Mg, 0, 0, 1) + sN(Mg, 0, 0, -1)
                   + sN(Mg, 0, 1, 0) + sN(Mg, 0, -1, 0)
                   + sN(Mg, 1, 0, 0) + sN(Mg, -1, 0, 0))
            return tot, cnt

        vt, rt = mk(var), mk(rhs)
        tot_v, cnt = navg_t(vt)
        tot_r, _ = navg_t(rt)
        fill_v = jnp.where(cnt > 0, tot_v / jnp.maximum(cnt, 1.0), val)
        fill_r = jnp.where(cnt > 0, tot_r / jnp.maximum(cnt, 1.0), 0.0)
        Ms = Mg[1: 1 + kzs]
        var_s = jnp.where(Ms > 0.5, vt[1: 1 + kzs], fill_v)
        rhs_s = jnp.where(Ms > 0.5, rt[1: 1 + kzs], fill_r)
        back = lambda fs, f: jnp.concatenate(
            [jnp.transpose(fs, (2, 1, 0)).astype(f.dtype),
             f[:, :, kzs:]], axis=2)
        return back(var_s, var), back(rhs_s, rhs)

    def _solid_fill_full(self, var, rhs, val):
        M = self.masks.c
        Mp = self.pmask_c

        def navg(f):
            fp = jnp.pad(f, ((1, 1), (1, 1), (0, 0)), mode="wrap")
            fp = jnp.concatenate(
                [fp[:, :, :1], fp, fp[:, :, -1:]], axis=2)
            nx, ny, nz = f.shape
            s = lambda a, di, dj, dk: a[1 + di: 1 + di + nx,
                                        1 + dj: 1 + dj + ny,
                                        1 + dk: 1 + dk + nz]
            tot = (s(fp, 1, 0, 0) * s(Mp, 1, 0, 0)
                   + s(fp, -1, 0, 0) * s(Mp, -1, 0, 0)
                   + s(fp, 0, 1, 0) * s(Mp, 0, 1, 0)
                   + s(fp, 0, -1, 0) * s(Mp, 0, -1, 0)
                   + s(fp, 0, 0, 1) * s(Mp, 0, 0, 1)
                   + s(fp, 0, 0, -1) * s(Mp, 0, 0, -1))
            cnt = (s(Mp, 1, 0, 0) + s(Mp, -1, 0, 0) + s(Mp, 0, 1, 0)
                   + s(Mp, 0, -1, 0) + s(Mp, 0, 0, 1) + s(Mp, 0, 0, -1))
            return tot, cnt

        tot_v, cnt = navg(var)
        tot_r, _ = navg(rhs)
        fill_v = jnp.where(cnt > 0, tot_v / jnp.maximum(cnt, 1.0), val)
        fill_r = jnp.where(cnt > 0, tot_r / jnp.maximum(cnt, 1.0), 0.0)
        var = jnp.where(M > 0.5, var, fill_v)
        rhs = jnp.where(M > 0.5, rhs, fill_r)
        return var, rhs

    def ibmnorm(self, c, m, grid: Grid, cfg: Config,
                du, dv, dw, dthl, dqt, dsv, rk3coef, thl0av_vmean):
        """ibmnorm (modibm.f90:697-745): zero solid velocities + their
        tendencies, fill solid scalar cells, apply cd2 advection corrections.
        Returns updated tendencies and the masked m-fields."""
        import dataclasses
        if "masks" not in self.ablate:
            du = du * self.masks.u
            dv = dv * self.masks.v
            dw = dw * self.masks.w
            m_new = dataclasses.replace(
                m, u=m.u * self.masks.u, v=m.v * self.masks.v,
                w=m.w * self.masks.w)
        else:
            m_new = m
        dofill = "fill" not in self.ablate
        docorr = "advcorr" not in self.ablate
        corr = (self._advecc2nd_corr_conservative
                if cfg.physics.lconservativeibm
                else self._advecc2nd_corr_liberal)
        if cfg.physics.ltempeq:
            if dofill:
                thlm, dthl = self.solid_fill(m.thl, dthl, thl0av_vmean)
                m_new = dataclasses.replace(m_new, thl=thlm)
            if cfg.iadv_thl == 2 and docorr:  # cd2: advection correction
                dthl = dthl + corr(c.thl, c, grid)
        if cfg.physics.lmoist:
            if dofill:
                qtm, dqt = self.solid_fill(m.qt, dqt, 0.0)
                m_new = dataclasses.replace(m_new, qt=qtm)
            if docorr:
                dqt = dqt + corr(c.qt, c, grid)
        if dsv.shape[0] > 0 and dofill:
            svm_list, dsv_list = [], []
            for n in range(dsv.shape[0]):
                svm_n, dsv_n = self.solid_fill(m.sv[n], dsv[n], 0.0)
                svm_list.append(svm_n)
                dsv_list.append(dsv_n)
            m_new = dataclasses.replace(m_new, sv=jnp.stack(svm_list))
            dsv = jnp.stack(dsv_list)
        return du, dv, dw, dthl, dqt, dsv, m_new


    # --- z-major slab helpers for the advec corrections ---------------
    def _slab_ctx(self, var, c, grid, kzs):
        """Common transposed-slab views: var with ghost rows, velocity
        faces, and the z metric columns."""
        T = lambda a: jnp.transpose(a, (2, 1, 0))
        vg = T(jnp.concatenate([var[:, :, :1], var[:, :, : kzs + 1]],
                               axis=2))                  # (kzs+2, ny, nx)
        sV = lambda dk, dj, di: jnp.roll(
            vg, (-dj, -di), axis=(1, 2))[1 + dk: 1 + dk + kzs]
        ut = T(c.u[:, :, :kzs])
        vt = T(c.v[:, :, :kzs])
        w_dn = T(c.w[:, :, :kzs])
        w_up = T(c.w[:, :, 1: kzs + 1])
        kT = lambda name, lo: jnp.asarray(grid.j(name))[lo: lo + kzs][
            :, None, None]
        return vg, sV, ut, vt, w_dn, w_up, kT

    def _slab_back(self, corr_s, shape_like):
        out = jnp.transpose(corr_s, (2, 1, 0)).astype(shape_like.dtype)
        pad = shape_like.shape[2] - out.shape[2]
        return jnp.pad(out, ((0, 0), (0, 0), (0, pad)))

    def _advecc2nd_corr_conservative(self, var, c, grid: Grid):
        kzs = getattr(self, "_kz_slab", None)
        if kzs is None:
            return self._advecc2nd_corr_conservative_full(var, c, grid)
        Mg, Mu, Mv, Mw = (self._slab_Mc, self._slab_Mu, self._slab_Mv,
                          self._slab_Mw)
        sM = lambda M, dk, dj, di: jnp.roll(
            M, (-dj, -di), axis=(1, 2))[1 + dk: 1 + dk + kzs]
        vg, sV, ut, vt, w_dn, w_up, kT = self._slab_ctx(var, c, grid, kzs)
        vc = vg[1: 1 + kzs]
        u_ip = jnp.roll(ut, -1, axis=2)
        v_jp = jnp.roll(vt, -1, axis=1)
        blk_e = 1.0 - sM(Mu, 0, 0, 1) * sM(Mg, 0, 0, 1)
        blk_w = 1.0 - sM(Mu, 0, 0, 0) * sM(Mg, 0, 0, -1)
        blk_n = 1.0 - sM(Mv, 0, 1, 0) * sM(Mg, 0, 1, 0)
        blk_s = 1.0 - sM(Mv, 0, 0, 0) * sM(Mg, 0, -1, 0)
        blk_t = 1.0 - Mw[1: 1 + kzs] * sM(Mg, 1, 0, 0)
        blk_b = 1.0 - Mw[0: kzs] * sM(Mg, -1, 0, 0)
        dzf_k = kT("dzf_g", 1); dzf_kp = kT("dzf_g", 2)
        dzf_km = kT("dzf_g", 0)
        dzhi_k = kT("dzhi", 0); dzhi_kp = kT("dzhi", 1)
        dzfi5 = kT("dzfi5", 0)
        corr = (
            blk_e * u_ip * (sV(0, 0, 1) + vc) * grid.dxi5
            - blk_w * ut * (sV(0, 0, -1) + vc) * grid.dxi5
            + blk_n * v_jp * (sV(0, 1, 0) + vc) * grid.dyi5
            - blk_s * vt * (sV(0, -1, 0) + vc) * grid.dyi5
            + blk_t * w_up
            * (sV(1, 0, 0) * dzf_k + vc * dzf_kp) * dzhi_kp * dzfi5
            - blk_b * w_dn
            * (sV(-1, 0, 0) * dzf_k + vc * dzf_km) * dzhi_k * dzfi5
        )
        return self._slab_back(corr * Mg[1: 1 + kzs], var)

    def _advecc2nd_corr_liberal(self, var, c, grid: Grid):
        kzs = getattr(self, "_kz_slab", None)
        if kzs is None:
            return self._advecc2nd_corr_liberal_full(var, c, grid)
        Mg = self._slab_Mc
        sol = lambda dk, dj, di: 1.0 - jnp.roll(
            Mg, (-dj, -di), axis=(1, 2))[1 + dk: 1 + dk + kzs]
        vg, sV, ut, vt, w_dn, w_up, kT = self._slab_ctx(var, c, grid, kzs)
        vc = vg[1: 1 + kzs]
        u_ip = jnp.roll(ut, -1, axis=2)
        v_jp = jnp.roll(vt, -1, axis=1)
        dzf_k = kT("dzf_g", 1); dzf_kp = kT("dzf_g", 2)
        dzf_km = kT("dzf_g", 0)
        dzhi_k = kT("dzhi", 0); dzhi_kp = kT("dzhi", 1)
        dzfi5 = kT("dzfi5", 0)
        corr = (
            sol(0, 0, 1) * u_ip * ((sV(0, 0, 1) + vc) - (vc + vc))
            * grid.dxi5
            - sol(0, 0, -1) * ut * ((sV(0, 0, -1) + vc) - (vc + vc))
            * grid.dxi5
            + sol(0, 1, 0) * v_jp * ((sV(0, 1, 0) + vc) - (vc + vc))
            * grid.dyi5
            - sol(0, -1, 0) * vt * ((sV(0, -1, 0) + vc) - (vc + vc))
            * grid.dyi5
            + sol(1, 0, 0) * w_up
            * ((sV(1, 0, 0) * dzf_k + vc * dzf_kp)
               - (vc * dzf_k + vc * dzf_kp)) * dzhi_kp * dzfi5
            - sol(-1, 0, 0) * w_dn
            * ((sV(-1, 0, 0) * dzf_k + vc * dzf_km)
               - (vc * dzf_k + vc * dzf_km)) * dzhi_k * dzfi5
        )
        return self._slab_back(corr * Mg[1: 1 + kzs], var)

    def _advecc2nd_corr_conservative_full(self, var, c, grid: Grid):
        """advecc2nd_corr_conservative (modibm.f90:889-933): remove the cd2
        advective flux through any face whose face velocity or neighbouring
        cell is solid. Unlike the liberal variant nothing is substituted, so
        the scalar is conserved even when the projection leaves small nonzero
        solid-face velocities."""
        nx, ny, nz = grid.shape
        Mc = self.pmask_c
        Mu = self.pmask_u
        Mv = self.pmask_v
        Mw = self.pmask_w
        vp = jnp.pad(var, ((1, 1), (1, 1), (0, 0)), mode="wrap")
        vp = jnp.concatenate([vp[:, :, :1], vp, vp[:, :, -1:]], axis=2)
        s = lambda a, di, dj, dk: a[1 + di: 1 + di + nx,
                                    1 + dj: 1 + dj + ny,
                                    1 + dk: 1 + dk + nz]
        up = jnp.pad(c.u, ((1, 1), (1, 1), (0, 0)), mode="wrap")
        vpv = jnp.pad(c.v, ((1, 1), (1, 1), (0, 0)), mode="wrap")
        u_ip = up[2:, 1:-1, :]       # u at face i+1
        u_i = up[1:-1, 1:-1, :]
        v_jp = vpv[1:-1, 2:, :]
        v_j = vpv[1:-1, 1:-1, :]
        w = c.w
        from ..ops.stencil import kvec
        dzf = grid.j("dzf_g")
        dzf_k = kvec(dzf, 1, nz); dzf_kp = kvec(dzf, 2, nz); dzf_km = kvec(dzf, 0, nz)
        dzhi = grid.j("dzhi")
        dzhi_k = kvec(dzhi, 0, nz); dzhi_kp = kvec(dzhi, 1, nz)
        dzfi5 = kvec(grid.j("dzfi5"), 0, nz)
        vc = var
        # face blocked when the face velocity OR the neighbour cell is solid
        # (mask_u(i+1)<eps .or. mask_c(i+1)<eps, modibm.f90:907-929)
        blk_e = 1.0 - s(Mu, 1, 0, 0) * s(Mc, 1, 0, 0)
        blk_w = 1.0 - s(Mu, 0, 0, 0) * s(Mc, -1, 0, 0)
        blk_n = 1.0 - s(Mv, 0, 1, 0) * s(Mc, 0, 1, 0)
        blk_s = 1.0 - s(Mv, 0, 0, 0) * s(Mc, 0, -1, 0)
        # Mw is the (nx,ny,nz+1) face mask padded in x/y (+1 top ghost)
        wmask_t = Mw[1:-1, 1:-1, 1:nz + 1]
        wmask_b = Mw[1:-1, 1:-1, :nz]
        blk_t = 1.0 - wmask_t * s(Mc, 0, 0, 1)
        blk_b = 1.0 - wmask_b * s(Mc, 0, 0, -1)
        corr = (
            blk_e * u_ip * (s(vp, 1, 0, 0) + vc) * grid.dxi5
            - blk_w * u_i * (s(vp, -1, 0, 0) + vc) * grid.dxi5
            + blk_n * v_jp * (s(vp, 0, 1, 0) + vc) * grid.dyi5
            - blk_s * v_j * (s(vp, 0, -1, 0) + vc) * grid.dyi5
            + blk_t * w[:, :, 1:]
            * (s(vp, 0, 0, 1) * dzf_k + vc * dzf_kp) * dzhi_kp * dzfi5
            - blk_b * w[:, :, :nz]
            * (s(vp, 0, 0, -1) * dzf_k + vc * dzf_km) * dzhi_k * dzfi5
        )
        return corr * self.masks.c

    def _advecc2nd_corr_liberal_full(self, var, c, grid: Grid):
        """advecc2nd_corr_liberal (modibm.f90:936-987): replace the cd2
        advective flux through faces with a solid neighbour by the zero-flux
        (var_solid := var_here) variant. Dense over all cells; restricted to
        fluid cells via mask_c (solid-cell tendencies were averaged)."""
        nx, ny, nz = grid.shape
        Mp = self.pmask_c
        vp = jnp.pad(var, ((1, 1), (1, 1), (0, 0)), mode="wrap")
        vp = jnp.concatenate([vp[:, :, :1], vp, vp[:, :, -1:]], axis=2)
        s = lambda a, di, dj, dk: a[1 + di: 1 + di + nx,
                                    1 + dj: 1 + dj + ny,
                                    1 + dk: 1 + dk + nz]
        up = jnp.pad(c.u, ((1, 1), (1, 1), (0, 0)), mode="wrap")
        vpv = jnp.pad(c.v, ((1, 1), (1, 1), (0, 0)), mode="wrap")
        u_ip = up[2:, 1:-1, :]       # u at face i+1
        u_i = up[1:-1, 1:-1, :]
        v_jp = vpv[1:-1, 2:, :]
        v_j = vpv[1:-1, 1:-1, :]
        w = c.w
        from ..ops.stencil import kvec
        dzf = grid.j("dzf_g")
        dzf_k = kvec(dzf, 1, nz); dzf_kp = kvec(dzf, 2, nz); dzf_km = kvec(dzf, 0, nz)
        dzhi = grid.j("dzhi")
        dzhi_k = kvec(dzhi, 0, nz); dzhi_kp = kvec(dzhi, 1, nz)
        dzfi5 = kvec(grid.j("dzfi5"), 0, nz)
        vc = var
        sol = lambda di, dj, dk: 1.0 - s(Mp, di, dj, dk)
        corr = (
            sol(1, 0, 0) * u_ip * ((s(vp, 1, 0, 0) + vc)
                                   - (vc + vc)) * grid.dxi5
            - sol(-1, 0, 0) * u_i * ((s(vp, -1, 0, 0) + vc)
                                     - (vc + vc)) * grid.dxi5
            + sol(0, 1, 0) * v_jp * ((s(vp, 0, 1, 0) + vc)
                                     - (vc + vc)) * grid.dyi5
            - sol(0, -1, 0) * v_j * ((s(vp, 0, -1, 0) + vc)
                                     - (vc + vc)) * grid.dyi5
            + sol(0, 0, 1) * w[:, :, 1:]
            * ((s(vp, 0, 0, 1) * dzf_k + vc * dzf_kp)
               - (vc * dzf_k + vc * dzf_kp)) * dzhi_kp * dzfi5
            - sol(0, 0, -1) * w[:, :, :nz]
            * ((s(vp, 0, 0, -1) * dzf_k + vc * dzf_km)
               - (vc * dzf_k + vc * dzf_km)) * dzhi_k * dzfi5
        )
        return corr * self.masks.c


# ---------------------------------------------------------------------------
# Per-section transfer coefficients (vectorized duplicates of
# modibm.f90:1855-1985; kept separate from ibm/wallfn.py because the facet
# path uses dist-dependent Ribl0 = g d dT / (Ts utan^2))
# ---------------------------------------------------------------------------

def _fm_fh(Ribl, logdz, sqdz, fkar2):
    b1, b2, dm, dh = 9.4, 4.7, 7.4, 5.3
    cm = (dm * fkar2) / (logdz ** 2) * b1 * sqdz
    ch = (dh * fkar2) / (logdz ** 2) * b1 * sqdz
    stable = Ribl > 0
    Fm_s = 1.0 / (1.0 + b2 * Ribl) ** 2
    sq = jnp.sqrt(jnp.abs(Ribl))
    Fm_u = 1.0 - (b1 * Ribl) / (1.0 + cm * sq)
    Fh_u = 1.0 - (b1 * Ribl) / (1.0 + ch * sq)
    return jnp.where(stable, Fm_s, Fm_u), jnp.where(stable, Fm_s, Fh_u)


def _mom_coef_stability_pre(utan, dist, logdz, logzh, sqdz, Tair, Tsurf,
                            prandtlturb=const.prandtlmol):
    """mom_transfer_coef_stability (modibm.f90:1855-1903) with the static
    log/sqrt terms precomputed (they depend only on facet geometry)."""
    fkar2 = const.fkar ** 2
    dT = Tair - Tsurf
    utan2 = jnp.maximum(utan ** 2, UMIN)
    Ribl0 = const.grav * dist * dT / (Tsurf * utan2)
    Fm, Fh = _fm_fh(Ribl0, logdz, sqdz, fkar2)
    M = prandtlturb * logdz * jnp.sqrt(Fm) / Fh
    Ribl1 = Ribl0 - Ribl0 * prandtlturb * logzh / (prandtlturb * logzh + M)
    Fm1, _ = _fm_fh(Ribl1, logdz, sqdz, fkar2)
    return fkar2 / (logdz ** 2) * Fm1


def _mom_coef_stability(utan, dist, z0, z0h, Tair, Tsurf,
                        prandtlturb=const.prandtlmol):
    """mom_transfer_coef_stability (modibm.f90:1855-1903)."""
    return _mom_coef_stability_pre(
        utan, dist, jnp.log(dist / z0), jnp.log(z0 / z0h),
        jnp.sqrt(dist / z0), Tair, Tsurf, prandtlturb)


def _heat_coef_flux_pre(utan, dist, logdz, logzh, sqdz, Tair, Tsurf,
                        prandtlturb=const.prandtlmol):
    """heat_transfer_coef_flux (modibm.f90:1919-1985) with static log terms
    precomputed. Returns (cth, flux, htc)."""
    fkar2 = const.fkar ** 2
    dT = Tair - Tsurf
    utan2 = jnp.maximum(utan ** 2, UMIN)
    Ribl0 = const.grav * dist * dT / (Tsurf * utan2)
    Fm, Fh = _fm_fh(Ribl0, logdz, sqdz, fkar2)
    M = prandtlturb * logdz * jnp.sqrt(Fm) / Fh
    Ribl1 = Ribl0 - Ribl0 * prandtlturb * logzh / (prandtlturb * logzh + M)
    Fm1, Fh1 = _fm_fh(Ribl1, logdz, sqdz, fkar2)
    M1 = prandtlturb * logdz * jnp.sqrt(Fm1) / Fh1
    dTrough = dT / (prandtlturb * logzh / M1 + 1.0)
    cth = fkar2 / (logdz ** 2) * Fh1 / prandtlturb
    flux = jnp.abs(utan) * cth * dTrough
    denom = jnp.abs(utan) * dT
    htc = jnp.where(jnp.abs(denom) > 0, flux / jnp.where(
        jnp.abs(denom) > 0, denom, 1.0), 0.0)
    return cth, flux, htc


def _heat_coef_flux(utan, dist, z0, z0h, Tair, Tsurf,
                    prandtlturb=const.prandtlmol):
    """heat_transfer_coef_flux (modibm.f90:1919-1985). Returns
    (cth, flux, htc)."""
    return _heat_coef_flux_pre(
        utan, dist, jnp.log(dist / z0), jnp.log(z0 / z0h),
        jnp.sqrt(dist / z0), Tair, Tsurf, prandtlturb)


def _alignment(norms: np.ndarray) -> np.ndarray:
    """Vectorized `alignment` (modibm.f90:1682-1705): +-1/2/3 for axis-aligned
    unit normals, 0 otherwise."""
    out = np.zeros(len(norms), np.int64)
    for ax, code in ((0, 1), (1, 2), (2, 3)):
        e = np.zeros(3)
        e[ax] = 1.0
        out[np.all(np.abs(norms - e) < const.eps1, axis=1)] = code
        out[np.all(np.abs(norms + e) < const.eps1, axis=1)] = -code
    return out
