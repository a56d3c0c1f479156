"""Facet surface energy balance (radiation + multi-layer conduction).

Re-derivation of src/modEB.f90 + the EB parts of src/initfac.f90.
The reference gathers facet fluxes to rank 0 and solves one small dense
system per facet serially (modEB.f90:415-553); here everything is batched
over facets on device:

  - longwave radiosity exchange `calclw` (modEB.f90:335-363) as a dense
    (nfcts x nfcts) view-factor matmul or a sparse segment-sum
  - the per-facet (nfaclyrs+1)^2 conduction solves (modEB.f90:449-508) as
    one batched `jnp.linalg.solve`
  - green-roof resistances/soil moisture `updateGR` (modEB.f90:366-413)
    vectorized over facets.

The EB fires every dtEB seconds quantized to integers
(tnextEB = NINT(timee+dtEB), modEB.f90:535) under `lax.cond`, so the whole
simulation remains a single jitted graph.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config, const

# float32 matmuls may run in TF32 on the GPU (~3 decimal digits), which is
# too coarse for radiative and conductive fluxes of O(100-1000) W/m^2:
# every product here asks for full precision.
_HI = jax.lax.Precision.HIGHEST


def qsat_fn(T):
    """Saturation humidity (initfac.f90:406-412, Bolton 1980)."""
    gres = 611.00 * jnp.exp(17.27 * (T - 273.15) / (T - 35.85))
    return 0.62198 * 0.01 * gres / (1000.0 - 0.01 * gres)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class FacetState:
    """Per-facet prognostic state carried in the solver State."""
    T: Any        # (nfcts, nlyr+1) layer temperatures
    Tdash: Any    # (nfcts, nlyr+1) interface temperature gradients dT/dz
                  # (facTdash, modEB.f90:504-505; written to facT.nc)
    hfi: Any      # (nfcts,) time-integrated sensible heat [K m^3]
    efi: Any      # (nfcts,) time-integrated latent flux
    wsoil: Any    # (nfcts,) green-roof soil moisture
    hurel: Any    # (nfcts,) relative humidity above soil
    qsat: Any     # (nfcts,) saturation humidity at the surface
    f: Any        # (nfcts, 5) resistance factors (facf)
    tnextEB: Any  # scalar: next EB fire time
    tEB_last: Any # scalar: time of last EB solve
    dense: Any = None  # dense per-staggered-grid surface-param stacks
                       # (IBM.rebuild_dense_surf); rebuilt on each EB fire


class FacetEB:
    """Static facet-EB data + the batched solve."""

    def __init__(self, cfg: Config, facets, facnorm, faca, facem, facd,
                 faccp, faclam, faclGR, vf=None, vf_sparse=None, svf=None,
                 netsw=None, Tfacinit=None, dtype=np.float32):
        self.cfg = cfg
        nfcts = len(facets)
        self.nfcts = nfcts
        L = cfg.eb.nfaclyrs
        self.L = L
        fdt = dtype
        self.facets = np.asarray(facets)
        self.model_mask = jnp.asarray(self.facets >= -100)  # solve these
        self.faca = jnp.asarray(faca, fdt)
        self.facem = jnp.asarray(facem, fdt)
        self.faclGR = jnp.asarray(faclGR, bool)
        self.facd = jnp.asarray(facd, fdt)       # (nfcts, L)
        self.faclam = jnp.asarray(faclam, fdt)   # (nfcts, L+1)
        self.svf = jnp.asarray(svf if svf is not None else np.zeros(nfcts), fdt)
        self.netsw = jnp.asarray(netsw if netsw is not None
                                 else np.zeros(nfcts), fdt)
        self.vf = None if vf is None else jnp.asarray(vf, fdt)
        self.vf_sparse = vf_sparse  # (i, j, val) triplets

        # static matrices (initEB, modEB.f90:275-295 + :466-485)
        n = L + 1
        AM = np.zeros((n, n))
        AM[0, 0] = 1.0
        for j in range(1, n):
            AM[j, j - 1] = 0.5
            AM[j, j] = 0.5
        self.inAM = jnp.asarray(np.linalg.inv(AM), fdt)

        BM = np.zeros((nfcts, n, n))
        CM = np.zeros((nfcts, n, n))
        DM = np.zeros((nfcts, n, n))
        EM = np.zeros((nfcts, n, n))
        d = np.asarray(facd)
        lam = np.asarray(faclam)
        cpv = np.asarray(faccp)
        with np.errstate(divide="ignore", invalid="ignore"):
            for j in range(L):
                ca = np.where(d[:, j] > 0, 1.0 / np.maximum(d[:, j], 1e-30), 0.0)
                BM[:, j + 1, j] = -ca
                BM[:, j + 1, j + 1] = ca
                EM[:, j, j] = -lam[:, j]
                EM[:, j, j + 1] = lam[:, j + 1]
                cb = cpv[:, j] * d[:, j] / 2.0
                CM[:, j, j] = cb
                CM[:, j, j + 1] = cb
                ca2 = cpv[:, j] * d[:, j] ** 2 / 12.0
                DM[:, j, j] = ca2
                DM[:, j, j + 1] = -ca2
        CM[:, L, L] = 1.0
        self.BM0 = jnp.asarray(BM, fdt)
        self.CM = jnp.asarray(CM, fdt)
        self.DM = jnp.asarray(DM, fdt)
        self.EM = jnp.asarray(EM, fdt)

        # initial facet temperatures (initfac.f90:320-349); with lfacTlyrs
        # the file carries per-LAYER temperatures (initfac.f90:301-318)
        bldT = cfg.eb.bldT
        flrT = cfg.eb.flrT
        T0 = np.zeros((nfcts, n))
        inner = np.where(self.facets > 0, bldT, flrT)
        Ti_arr = np.asarray(Tfacinit) if Tfacinit is not None else None
        if Ti_arr is not None and Ti_arr.ndim == 2:
            T0[:, :L] = Ti_arr[:, :L]
        else:
            Ti = Ti_arr if Ti_arr is not None else np.full(nfcts, 295.0)
            for j in range(n):
                T0[:, j] = Ti - (Ti - inner) / L * j
        T0[:, L] = inner
        self.T0 = jnp.asarray(T0, fdt)
        self.dtype = fdt

    # -- loading -----------------------------------------------------------
    @classmethod
    def load(cls, case_dir: str | Path, expnr: str, cfg: Config, ibm,
             dtype=np.float32):
        from ..io.inputs import read_column_file
        case_dir = Path(case_dir)
        nfcts = ibm.nfcts
        walltype, facnorm = None, ibm.facnorm
        # re-read facets/factypes for EB props
        from ..io.inputs import read_facets_inp
        facets, facnorm = read_facets_inp(case_dir / f"facets.inp.{expnr}")
        ft = np.loadtxt(case_dir / f"factypes.inp.{expnr}", skiprows=3,
                        ndmin=2)
        typemap = {int(r[0]): r for r in ft}
        L = cfg.eb.nfaclyrs
        facem = np.zeros(nfcts)
        facd = np.zeros((nfcts, L))
        faccp = np.zeros((nfcts, L))
        faclam = np.zeros((nfcts, L + 1))
        faclGR = np.zeros(nfcts, bool)
        for i, t in enumerate(facets):
            r = typemap[int(t)]
            faclGR[i] = abs(r[1] - 1.0) < 1e-5
            facem[i] = r[5]
            if t < -100:
                continue
            # columns (initfac.f90:236-246): d at 6+j, C at 6+L+j, l at 6+2L+j
            for j in range(L):
                facd[i, j] = r[6 + j]
                faccp[i, j] = r[6 + L + j]
            lcol = r[6 + 2 * L: 6 + 3 * L]
            faclam[i, 0] = lcol[0]
            for j in range(1, L):
                faclam[i, j] = 0.5 * (lcol[j - 1] + lcol[j])
            faclam[i, L] = faclam[i, L - 1]
        svf = read_column_file(case_dir / f"svf.inp.{expnr}")
        netsw = read_column_file(case_dir / f"netsw.inp.{expnr}")
        tlyr_p = case_dir / f"Tfacinit_layers.inp.{expnr}"
        tfac_p = case_dir / f"Tfacinit.inp.{expnr}"
        if cfg.eb.lfacTlyrs and tlyr_p.exists():
            # per-layer initial temperatures (initfac.f90:301-318)
            Tfacinit = np.loadtxt(tlyr_p, skiprows=1, ndmin=2)
        else:
            Tfacinit = read_column_file(tfac_p) if tfac_p.exists() else None
        vf = vf_sparse = None
        if cfg.eb.lvfsparse:
            tri = np.loadtxt(case_dir / f"vfsparse.inp.{expnr}", ndmin=2)
            vf_sparse = (tri[:, 0].astype(np.int64) - 1,
                         tri[:, 1].astype(np.int64) - 1, tri[:, 2])
        else:
            from scipy.io import netcdf_file
            f = netcdf_file(str(case_dir / f"vf.nc.inp.{expnr}"), "r",
                            mmap=False)
            # netCDF-Fortran reverses dim order: the reference's vf(n,m)
            # (rows summing with svf to 1, the enclosure property) is the
            # transpose of the C-order array scipy returns
            vf = np.array(f.variables["view factor"][:]).T
            f.close()
        faca = ibm.faca
        obj = cls(cfg, facets, facnorm, faca, facem, facd, faccp, faclam,
                  faclGR, vf, vf_sparse, svf, netsw, Tfacinit, dtype)
        obj.ibm = ibm
        return obj

    def initial_state(self) -> FacetState:
        nf = self.nfcts
        z = jnp.zeros(nf, self.dtype)
        wsoil = jnp.where(self.faclGR, self.cfg.eb.wsoil, 0.0).astype(self.dtype)
        hurel = 0.5 * (1.0 - jnp.cos(3.14159 * self.cfg.eb.wsoil
                                     / self.cfg.eb.wfc))
        hurel = jnp.where(self.faclGR, hurel, 0.0).astype(self.dtype)
        f = jnp.zeros((nf, 5), self.dtype)
        f = f.at[:, 3].set(200.0).at[:, 4].set(50.0)  # initfac.f90:134
        qsat0 = qsat_fn(self.T0[:, 0]).astype(self.dtype)
        dense = None
        if getattr(self, "ibm", None) is not None:
            dense = self.ibm.rebuild_dense_surf(self.T0[:, 0], qsat0,
                                                hurel, f)
        return FacetState(
            T=self.T0, Tdash=jnp.zeros_like(self.T0), hfi=z, efi=z,
            wsoil=wsoil, hurel=hurel, qsat=qsat0, f=f,
            tnextEB=jnp.asarray(self.cfg.eb.dtEB, self.dtype),
            tEB_last=jnp.asarray(0.0, self.dtype), dense=dense)

    # -- physics -----------------------------------------------------------
    def calclw(self, T, skyLW=None):
        """Longwave in-flux per facet (modEB.f90:335-363)."""
        emitted = self.facem * const.boltz * T[:, 0] ** 4
        if self.vf is not None:
            lw = jnp.matmul(self.vf, emitted, precision=_HI)
        else:
            i, j, v = self.vf_sparse
            contrib = jnp.asarray(v, T.dtype) * emitted[jnp.asarray(j)]
            lw = jax.ops.segment_sum(contrib, jnp.asarray(i),
                                     num_segments=self.nfcts)
        skyLW = self.cfg.eb.skyLW if skyLW is None else skyLW
        return (lw + self.svf * skyLW) * self.facem

    def update(self, fstate: FacetState, timee, skyLW=None,
               netsw=None, dense_tbl=None) -> FacetState:
        """One EB solve (modEB.f90:429-541). skyLW/netsw may be
        time-interpolated overrides (modtimedep timedeplw/timedepsw)."""
        cfg = self.cfg
        tEB = timee - fstate.tEB_last
        tEB = jnp.maximum(tEB, 1e-6)

        # mean fluxes since last solve [W/m^2] (modEB.f90:392, 445)
        hfi = fstate.hfi / tEB / self.faca * const.rhoa * const.cp
        efi = fstate.efi / tEB / self.faca * const.rhoa * const.rlv

        # green roof update (modEB.f90:366-413)
        wsoil = fstate.wsoil
        if not cfg.eb.lconstW:
            wsoil = jnp.where(
                self.faclGR,
                jnp.maximum(wsoil + efi * tEB / const.rlv
                            / jnp.maximum(self.facd[:, 0], 1e-30), 0.0),
                wsoil)
        hurel = jnp.where(
            self.faclGR,
            jnp.clip(0.5 * (1.0 - jnp.cos(3.14159 * wsoil / cfg.eb.wfc)),
                     0.0, 1.0),
            fstate.hurel)
        T1 = fstate.T[:, 0]
        nsw = self.netsw if netsw is None else netsw
        f1 = 1.0 / jnp.minimum(1.0, (0.004 * nsw + 0.05)
                               / (0.81 * (0.004 * nsw + 1.0)))
        f2 = 1.0 / jnp.clip((wsoil - cfg.eb.wwilt)
                            / (cfg.eb.wfc - cfg.eb.wwilt), 0.001, 1.0)
        f4 = 1.0 / jnp.maximum(1.0 - 0.0016 * (298.0 - T1) ** 2, 0.001)
        rplant = jnp.minimum(cfg.eb.rsmin / cfg.eb.GRLAI * f1 * f2 * f4,
                             5000.0)
        rsoil = jnp.minimum(cfg.eb.rsmin * f2, 5000.0)
        f = fstate.f
        f = jnp.where(self.faclGR[:, None],
                      jnp.stack([f1, f2, f4, rplant, rsoil], axis=1), f)

        netsw_now = self.netsw if netsw is None else netsw
        LWin = self.calclw(fstate.T, skyLW)

        # batched conduction solve (modEB.f90:458-508)
        lam1 = jnp.maximum(self.faclam[:, 0], 1e-30)
        ab = const.boltz * self.facem * T1 ** 3 / lam1
        n = self.L + 1
        BM = self.BM0.at[:, 0, 0].set(ab)
        bb = jnp.zeros((self.nfcts, n), fstate.T.dtype)
        bb = bb.at[:, 0].set(-(netsw_now + LWin + hfi + efi) / lam1)
        inAM = self.inAM
        w = jnp.einsum("fij,jk,fk->fi", self.EM, inAM, bb,
                       precision=_HI) * tEB
        HM0 = jnp.einsum("ij,fjk->fik", inAM, BM, precision=_HI)
        FM = self.CM + jnp.einsum("fij,fjk->fik", self.DM, HM0,
                                  precision=_HI)
        GM = jnp.einsum("fij,fjk->fik", self.EM, HM0, precision=_HI)
        HH = FM - GM * tEB
        # HH Tnew = FM T + w, solved for the increment Tnew - T: its
        # right-hand side GM T tEB + w is small, so float32 keeps Tnew to
        # about one rounding of T instead of losing digits to the O(1e5)
        # entries of FM
        rhs = jnp.einsum("fij,fj->fi", GM, fstate.T, precision=_HI) * tEB + w
        # guard unsolved facets (bounding walls) with identity systems
        eye = jnp.eye(n, dtype=HH.dtype)
        HHs = jnp.where(self.model_mask[:, None, None], HH, eye)
        dT = jnp.linalg.solve(HHs, rhs[..., None])[..., 0]
        Tnew = fstate.T + jnp.where(self.model_mask[:, None], dT, 0.0)

        # interface gradients facTdash = inAM (bb + BM Tnew)
        # (modEB.f90:503-505); ground heat flux is -lam*Tdash[:,0]
        w2 = jnp.einsum("fij,fj->fi", BM, Tnew, precision=_HI)
        Tdash = jnp.einsum("ij,fj->fi", inAM, bb + w2, precision=_HI)
        Tdash = jnp.where(self.model_mask[:, None], Tdash, fstate.Tdash)

        qsat_new = qsat_fn(Tnew[:, 0]).astype(fstate.qsat.dtype)
        dense = fstate.dense
        if getattr(self, "ibm", None) is not None and dense is not None:
            dense = self.ibm.rebuild_dense_surf(Tnew[:, 0], qsat_new,
                                                hurel, f, dense=dense_tbl)
        return FacetState(
            T=Tnew, Tdash=Tdash, hfi=jnp.zeros_like(fstate.hfi),
            efi=jnp.zeros_like(fstate.efi), wsoil=wsoil, hurel=hurel,
            qsat=qsat_new, f=f,
            tnextEB=jnp.round(timee + cfg.eb.dtEB).astype(fstate.tnextEB.dtype),
            tEB_last=timee.astype(fstate.tEB_last.dtype), dense=dense)

    def maybe_update(self, fstate: FacetState, timee, skyLW=None,
                     netsw=None, dense_tbl=None) -> FacetState:
        """lax.cond-gated EB fire (modEB.f90:429)."""
        return jax.lax.cond(
            timee >= fstate.tnextEB,
            lambda fs: self.update(fs, timee, skyLW, netsw, dense_tbl),
            lambda fs: fs,
            fstate)
