"""Model assembly and RK3 time integration.

Functional re-derivation of the reference main loop (src/program.f90:133-223)
and Wicker-Skamarock RK3 (src/modtstep.f90): one `substep` evaluates every
tendency, projects with the Poisson solver, and integrates

    c = m + rk3coef * tend,   rk3coef = dt / (4 - rk3step)

with m <- c on the third substep.  Everything is jit-compatible; `run` wraps
N full steps in `lax.scan` so adaptive-dt simulation runs entirely on device.
"""
from __future__ import annotations

import dataclasses
import os
from functools import partial
from pathlib import Path
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import (BCTOPM_PRESSURE, BC_DRIVER, BC_PERIODIC, BC_PROFILE,
                     IADV_CD2, IADV_KAPPA, IADV_UPW, SGS_ONEEQN, Config, const)
from .grid import Grid
from .state import Fields, State, initial_state, profile_fields, randomize
from .io.inputs import CaseInputs, large_scale_pressure_gradient
from .ops import advection as adv
from .ops import subgrid as sgs
from .ops.boundary import Ghosts, make_ghosts, ghost_w
from .ops.forces import coriolis, forces, grwdamp, masscorr_uvol, masscorr_vvol
from .ops.halo import pad_periodic_xy
from .ops.poisson import PoissonSolver
from .ops.thermo import ThermoDiag, thermodynamics
from .ibm.bottom import bottom_tendencies


class Model:
    """Holds static configuration + precomputed operators for one case.

    The reference analogue is the whole collection of init* routines
    (program.f90:63-124); everything mutable lives in `State`."""

    def __init__(self, cfg: Config, grid: Grid, inputs: Optional[CaseInputs] = None,
                 ibm=None, mesh=None):
        self.cfg = cfg
        self.grid = grid
        self.ibm = ibm
        self.mesh = mesh   # jax.sharding.Mesh for multi-chip runs
        self.eb = None     # FacetEB for energy-balance runs
        self.inlet = None  # ops.openbc.Inlet for open-x runs
        self.igparams = None  # ops.inletgen.InletGenParams (iinletgen=1)
        self.inlet_y = None  # ops.openbc.Inlet for open-y runs (profile only)
        self.driver_stream = None  # io.driverstream.DriverStream (lchunkread)
        self.vegetation = None   # physics.Vegetation
        self.heatpumps = None    # physics.HeatPumps
        self.scalsources = None  # physics.ScalarSources
        self.purifiers = None    # physics.Purifiers
        self.timedep = None      # timedep.Timedep
        # tau_x/y/z + thl_flux diagnostics only when fielddump asks for them
        codes = {c.strip() for c in cfg.output.fieldvars.split(",")}
        self.need_taudiag = bool(cfg.output.lfielddump
                                 and codes & {"tx", "ty", "tz", "hf"})
        self.pois = PoissonSolver(grid, cfg, mesh=mesh)
        nz = grid.ktot
        fdt = grid.dtype
        if inputs is not None:
            dpdxl, dpdyl = large_scale_pressure_gradient(inputs.lscale, cfg)
            self.dpdxl = jnp.asarray(dpdxl, fdt)
            self.dpdyl = jnp.asarray(dpdyl, fdt)
            self.ug = jnp.asarray(inputs.lscale["ug"], fdt)
            self.vg = jnp.asarray(inputs.lscale["vg"], fdt)
            self.thlpcar = jnp.asarray(inputs.lscale["thlpcar"], fdt)
            # subsidence half-level profile (modstartup.f90:2125-2129)
            wfls = np.asarray(inputs.lscale["wfls"], float)
            dzf, dzh = grid.dzf, grid.dzh
            whls = np.zeros(nz + 1)
            whls[1:nz] = (wfls[1:] * dzf[:-1] + wfls[:-1] * dzf[1:]) \
                / (2.0 * dzh[1:nz])
            whls[nz] = wfls[-1] + dzf[-1] * (wfls[-1] - wfls[-2]) / dzh[-2] \
                if nz > 1 else wfls[-1]
            self.whls = jnp.asarray(whls, fdt)
            self.dqtdtls = jnp.asarray(inputs.lscale["dqtdt"], fdt)
            self.has_lstend = bool(np.any(wfls != 0)
                                   or np.any(inputs.lscale["dqtdt"] != 0))
        else:
            self.dpdxl = jnp.zeros(nz, fdt)
            self.dpdyl = jnp.zeros(nz, fdt)
            self.ug = jnp.zeros(nz, fdt)
            self.vg = jnp.zeros(nz, fdt)
            self.thlpcar = jnp.zeros(nz, fdt)
            self.whls = jnp.zeros(nz + 1, fdt)
            self.dqtdtls = jnp.zeros(nz, fdt)
            self.has_lstend = False
        self.inputs = inputs

    # -- initial condition -------------------------------------------------
    def cold_start(self, seed: int = 43, dt0: float | None = None) -> State:
        """Profile initialization + randomization
        (modstartup.readinitfiles:943)."""
        cfg, grid = self.cfg, self.grid
        ins = self.inputs
        nz = grid.ktot
        if ins is not None:
            p = ins.prof
            svprof = ins.scalar
            f = profile_fields(grid, p["u"], p["v"], p["thl"], p["qt"],
                               np.maximum(p["e12"], const.e12min), svprof)
        else:
            f = profile_fields(grid, np.zeros(nz), np.zeros(nz),
                               288.0 * np.ones(nz), np.zeros(nz),
                               const.e12min * np.ones(nz),
                               np.zeros((cfg.scalars.nsv, nz)))
        if cfg.run.lrandomize:
            key = jax.random.PRNGKey(seed)
            f = randomize(f, key, cfg.run.randu,
                          min(cfg.run.krand, grid.ktot))
        # NOTE: solid cells deliberately keep the profile values — the
        # reference initializes u0=uprof everywhere (modstartup.f90:1155) and
        # lets ibmnorm + the projection zero the solids within the first
        # substep; masking here would advect scalars with a divergent field.
        dt0 = dt0 if dt0 is not None else min(cfg.run.dtmax, 0.1)
        if self.inlet is not None:
            from .ops.openbc import init_xplanes
            f = dataclasses.replace(f, bx=init_xplanes(f, grid))
        if self.inlet_y is not None:
            from .ops.openbc import init_yplanes
            f = dataclasses.replace(f, by=init_yplanes(f, grid))
        fac = self.eb.initial_state() if self.eb is not None else None
        st = initial_state(grid, f, dt0=dt0, fac=fac)
        st = self.attach_params(st)
        if self.igparams is not None:
            from .ops.inletgen import init_inletgen
            st = st.replace(ig=init_inletgen(cfg, grid, f, self.igparams))
        if self.need_taudiag:
            nx, ny, nz = grid.shape
            z3 = lambda: jnp.zeros((nx, ny, nz), grid.dtype)
            st = st.replace(taud=dict(
                x=z3(), y=z3(), z=jnp.zeros((nx, ny, nz + 1), grid.dtype),
                hf=z3()))
        if cfg.walls.lwritefac and self.ibm is not None:
            from .state import zero_facstats
            st = st.replace(facstats=zero_facstats(self.ibm.nfcts,
                                                   grid.dtype))
        if cfg.physics.ifixuinf == 2:
            from .state import Ctl
            z = jnp.zeros((), grid.dtype)
            uref = cfg.bc.Vinf if cfg.physics.lvinf else cfg.bc.Uinf
            st = st.replace(ctl=Ctl(freestreamav=z + uref, dgdt=z,
                                    dpdx_shift=z))
        return st

    def attach_params(self, st: State) -> State:
        """Attach the static IBM dense-parameter pytree (State.ibmp) so the
        large arrays ride through jit as arguments (see IBM.params)."""
        if self.ibm is not None and st.ibmp is None:
            st = st.replace(ibmp=self.ibm.params())
        return st

    # -- one RK3 substep ---------------------------------------------------
    def substep(self, state: State, rk3step: int, th: ThermoDiag | None = None,
                closure_out=None) -> State:
        """One substep.  `th`/`closure_out` let `step` hand down the
        diagnostics it already computed on `m` for the adaptive dt — valid
        only for rk3step==1, where c == m (tstep_integrate copies c -> m on
        substep 3, modtstep.f90:213), and saves a full closure sweep."""
        cfg, grid = self.cfg, self.grid
        nx, ny, nz = grid.shape
        c, m = state.c, state.m
        dt = state.dt
        rk3coef = dt / (4.0 - rk3step)
        ltemp = cfg.physics.ltempeq
        lmoist = cfg.physics.lmoist
        nsv = c.sv.shape[0]

        # --- thermodynamics diagnostics (program.f90:215 runs at the end of
        # the previous substep; functionally identical evaluated here) ------
        masks = self.ibm.masks if self.ibm is not None else None
        if th is None:
            th = thermodynamics(c, cfg, grid, masks)

        # --- open-x inlet/outlet context (modboundary.f90:688-996) ---------
        openx = None
        uouttot = None
        ig_new = state.ig
        if self.inlet is not None:
            from .ops.openbc import BC_RECYCLE, recycle_planes, uouttot_value
            if self.igparams is not None:
                # full Lund-1998 rescale-recycle generator (modinlet.f90
                # inletgen, called per substep as in the legacy time loop)
                from .ops.inletgen import inletgen_planes, inletgen_update
                ig_new = inletgen_update(state.ig, c, cfg, grid, state.dt,
                                         rk3step, self.igparams)
                inlet_planes = inletgen_planes(ig_new, self.inlet, ny, nz)
            elif self.inlet.mode == BC_RECYCLE:
                inlet_planes = recycle_planes(self.inlet, c, ny, nz)
            elif state.drv is not None:
                # streaming replay: lerp from the rolling device window
                # (lchunkread, moddriver.f90:933; io/driverstream.py)
                from .ops.openbc import driver_window_planes
                inlet_planes = driver_window_planes(state.drv, state.timee)
            else:
                inlet_planes = self.inlet.planes(state.timee, ny, nz)
            openx = {"inlet": inlet_planes, "bx": c.bx}
            uouttot = uouttot_value(cfg, th.u0av, grid)

        # --- open-y inlet/outlet context (ymi_profile/ymo_convective) ------
        openy = None
        vouttot = None
        if self.inlet_y is not None:
            from .ops.openbc import vouttot_value
            inlet_y = self.inlet_y.planes(state.timee, nx, nz)
            openy = {"inlet": inlet_y, "by": c.by}
            vouttot = vouttot_value(cfg, th.v0av, grid)

        # --- SGS closure (modsubgrid.closure) ------------------------------
        thvs = cfg.bc.thls if cfg.bc.thls > 0 else 288.0
        if closure_out is None:
            gvel = _velocity_ghosts(c, cfg, grid, openx, openy)
            pack = (sgs.compute_gradpack(gvel, grid)
                    if os.environ.get("UDALES_CLOSURE_PACK") == "1" else None)
            ekm, ekh, zlt = sgs.closure(gvel, grid, cfg, e12=c.e12,
                                        dthvdz=th.dthvdz, thl=c.thl,
                                        thvs=thvs, pack=pack)
        else:
            ekm, ekh, zlt, pack = closure_out

        g = make_ghosts(c, ekm, ekh, cfg, grid, openx=openx, openy=openy)

        # --- advection (+ pressure-gradient term, modadvection) ------------
        gp = _pad_pres(state.pres, openx, openy)
        du = adv.adv_u(g, grid) - (gp[1:-1, 1:-1, :] - gp[:-2, 1:-1, :]) * grid.dxi
        dv = adv.adv_v(g, grid) - (gp[1:-1, 1:-1, :] - gp[1:-1, :-2, :]) * grid.dyi
        dw = adv.adv_w(g, grid)
        dzhi = grid.j("dzhi")
        dp_z = (state.pres[:, :, 1:] - state.pres[:, :, :-1]) \
            * dzhi[1:nz][None, None, :]
        dw = dw.at[..., 1:nz].add(-dp_z)

        dthl = adv.adv_c2(g.thl, g, grid) if ltemp else jnp.zeros_like(c.thl)
        if ltemp and self.cfg.iadv_thl == IADV_KAPPA:
            gthl_k = _kappa_ghost_scalar(c.thl, cfg, openx, openy)
            dthl = adv.adv_kappa(gthl_k, g, grid)
        dqt = adv.adv_c2(g.qt, g, grid) if lmoist else jnp.zeros_like(c.qt)
        de12 = (adv.adv_c2(g.e12, g, grid)
                if cfg.subgrid.model == SGS_ONEEQN else jnp.zeros_like(c.e12))
        if nsv > 0:
            dsv = jax.vmap(lambda gc: adv.adv_kappa(gc, g, grid))(g.sv)
        else:
            dsv = c.sv

        # --- shifted periodic BCs (modforces.f90:953, after advection) -----
        if cfg.physics.ds > 0:
            from .ops.forces import shifted_pbcs
            su_, sv_, sw_ = shifted_pbcs(c, grid, cfg, rk3coef, th.u0av,
                                         cfg.physics.ds)
            du, dv, dw = du + su_, dv + sv_, dw + sw_

        # --- subgrid diffusion --------------------------------------------
        # IBM diffusion corrections folded into the sweeps (diffu_corr..
        # diffc_corr as {0,1} flux masks — exact, one pass instead of the
        # separate correction passes)
        fold = (self.ibm is not None and self.ibm.fold_diffcorr
                and "diffcorr" not in self.ibm.ablate)
        Mc = self.ibm.pmask_c if fold else None
        if fold:
            xu = sgs.diff_u(g, grid, M=self.ibm.pmask_u)
            xv = sgs.diff_v(g, grid, M=self.ibm.pmask_v)
            xw = sgs.diff_w(g, grid, M=self.ibm.pmask_w)
        elif os.environ.get("UDALES_DIFF") == "fused":
            # flux-difference form: fewer operations, but its shared
            # fluxes are multi-consumer and XLA may materialize them
            xu, xv, xw = sgs.fused_diffusion(g, grid)
        else:
            xu, xv, xw = (sgs.diff_u(g, grid), sgs.diff_v(g, grid),
                          sgs.diff_w(g, grid))
        du, dv, dw = du + xu, dv + xv, dw + xw
        if ltemp:
            dthl = dthl + sgs.diff_c(g.thl, g.ekh, grid, M=Mc)
        if lmoist:
            dqt = dqt + sgs.diff_c(g.qt, g.ekh, grid, M=Mc)
        if nsv > 0:
            gsv1 = jax.vmap(lambda s: s[1:-1, 1:-1, 1:-1])(g.sv)  # h=1 view
            dsv = dsv + jax.vmap(
                lambda gc: sgs.diff_c(gc, g.ekh, grid, M=Mc))(gsv1)
        if cfg.subgrid.model == SGS_ONEEQN:
            de12 = de12 + sgs.diff_e(g, grid)
            de12 = de12 + sgs.tke_sources(g, grid, cfg, c.e12, ekm, ekh,
                                          th.dthvdz, zlt, thvs, pack=pack)

        # --- floor wall functions (modibm.bottom) --------------------------
        bu, bv, bthl, bqt, bsv = bottom_tendencies(g, cfg, grid, nsv)
        du, dv = du + bu, dv + bv
        dthl, dqt = dthl + bthl, dqt + bqt

        # --- coriolis / forces / damping -----------------------------------
        cu, cv, cw = coriolis(g, grid, cfg, self.ug, self.vg)
        du, dv, dw = du + cu, dv + cv, dw + cw
        dpdxl_eff = self.dpdxl
        if cfg.physics.ifixuinf == 2 and state.ctl is not None:
            dpdxl_eff = self.dpdxl + state.ctl.dpdx_shift
        fu, fv, fw = forces(g, grid, cfg, dpdxl_eff, self.dpdyl,
                            th.thv0h, th.thvh)
        du, dv, dw = du + fu, dv + fv, dw + fw

        # --- large-scale subsidence/advection (modforces.lstend) -----------
        if self.has_lstend:
            from .ops.forces import lstend
            from .ops.thermo import avexy_masked
            IIc_ = (self.ibm.masks.c if self.ibm is not None
                    else jnp.ones((nx, ny, nz), du.dtype))
            sv0av = (jnp.stack([avexy_masked(c.sv[n], IIc_)
                                for n in range(nsv)])
                     if nsv else jnp.zeros((0, nz), du.dtype))
            sv0av = jnp.where(sv0av < -900.0, 0.0, sv0av)
            lu, lv, lthl, lqt, lsv = lstend(
                c, grid, cfg, self.whls, th.u0av, th.v0av, th.thl0av,
                th.qt0av, sv0av, self.dqtdtls)
            du = du + lu[None, None, :]
            dv = dv + lv[None, None, :]
            if ltemp:
                dthl = dthl + lthl[None, None, :]
            if lmoist:
                dqt = dqt + lqt[None, None, :]
            if nsv:
                dsv = dsv + lsv[:, None, None, :]
        if ltemp:
            dthl = dthl + self.thlpcar[None, None, :]
        if cfg.physics.igrw_damp != 0:
            gu_, gv_, gw_, gthl_, gqt_ = grwdamp(
                c, grid, cfg, th.u0av, th.v0av, th.thl0av, th.qt0av,
                self.ug, self.vg)
            du, dv, dw = du + gu_, dv + gv_, dw + gw_
            dthl, dqt = dthl + gthl_, dqt + gqt_

        # --- nudging to (possibly time-dependent) profiles -----------------
        if cfg.physics.lnudge and cfg.physics.nnudge > 0:
            from .ops.forces import nudge_top
            nprofs = None
            if self.timedep is not None:
                nprofs = self.timedep.nudge_profiles(state.timee)
            if nprofs is None and self.inputs is not None:
                p = self.inputs.prof
                nprofs = dict(u=jnp.asarray(p["u"], du.dtype),
                              v=jnp.asarray(p["v"], du.dtype),
                              thl=jnp.asarray(p["thl"], du.dtype),
                              qt=jnp.asarray(p["qt"], du.dtype))
            if nprofs is not None:
                nu, nv, nthl, nqt = nudge_top(c, grid, cfg, nprofs["u"],
                                              nprofs["v"], nprofs["thl"],
                                              nprofs["qt"], u0av=th.u0av,
                                              v0av=th.v0av,
                                              thl0av=th.thl0av,
                                              qt0av=th.qt0av)
                du, dv = du + nu, dv + nv
                dthl, dqt = dthl + nthl, dqt + nqt

        # --- IBM wall functions + masks ------------------------------------
        fac = state.fac
        bctf = (self.timedep.surf_fluxes(state.timee)
                if self.timedep is not None else None)
        taud = state.taud
        need_tau = getattr(self, "need_taudiag", False) and rk3step == 3
        if self.ibm is not None:
            need_fac = fac is not None and rk3step == 3
            need_fstats = (cfg.walls.lwritefac and rk3step == 3
                           and state.facstats is not None)
            if need_tau:
                pre = (du, dv, dw, dthl)
            (du, dv, dw, dthl, dqt, dsv, fachf, facef, hf_tot,
             ef_tot, fstats) = self.ibm.wallfun(
                g, c, grid, cfg, du, dv, dw, dthl, dqt, dsv, fac, bctf,
                need_fac=need_fac, ibmp=state.ibmp,
                need_facstats=need_fstats, pres=state.pres)
            if need_tau:
                # tau_* / thl_flux diagnostics: the bottom + ibmwallfun
                # tendency increments of this substep (modibm.f90:1185,
                # 2014-2093; dumped by fielddump tx/ty/tz/hf)
                taud = dict(x=(du - pre[0]) + bu, y=(dv - pre[1]) + bv,
                            z=dw - pre[2], hf=(dthl - pre[3]) + bthl)
            # intqH (modEB.f90:220-247): accumulate facet fluxes in time on
            # the last substep
            if need_fac:
                fac = dataclasses.replace(
                    fac, hfi=fac.hfi + dt * fachf,
                    efi=fac.efi + dt * facef)
            # lwritefac dt-weighted accumulation (modibm.f90:1246-1254)
            if need_fstats:
                fs = state.facstats
                state = state.replace(facstats=dataclasses.replace(
                    fs,
                    tau_x=fs.tau_x + dt * fstats["tau_x"],
                    tau_y=fs.tau_y + dt * fstats["tau_y"],
                    tau_z=fs.tau_z + dt * fstats["tau_z"],
                    pres=fs.pres + dt * fstats["pres"],
                    pres2=fs.pres2 + dt * fstats["pres2"],
                    htc=fs.htc + dt * fstats["htc"],
                    cth=fs.cth + dt * fstats["cth"]))
            # periodic heat-buildup sink (modforces.periodicEBcorr)
            if cfg.eb.lperiodicEBcorr:
                from .ops.forces import periodic_eb_corr
                pthl, pqt = periodic_eb_corr(
                    grid, cfg, hf_tot, ef_tot, du.dtype)
                if ltemp:
                    dthl = dthl + pthl[None, None, :]
                if lmoist:
                    dqt = dqt + pqt[None, None, :]
        elif need_tau:
            taud = dict(x=bu, y=bv, z=jnp.zeros_like(dw), hf=bthl)

        # --- free-stream controllers (modforces.fixuinf1/2) ----------------
        ctl = state.ctl
        if cfg.physics.ifixuinf == 1 and rk3step == 3:
            from .ops.forces import fixuinf1
            cu1, cv1 = fixuinf1(c, grid, cfg, dt, th.u0av, th.v0av)
            du = du + cu1
            dv = dv + cv1
        if cfg.physics.ifixuinf == 2 and ctl is not None:
            ctl = dataclasses.replace(
                ctl, dpdx_shift=ctl.dpdx_shift + ctl.dgdt * rk3coef)
            if rk3step == 3:
                freestream = th.v0av[-1] if cfg.physics.lvinf else th.u0av[-1]
                inletav = max(cfg.physics.inletav, 1e-9)
                fav = (freestream * dt / inletav
                       + (1.0 - dt / inletav) * ctl.freestreamav)
                tscale = cfg.physics.tscale if cfg.physics.tscale > 0 else 1.0
                uref = cfg.bc.Vinf if cfg.physics.lvinf else cfg.bc.Uinf
                ctl = dataclasses.replace(
                    ctl, freestreamav=fav,
                    dgdt=(1.0 / tscale) * (fav - uref))

        # --- mass-flow-rate correction (modforces.masscorr; skipped for
        # inflow/outflow runs, :352/:394) -----------------------------------
        if cfg.physics.luvolflowr and openx is None:
            IIu = self.ibm.masks.u if self.ibm is not None else \
                jnp.ones((nx, ny, nz), du.dtype)
            du = masscorr_uvol(du, m.u, grid, cfg, rk3coef, IIu)
        if cfg.physics.lvvolflowr and openx is None and openy is None:
            IIv = self.ibm.masks.v if self.ibm is not None else \
                jnp.ones((nx, ny, nz), dv.dtype)
            dv = masscorr_vvol(dv, m.v, grid, cfg, rk3coef, IIv)

        # --- IBM: zero solid normal velocities (ibmnorm) -------------------
        if self.ibm is not None:
            dzf_w = grid.j("dzf")
            thl_vmean = (jnp.sum(th.thl0av * jnp.asarray(dzf_w))
                         / grid.zh[-1]).astype(c.thl.dtype)
            du, dv, dw, dthl, dqt, dsv, m = self.ibm.ibmnorm(
                c, m, grid, cfg, du, dv, dw, dthl, dqt, dsv, rk3coef,
                thl_vmean)

        # --- vegetation canopy forcing (vegetation.f90:351) ----------------
        if self.vegetation is not None and self.vegetation.has_canopy:
            du, dv, dw, dthl, dqt, dsv = self.vegetation.forcing(
                m, grid, cfg, du, dv, dw, dthl, dqt, dsv)

        # --- heat pumps (heatpump.f90:60) ----------------------------------
        if self.heatpumps is not None and ltemp:
            m, c, dw, dthl = self.heatpumps.apply(m, c, dw, dthl)

        # --- scalar sources (modscalsource.f90:385) ------------------------
        if self.scalsources is not None and nsv > 0:
            dsv = dsv + self.scalsources.field

        # --- forces hard-zeroes wp at the floor (modforces.f90:125) --------
        dw = dw.at[..., 0].set(0.0)

        # --- pressure projection (modpois.poisson) -------------------------
        du, dv, dw, p, du_out, dv_out = self._project(
            du, dv, dw, m, rk3coef, c=c, openx=openx, uouttot=uouttot,
            openy=openy, vouttot=vouttot, pres=state.pres, masks=masks)
        pres = state.pres + p

        # --- purifiers (modpurifiers.f90, between poisson and integrate) ---
        if self.purifiers is not None:
            m, c, du, dv, dw, dsv = self.purifiers.apply(
                m, c, du, dv, dw, dsv)

        # --- integrate (modtstep.tstep_integrate) --------------------------
        e12_new = m.e12 + rk3coef * de12
        c_new = Fields(
            u=m.u + rk3coef * du,
            v=m.v + rk3coef * dv,
            w=(m.w + rk3coef * dw).at[..., 0].set(0.0),
            thl=m.thl + rk3coef * dthl if ltemp else m.thl,
            qt=m.qt + rk3coef * dqt if lmoist else m.qt,
            e12=jnp.maximum(const.e12min, e12_new),
            sv=m.sv + rk3coef * dsv if nsv > 0 else m.sv,
            bx=c.bx,
            by=c.by,
        )
        m_new = m
        if openy is not None:
            # pin the inlet plane (ymi_profile) and advance the prognostic
            # outlet planes (ymo_* convective)
            from .ops.openbc import convect_planes_y
            c_new = dataclasses.replace(
                c_new, v=c_new.v.at[:, 0].set(inlet_y["v"]))
            if ltemp and cfg.bc.BCyT == BC_PROFILE:
                c_new = dataclasses.replace(
                    c_new, thl=c_new.thl.at[:, 0].set(inlet_y["thl"]))
            v_out_new = m.by.v + rk3coef * dv_out
            byc = dataclasses.replace(c.by, v=v_out_new)
            byc = convect_planes_y(byc, c_new, grid, rk3coef, vouttot,
                                   inlet_y)
            c_new = dataclasses.replace(c_new, by=byc)
            bym = convect_planes_y(m.by, m, grid, rk3coef, vouttot, inlet_y)
            m_new = dataclasses.replace(m_new, by=bym)
        if openx is not None:
            # enforce the inlet plane (xmi_*, modboundary.f90:697/730) and
            # advance the prognostic outlet planes (xmo_* convective)
            from .ops.openbc import convect_planes
            c_new = dataclasses.replace(
                c_new, u=c_new.u.at[0].set(inlet_planes["u"]))
            if ltemp and cfg.bc.BCxT == BC_PROFILE:
                # xTi_profile also pins the first internal cell
                # (modboundary.f90:786-791)
                c_new = dataclasses.replace(
                    c_new, thl=c_new.thl.at[0].set(inlet_planes["thl"]))
            u_out_new = m.bx.u + rk3coef * du_out
            bxc = dataclasses.replace(c.bx, u=u_out_new)
            bxc = convect_planes(bxc, c_new, grid, rk3coef, uouttot,
                                 inlet_planes)
            c_new = dataclasses.replace(c_new, bx=bxc)
            bxm = convect_planes(m.bx, m, grid, rk3coef, uouttot,
                                 inlet_planes)
            m_new = dataclasses.replace(m_new, bx=bxm)
        if cfg.subgrid.model == SGS_ONEEQN:
            m_new = dataclasses.replace(
                m_new, e12=jnp.maximum(const.e12min, m.e12))
        # chemistry once per full step on the updated scalars
        # (modtstep.f90:236-238, modchem.f90)
        if (cfg.chem.lchem and rk3step == 3 and nsv >= 3):
            IIc = self.ibm.masks.c if self.ibm is not None else \
                jnp.ones((nx, ny, nz), c_new.sv.dtype)
            c_new = dataclasses.replace(
                c_new, sv=_chem(c_new.sv, dt, cfg, IIc))
        if rk3step == 3:
            m_new = c_new
        return state.replace(c=c_new, m=m_new, pres=pres, fac=fac,
                             ctl=ctl, ig=ig_new, taud=taud)

    def _project(self, du, dv, dw, m: Fields, rk3coef, c=None, openx=None,
                 uouttot=None, openy=None, vouttot=None, pres=None,
                 masks=None):
        """fillps + bcpup + poisson + tderive (modpois.f90:911-998, 419-712,
        1001-1105; modboundary.f90:1191-1341). Returns the projected
        tendencies, the pressure correction, and the outlet-face u/v
        tendencies (None for periodic directions)."""
        grid, cfg = self.grid, self.cfg
        nx, ny, nz = grid.shape
        rk3coefi = 1.0 / rk3coef
        lptop = cfg.bc.BCtopm == BCTOPM_PRESSURE
        pup = du + m.u * rk3coefi
        pvp = dv + m.v * rk3coefi
        pwp = dw + m.w * rk3coefi
        # bcpup: impermeable bottom (and top unless the pressure BC)
        pwp = pwp.at[..., 0].set(0.0)
        if lptop:
            # pwp(ke+1) = wm/rk3coef + 2 <pres0>_ke dzhi(ke+1)
            # (modboundary.f90:1241); the wp contribution is folded into dw
            from .ops.thermo import avexy_masked
            IIc = masks.c if masks is not None else jnp.ones_like(pres)
            pres0ij = avexy_masked(pres, IIc)
            pres0ij = jnp.where(pres0ij < -900.0, 0.0, pres0ij)
            dzhi_top = grid.dzh[-1] ** -1
            wtop_t = 2.0 * pres0ij[nz - 1] * dzhi_top
            dw = dw.at[..., nz].set(wtop_t)
            pwp = pwp.at[..., nz].set(m.w[..., nz] * rk3coefi + wtop_t)
        else:
            pwp = pwp.at[..., nz].set(0.0)
        dzfi = grid.j("dzfi")
        du_out = None
        dv_out = None
        # x face divergence term
        if openx is None:
            gpu = pad_periodic_xy(pup, 1)
            ddx = (gpu[2:, 1:-1, :] - gpu[1:-1, 1:-1, :]) * grid.dxi
        else:
            # bcpup open-x (modboundary.f90:1247-1305): inlet face fixed to
            # the inlet plane; outlet face convective
            inlet_u = openx["inlet"]["u"]
            du = du.at[0].set(0.0)
            pup = pup.at[0].set(inlet_u * rk3coefi)
            u_out = openx["bx"].u          # current outlet u (u0(ie+1))
            u_out_m = m.bx.u
            pup_out = (u_out_m * rk3coefi
                       - (u_out - c.u[-1]) * grid.dxi * uouttot)
            du_out = pup_out - u_out_m * rk3coefi
            pup_faces = jnp.concatenate([pup, pup_out[None]], axis=0)
            ddx = (pup_faces[1:] - pup_faces[:-1]) * grid.dxi
        # y face divergence term
        if openy is None:
            gpv = pad_periodic_xy(pvp, 1)
            ddy = (gpv[1:-1, 2:, :] - gpv[1:-1, 1:-1, :]) * grid.dyi
        else:
            # bcpup open-y: inlet v face fixed; outlet v face convective
            inlet_v = openy["inlet"]["v"]
            dv = dv.at[:, 0].set(0.0)
            pvp = pvp.at[:, 0].set(inlet_v * rk3coefi)
            v_out = openy["by"].v
            v_out_m = m.by.v
            pvp_out = (v_out_m * rk3coefi
                       - (v_out - c.v[:, -1]) * grid.dyi * vouttot)
            dv_out = pvp_out - v_out_m * rk3coefi
            pvp_faces = jnp.concatenate([pvp, pvp_out[:, None]], axis=1)
            ddy = (pvp_faces[:, 1:] - pvp_faces[:, :-1]) * grid.dyi
        rhs = (ddx + ddy
               + (pwp[:, :, 1:] - pwp[:, :, :-1]) * dzfi[None, None, :])
        p = self.pois.solve(rhs)
        # tderive: subtract grad p from the tendencies (Neumann ghosts at
        # open boundaries leave the inlet face untouched, modpois:1046-1056)
        gp = _pad_pres(p, openx, openy)
        du = du - (gp[1:-1, 1:-1, :] - gp[:-2, 1:-1, :]) * grid.dxi
        dv = dv - (gp[1:-1, 1:-1, :] - gp[1:-1, :-2, :]) * grid.dyi
        dzhi = grid.j("dzhi")
        dw = dw.at[..., 1:nz].add(
            -(p[:, :, 1:] - p[:, :, :-1]) * dzhi[1:nz][None, None, :])
        if lptop:
            # wp(ke+1) += 2 <p>_ke dzhi(ke+1) (modpois.f90:1058-1069)
            from .ops.thermo import avexy_masked
            IIc = masks.c if masks is not None else jnp.ones_like(p)
            pij = avexy_masked(p, IIc)
            pij = jnp.where(pij < -900.0, 0.0, pij)
            # float(): the numpy f64 metric scalar would promote the f32
            # scatter update to f64 (hard error in future JAX)
            dw = dw.at[..., nz].add(2.0 * pij[nz - 1] / float(grid.dzh[-1]))
        return du, dv, dw, p, du_out, dv_out

    # -- dt control (modtstep.tstep_update:49-154) --------------------------
    def new_dt(self, state: State, ekm=None, ekh=None):
        cfg, grid = self.cfg, self.grid
        if not cfg.run.ladaptive:
            return jnp.asarray(cfg.run.dtmax, state.dt.dtype)
        m = state.m
        nz = grid.ktot
        dzh = grid.j("dzh")
        courtot_per_dt = jnp.max(
            jnp.abs(m.u) * grid.dxi + jnp.abs(m.v) * grid.dyi
            + jnp.abs(m.w[..., :nz]) / dzh[:nz][None, None, :])
        dt = state.dt
        candidates = [cfg.run.dtmax,
                      cfg.courant / jnp.maximum(courtot_per_dt, 1e-12)]
        if ekm is not None:
            dzh2i = grid.j("dzh2i")
            diff_per_dt = jnp.maximum(
                jnp.max(ekm * (dzh2i[:nz][None, None, :] + grid.dx2i
                               + grid.dy2i)),
                jnp.max(ekh * (dzh2i[:nz][None, None, :] + grid.dx2i
                               + grid.dy2i)))
            candidates.append(cfg.run.diffnr / jnp.maximum(diff_per_dt, 1e-12))
        new = jnp.minimum(candidates[0], jnp.minimum(candidates[1],
                          candidates[2] if len(candidates) > 2 else np.inf))
        return new.astype(dt.dtype)

    # -- full step -----------------------------------------------------------
    def step(self, state: State) -> State:
        """One full RK3 timestep (3 substeps) + dt/time bookkeeping."""
        # dt from the previous step's fields (tstep_update at rk3step==1)
        openx0 = None
        openy0 = None
        if self.inlet is not None:
            from .ops.openbc import BC_RECYCLE, recycle_planes
            ny, nz = self.grid.jtot, self.grid.ktot
            if self.igparams is not None:
                from .ops.inletgen import inletgen_planes
                planes0 = inletgen_planes(state.ig, self.inlet, ny, nz)
            elif self.inlet.mode == BC_RECYCLE:
                planes0 = recycle_planes(self.inlet, state.m, ny, nz)
            elif state.drv is not None:
                from .ops.openbc import driver_window_planes
                planes0 = driver_window_planes(state.drv, state.timee)
            else:
                planes0 = self.inlet.planes(state.timee, ny, nz)
            openx0 = {"inlet": planes0, "bx": state.m.bx}
        if self.inlet_y is not None:
            planes0y = self.inlet_y.planes(state.timee, self.grid.itot,
                                           self.grid.ktot)
            openy0 = {"inlet": planes0y, "by": state.m.by}
        gvel = _velocity_ghosts(state.m, self.cfg, self.grid, openx0, openy0)
        masks = self.ibm.masks if self.ibm is not None else None
        th = thermodynamics(state.m, self.cfg, self.grid, masks)
        thvs = self.cfg.bc.thls if self.cfg.bc.thls > 0 else 288.0
        pack = (sgs.compute_gradpack(gvel, self.grid)
                if os.environ.get("UDALES_CLOSURE_PACK") == "1" else None)
        ekm, ekh, zlt = sgs.closure(gvel, self.grid, self.cfg,
                                    e12=state.m.e12, dthvdz=th.dthvdz,
                                    thl=state.m.thl, thvs=thvs, pack=pack)
        dt = self.new_dt(state, ekm, ekh)
        state = state.replace(dt=dt, timee=state.timee + dt)
        # c == m at step entry, so substep 1 reuses the diagnostics computed
        # for the adaptive dt instead of re-sweeping closure+thermodynamics.
        # With open boundaries the velocity ghosts are time-interpolated
        # inlet planes and timee just advanced, so recompute the closure
        # there (th is ghost-free and stays exact).
        closed = openx0 is None and openy0 is None
        state = self.substep(state, 1, th=th,
                             closure_out=(ekm, ekh, zlt, pack)
                             if closed else None)
        for rk3step in (2, 3):
            state = self.substep(state, rk3step)
        # facet energy balance fires every dtEB (quantized), modEB.f90:429
        if self.eb is not None and state.fac is not None:
            skyLW = netsw = None
            if self.timedep is not None:
                skyLW = self.timedep.sky_lw(state.timee)
                netsw = self.timedep.net_sw(state.timee)
            dense_tbl = state.ibmp["dense"] if state.ibmp is not None else None
            state = state.replace(
                fac=self.eb.maybe_update(state.fac, state.timee,
                                         skyLW=skyLW, netsw=netsw,
                                         dense_tbl=dense_tbl))
        return state

    def run(self, state: State, nsteps: int) -> State:
        """N steps under lax.scan — fully on device."""
        def body(s, _):
            return self.step(s), None
        final, _ = jax.lax.scan(body, state, None, length=nsteps)
        return final

    def step_jit(self) -> "HoistedJit":
        """`step`, compiled with the model's arrays as arguments."""
        return HoistedJit(self.step)

    def run_jit(self, nsteps: int) -> "HoistedJit":
        """`run(., nsteps)`, compiled with the model's arrays as arguments."""
        return HoistedJit(lambda s: self.run(s, nsteps))


_HOIST_MIN_BYTES = 1 << 16


class HoistedJit:
    """`jax.jit(fn)` whose large closed-over arrays enter the compiled
    program as arguments.

    `Model.step` closes over its precomputed operators (IBM masks and flux
    masks, slot tables, transform matrices).  Under a plain `jax.jit` each
    becomes a constant of the program: at 256^3 that is ~2 GB of generated
    code, seconds of constant folding per mask, and a program too large for
    the persistent compile cache.  Here `fn` is traced to a jaxpr once per
    input structure and placement; its constants of `_HOIST_MIN_BYTES` or
    more are put on the device once and passed in on every call, the small
    ones stay inline.  When an argument is laid out over a mesh, the
    constants are replicated over that mesh, as inline constants would be,
    so no call copies them from one device to the others."""

    def __init__(self, fn):
        self.fn = fn
        self._traced = {}

    def _prepare(self, args):
        flat, tree = jax.tree.flatten(args)
        mesh = next((x.sharding.mesh for x in flat if isinstance(
            getattr(x, "sharding", None), jax.sharding.NamedSharding)), None)
        key = (tree, tuple(jax.typeof(x) for x in flat), mesh)
        if key not in self._traced:
            closed, out_shape = jax.make_jaxpr(
                self.fn, return_shape=True)(*args)
            consts = list(closed.consts)
            big = [i for i, c in enumerate(consts)
                   if getattr(c, "nbytes", 0) >= _HOIST_MIN_BYTES]
            inline = [None if i in big else c for i, c in enumerate(consts)]
            out_tree = jax.tree.structure(out_shape)

            def call(hoisted, flat_args):
                cs = list(inline)
                for i, c in zip(big, hoisted):
                    cs[i] = c
                return jax.tree.unflatten(out_tree, jax.core.eval_jaxpr(
                    closed.jaxpr, cs, *flat_args))

            place = (None if mesh is None else jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec()))
            self._traced[key] = (jax.jit(call),
                                 [jax.device_put(consts[i], place)
                                  for i in big])
        fn, hoisted = self._traced[key]
        return fn, (hoisted, flat)

    def __call__(self, *args):
        fn, call_args = self._prepare(args)
        return fn(*call_args)

    def lower(self, *args):
        """(Lowered, arguments): `lowered.compile()(*arguments)` runs it."""
        fn, call_args = self._prepare(args)
        return fn.lower(*call_args), call_args


def _chem(sv, dt, cfg, IIc):
    from .physics import chem_update
    return chem_update(sv, dt, cfg, IIc)


def _velocity_ghosts(f: Fields, cfg: Config, grid: Grid,
                     openx=None, openy=None) -> Ghosts:
    """Minimal ghost set (u, v, w only) for closure/dt before ekm exists."""
    from .ops.boundary import ghost_u, ghost_v
    return Ghosts(
        u=ghost_u(f.u, cfg, openx=openx, openy=openy),
        v=ghost_v(f.v, cfg, openx=openx, openy=openy),
        w=ghost_w(f.w, cfg, openx=openx, openy=openy),
        thl=None, qt=None, e12=None, sv=None, ekm=None, ekh=None)


def _kappa_ghost_scalar(cfield, cfg, openx=None, openy=None):
    from .ops.boundary import ghost_scalar_kappa
    # thl rides through the sv slot of the open-boundary contexts
    if openx is not None:
        openx = {**openx,
                 "inlet": {**openx["inlet"],
                           "sv": openx["inlet"]["thl"][None]},
                 "bx": dataclasses.replace(openx["bx"],
                                           sv=openx["bx"].thl[None])}
    if openy is not None:
        openy = {**openy,
                 "inlet": {**openy["inlet"],
                           "sv": openy["inlet"]["thl"][None]},
                 "by": dataclasses.replace(openy["by"],
                                           sv=openy["by"].thl[None])}
    return ghost_scalar_kappa(cfield, cfg, openx=openx, openy=openy,
                              sv_index=0)


def _pad_pres(p, openx, openy=None):
    """Pressure ghosts (bcp, modboundary.f90:1344-1430): periodic wrap or
    zero-gradient at open boundaries."""
    if openx is None and openy is None:
        return pad_periodic_xy(p, 1)
    px = (jnp.pad(p, ((1, 1), (0, 0), (0, 0)), mode="edge")
          if openx is not None
          else jnp.pad(p, ((1, 1), (0, 0), (0, 0)), mode="wrap"))
    return (jnp.pad(px, ((0, 0), (1, 1), (0, 0)), mode="edge")
            if openy is not None
            else jnp.pad(px, ((0, 0), (1, 1), (0, 0)), mode="wrap"))


# ---------------------------------------------------------------------------
# Case loading convenience
# ---------------------------------------------------------------------------

def load_case(case_dir: str | Path, expnr: str | None = None,
              dtype: str = "float32", with_ibm: bool = True) -> Model:
    """Build a Model from a reference case directory (namoptions + inputs)."""
    from .config import load_namoptions
    case_dir = Path(case_dir)
    if expnr is None:
        nam = sorted(case_dir.glob("namoptions.*"))[0]
        expnr = nam.suffix[1:]
    cfg = load_namoptions(case_dir / f"namoptions.{expnr}", dtype=dtype)
    dom = cfg.domain
    np_dt = np.float32 if dtype == "float32" else np.float64
    grid = Grid.from_prof_inp(case_dir / f"prof.inp.{expnr}", dom.itot,
                              dom.jtot, dom.ktot, dom.xlen, dom.ylen,
                              dtype=np_dt)
    inputs = CaseInputs.load(case_dir, expnr, dom.ktot, cfg.scalars.nsv)
    ibm = None
    if with_ibm and cfg.run.libm and cfg.walls.nfcts > 0:
        from .ibm.ibm import IBM
        ibm = IBM.load(case_dir, expnr, cfg, grid)
    model = Model(cfg, grid, inputs, ibm)
    if cfg.eb.lEB and ibm is not None:
        from .ibm.eb import FacetEB
        model.eb = FacetEB.load(case_dir, expnr, cfg, ibm,
                                dtype=grid.dtype)
    # time-dependent forcings
    from .timedep import Timedep
    model.timedep = Timedep.load(case_dir, expnr, cfg, dom.ktot,
                                 dtype=grid.dtype)
    # long-tail physics subsystems
    from .physics import HeatPumps, Purifiers, ScalarSources, Vegetation
    if cfg.scalars.nsv > 0 and (cfg.scalars.lscasrc or cfg.scalars.lscasrcl):
        model.scalsources = ScalarSources.load(case_dir, expnr, cfg, grid)
    if cfg.trees.ltrees and (case_dir / f"veg.inp.{expnr}").exists():
        model.vegetation = Vegetation.load(case_dir, expnr, cfg, grid)
    if cfg.purifs.lpurif and (case_dir / f"purifs.inp.{expnr}").exists():
        model.purifiers = Purifiers.load(case_dir, expnr, cfg, grid)
    if (cfg.heatpump.lheatpump
            and (case_dir / f"heatpump.inp.{expnr}").exists()):
        model.heatpumps = HeatPumps.load(case_dir, expnr, cfg, grid)
    if cfg.bc.BCxm == BC_PROFILE or cfg.bc.BCym == BC_PROFILE:
        from .ops.openbc import Inlet
        p = inputs.prof
        j = lambda a: jnp.asarray(a, grid.dtype)
        sv = (jnp.asarray(inputs.scalar, grid.dtype)
              if inputs.scalar is not None
              else jnp.zeros((cfg.scalars.nsv, dom.ktot), grid.dtype))
        inl = Inlet(mode=BC_PROFILE, uprof=j(p["u"]), vprof=j(p["v"]),
                    thlprof=j(p["thl"]), qtprof=j(p["qt"]),
                    e12prof=j(np.maximum(p["e12"], const.e12min)),
                    svprof=sv)
        if cfg.bc.BCxm == BC_PROFILE:
            model.inlet = inl
        if cfg.bc.BCym == BC_PROFILE:
            model.inlet_y = inl
    if cfg.bc.BCxm == BC_DRIVER:
        from .ops.openbc import BC_DRIVER as _BCD, Inlet, load_driver_inlet
        djob = cfg.driver.driverjobnr
        dpath = case_dir / f"driverdata.{djob:03d}.npz"
        tdrv = case_dir / f"tdriver_000.{djob:03d}"
        if cfg.driver.lchunkread and tdrv.exists():
            # streaming replay (lchunkread, moddriver.f90:933): only
            # chunkread_size planes live on device; the Simulation loop
            # refills State.drv between steps (io/driverstream.py)
            from .io.driverstream import DriverStream
            model.inlet = Inlet(mode=_BCD)
            model.driver_stream = DriverStream(
                case_dir, djob, dom.jtot, dom.ktot, grid.dtype,
                chunk=cfg.driver.chunkread_size,
                driverstore=cfg.driver.driverstore or None,
                nsv=cfg.scalars.nsv, ltempeq=cfg.physics.ltempeq,
                lmoist=cfg.physics.lmoist)
        elif dpath.exists():
            model.inlet = load_driver_inlet(dpath, grid.dtype)
        elif tdrv.exists():
            # reference Fortran ?driver_* files (moddriver.f90:750
            # readdriverfile) — direct-access f8 planes per y-rank
            from .io.driverfiles import read_driver_files
            d = read_driver_files(
                case_dir, djob, dom.jtot, dom.ktot,
                driverstore=cfg.driver.driverstore or None,
                nsv=cfg.scalars.nsv, ltempeq=cfg.physics.ltempeq,
                lmoist=cfg.physics.lmoist)
            j = lambda k: (jnp.asarray(d[k], grid.dtype) if k in d else None)
            model.inlet = Inlet(mode=_BCD, t=j("t"), u=j("u"), v=j("v"),
                                w=j("w"), thl=j("thl"), qt=j("qt"),
                                sv=j("sv"))
        else:
            raise FileNotFoundError(
                f"driver-inlet case (idriver=2): neither {dpath.name} nor "
                f"reference driver files (tdriver_000.{djob:03d} + "
                f"?driver_*) found in {case_dir}; record them by running "
                f"the precursor case (idriver=1, experiment {djob:03d}) "
                f"first (moddriver.f90:515/750)")
    elif cfg.driver.iinletgen == 1:
        # full Lund-1998 rescale-recycle generator (modinlet.f90 inletgen):
        # the Inlet holds the profile context (qt/e12/sv planes); the
        # generator state itself lives in State.ig (ops/inletgen.py)
        from .ops.inletgen import InletGenParams
        from .ops.openbc import BC_RECYCLE, Inlet
        p = inputs.prof
        j = lambda a: jnp.asarray(a, grid.dtype)
        model.inlet = Inlet(
            mode=BC_RECYCLE, uprof=j(p["u"]), vprof=j(p["v"]),
            thlprof=j(p["thl"]), qtprof=j(p["qt"]),
            e12prof=j(np.maximum(p["e12"], const.e12min)),
            svprof=jnp.zeros((cfg.scalars.nsv, dom.ktot), grid.dtype),
            irecy=cfg.driver.iplane)
        model.igparams = InletGenParams(cfg, grid)
    elif cfg.driver.iinletgen == 2:
        # replay planes recorded by a previous iinletgen=1 run
        # (modinlet.f90:860-944 readinletfile analogue; lerp in time)
        from .ops.openbc import BC_DRIVER as _BCD, Inlet
        ip = case_dir / f"inletdata.{cfg.driver.driverjobnr:03d}.npz"
        if not ip.exists():
            raise FileNotFoundError(
                f"{ip}: iinletgen=2 needs planes recorded by running the "
                f"generator case (iinletgen=1, lstoreplane) first")
        d = np.load(ip)
        j = lambda a: jnp.asarray(a, grid.dtype)
        nt = len(d["t"])
        model.inlet = Inlet(
            mode=_BCD, t=j(d["t"]), u=j(d["u"]), v=j(d["v"]), w=j(d["w"]),
            thl=j(d["thl"]),
            qt=jnp.broadcast_to(
                j(inputs.prof["qt"])[None, None, :],
                (nt, dom.jtot, dom.ktot)),
            sv=jnp.zeros((nt, cfg.scalars.nsv, dom.jtot, dom.ktot),
                         grid.dtype),
            e12prof=j(np.maximum(inputs.prof["e12"], const.e12min)))
    return model
