"""Simulation driver: the program.f90 equivalent.

Runs the jitted RK3 step in device-resident chunks between host-side output
events (field dumps, statistics samples, restart writes, runtime monitor),
honouring the reference's cadences (tfielddump, tsample/tstatsdump,
trestart, tcheck) and the ``exit_now.<exp>`` graceful-stop sentinel
(modsave.f90:63-75).
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from .run import Model
from .io.fielddump import FieldDump
from .io.stats import XYTDump
from .io.restart import save_checkpoint, save_npz


class DriverRecorder:
    """Precursor-plane recorder (idriver=1, moddriver.f90 drivergen:174 /
    writedriverfile:515): every dtdriver after tdriverstart, store the y-z
    planes of u (at face iplane), v, w, thl, qt, sv; saved as
    driverdata.<exp>.npz for replay via ops.openbc.load_driver_inlet."""

    def __init__(self, cfg, grid, outdir):
        self.cfg = cfg
        self.grid = grid
        self.outdir = Path(outdir)
        self.tnext = cfg.driver.tdriverstart
        self.frames = []
        self.times = []

    def maybe_record(self, state):
        t = float(state.timee)
        if t < self.tnext:
            return
        self.tnext += self.cfg.driver.dtdriver
        c = state.c
        nx = self.grid.itot
        ip = self.cfg.driver.iplane % nx    # face index (wraps at itot)
        ic = min(ip, nx - 1)
        self.times.append(t)
        self.frames.append(dict(
            u=np.asarray(c.u[ip % nx]), v=np.asarray(c.v[ic]),
            w=np.asarray(c.w[ic]), thl=np.asarray(c.thl[ic]),
            qt=np.asarray(c.qt[ic]),
            sv=np.asarray(c.sv[:, ic]) if c.sv.shape[0] else None))

    def save(self):
        if not self.frames:
            return None
        exp = f"{self.cfg.run.iexpnr:03d}"
        path = self.outdir / f"driverdata.{exp}.npz"
        planes = {k: np.stack([fr[k] for fr in self.frames])
                  for k in ("u", "v", "w", "thl", "qt")}
        planes["sv"] = (np.stack([fr["sv"] for fr in self.frames])
                        if self.frames[0]["sv"] is not None else None)
        save_npz(path, {"t": np.asarray(self.times),
                        **{k: v for k, v in planes.items()
                           if v is not None}})
        # also emit the reference's Fortran direct-access ?driver_* files
        # (moddriver.f90 writedriverfile:515) so a reference main run — or
        # this framework's idriver=2 path — can consume them directly
        from .io.driverfiles import write_driver_files
        write_driver_files(self.outdir, exp, np.asarray(self.times), planes,
                           self.grid.jtot, self.grid.ktot,
                           tdriverstart=self.cfg.driver.tdriverstart)
        return path


class Simulation:
    def __init__(self, model: Model, outdir: str | Path = ".",
                 monitor: bool = True):
        self.model = model
        self.cfg = model.cfg
        self.outdir = Path(outdir)
        self.outdir.mkdir(parents=True, exist_ok=True)
        self.step = model.step_jit()
        self.outputs = []
        if self.cfg.output.lfielddump:
            self.fielddump = FieldDump(
                self.cfg, model.grid, self.outdir,
                masks=model.ibm.masks if model.ibm is not None else None)
        else:
            self.fielddump = None
        if self.cfg.output.lxytdump:
            self.xytdump = XYTDump(self.cfg, model.grid, self.outdir,
                                   model=model)
        else:
            self.xytdump = None
        from .io.stats import (MinTDump, SliceDump, TDump, TKEDump, TreeDump,
                               XYDump, YDump, YTDump)
        nsv = self.cfg.scalars.nsv
        self.xydump = (XYDump(self.cfg, model.grid, self.outdir,
                              model=model)
                       if self.cfg.output.lxydump else None)
        self.ydump = (YDump(self.cfg, model.grid, self.outdir, nsv=nsv,
                            model=model)
                      if self.cfg.output.lydump else None)
        self.tdump = (TDump(self.cfg, model.grid, self.outdir, nsv,
                            model=model)
                      if self.cfg.output.ltdump else None)
        self.tkedump = (TKEDump(self.cfg, model.grid, self.outdir, model)
                        if self.cfg.output.ltkedump else None)
        self.ytdump = (YTDump(self.cfg, model.grid, self.outdir, nsv=nsv,
                              model=model)
                       if self.cfg.output.lytdump else None)
        self.mintdump = (MinTDump(self.cfg, model.grid, self.outdir)
                         if self.cfg.output.lmintdump else None)
        self.treedump = (TreeDump(self.cfg, model.grid, model.vegetation,
                                  self.outdir)
                         if (self.cfg.output.ltreedump
                             and model.vegetation is not None) else None)
        o = self.cfg.output
        self.slices = (SliceDump(self.cfg, model.grid, self.outdir, nsv)
                       if (o.lkslicedump or o.lislicedump or o.ljslicedump)
                       else None)
        self.facwriter = None
        if self.cfg.eb.lEB and self.cfg.eb.lwriteEBfiles and model.eb:
            from .io.netcdf import NCWriter
            exp = f"{self.cfg.run.iexpnr:03d}"
            w = NCWriter(self.outdir / f"facT.{exp}.nc",
                         nfcts=model.eb.nfcts,
                         nlayers=self.cfg.eb.nfaclyrs + 1)
            w.define("T", ("facet", "layer"), "K", "Temperature")
            w.define("dTdz", ("facet", "layer"), "K/m",
                     "Temperature gradient")
            w2 = NCWriter(self.outdir / f"facEB.{exp}.nc",
                          nfcts=model.eb.nfcts)
            w2.define("netsw", ("facet",), "W/m^2", "Net shortwave")
            w2.define("LWin", ("facet",), "W/m^2", "Incoming longwave")
            w2.define("LWout", ("facet",), "W/m^2", "Outgoing longwave")
            w2.define("hf", ("facet",), "W/m^2", "Sensible heat")
            w2.define("ef", ("facet",), "W/m^2", "Latent heat")
            w2.define("WGR", ("facet",), "?", "Water content")
            self.facwriter = (w, w2)
            self._last_facwrite = 0.0
        # fac.<exp>.nc facet stress/pressure output (lwritefac,
        # modibm.f90:198-247)
        self.facstatwriter = None
        if self.cfg.walls.lwritefac and model.ibm is not None:
            from .io.netcdf import NCWriter
            exp = f"{self.cfg.run.iexpnr:03d}"
            wf = NCWriter(self.outdir / f"fac.{exp}.nc",
                          nfcts=model.ibm.nfcts)
            wf.define("tau_x", ("facet",), "m^2/s^2", "tau_x")
            wf.define("tau_y", ("facet",), "m^2/s^2", "tau_y")
            wf.define("tau_z", ("facet",), "m^2/s^2", "tau_z")
            wf.define("pres", ("facet",), "m^2/s^2", "pressure")
            wf.define("htc", ("facet",), "", "heat transfer coefficient")
            wf.define("cth", ("facet",), "",
                      "heat transfer coefficient (Ivo)")
            wf.define("pres_flc", ("facet",), "", "pressure fluctuation")
            self.facstatwriter = wf
            self.tnextfacstat = self.cfg.walls.dtfac
        self.monitor = monitor
        # tcheck cadence (modchecksim.f90:37,64-67): report every tcheck
        # seconds of simulated time; tcheck=0 means every step.
        self.tcheck = self.cfg.output.tcheck
        self.tnextcheck = 0.0
        self.tnextrestart = self.cfg.run.trestart
        self.ntrun = 0
        # per-step monitor file (modtstep.f90:290-320 writes monitor<id>.txt)
        self._monitor_path = self.outdir / f"monitor.{self._exp()}.txt"
        self._monitor_file = None
        self.profile_dir = None  # set to a path to enable jax.profiler
        self.driver_rec = (DriverRecorder(self.cfg, model.grid, self.outdir)
                           if self.cfg.driver.idriver == 1 else None)
        # inlet-plane recorder (lstoreplane, modinlet.f90 writeinletfile):
        # the generated planes live in State.ig; stored once per full step
        self.inlet_rec = ([] if (self.cfg.driver.iinletgen == 1
                                 and self.cfg.driver.lstoreplane) else None)
        self._inlet_rec_t = []

    def _exp(self):
        return f"{self.cfg.run.iexpnr:03d}"

    def run(self, state=None, runtime: float | None = None, seed: int = 43):
        cfg = self.cfg
        if state is None:
            state = self.model.cold_start(seed=seed)
        runtime = runtime if runtime is not None else cfg.run.runtime
        t_end = float(state.timee) + runtime
        # warmstart: fast-forward output timers to the first cadence
        # multiple at/after the restart time (otherwise every writer would
        # fire once per step while catching up from t=0)
        t0 = float(state.timee)

        def _ff(obj, attr, cad):
            if (obj is not None and cad > 0 and hasattr(obj, attr)
                    and getattr(obj, attr) < t0):
                setattr(obj, attr, cad * math.ceil(t0 / cad + 1e-9))
        _ff(self.fielddump, "tnext", cfg.output.tfielddump)
        for w in (self.xytdump, self.tdump, self.tkedump, self.ytdump,
                  self.mintdump, self.treedump):
            _ff(w, "tnext_sample", cfg.output.tsample)
            _ff(w, "tnext_write", cfg.output.tstatsdump)
        for w in (self.xydump, self.ydump, self.slices):
            for attr, cad in (("tnext", cfg.output.tsample),
                              ("tnext_sample", cfg.output.tsample),
                              ("tnext_write", cfg.output.tstatsdump)):
                if w is not None and hasattr(w, attr):
                    _ff(w, attr, cad)
        _ff(self, "tnextrestart", cfg.run.trestart)
        _ff(self, "tnextcheck", self.tcheck)
        masks = self.model.ibm.masks if self.model.ibm else None
        wall0 = time.time()
        nsteps = 0
        prof_ctx = None
        if self.profile_dir is not None:
            jax.profiler.start_trace(str(self.profile_dir))
            prof_ctx = True
        while float(state.timee) < t_end:
            if self.model.driver_stream is not None:
                # streaming precursor replay: swap in the next chunk when
                # timee crosses the device window (lchunkread equivalent;
                # same shapes -> no recompile)
                state = self.model.driver_stream.ensure(state)
            state = self.step(state)
            nsteps += 1
            self.ntrun += 1
            t = float(state.timee)  # device sync once per step
            if self.fielddump is not None:
                self.fielddump.maybe_dump(state)
            if self.xytdump is not None:
                self.xytdump.maybe_sample(state, masks)
            if self.driver_rec is not None:
                self.driver_rec.maybe_record(state)
            if self.inlet_rec is not None and state.ig is not None:
                self._inlet_rec_t.append(t)
                self.inlet_rec.append(
                    dict(u=np.asarray(state.ig.u0),
                         v=np.asarray(state.ig.v0),
                         w=np.asarray(state.ig.w0),
                         thl=np.asarray(state.ig.t0)))
            if self.tdump is not None:
                self.tdump.maybe_sample(state)
            if self.tkedump is not None:
                self.tkedump.maybe_sample(state)
            if self.xydump is not None:
                self.xydump.maybe_dump(state, masks)
            if self.ydump is not None:
                self.ydump.maybe_dump(state, masks)
            if self.ytdump is not None:
                self.ytdump.maybe_sample(state, masks)
            if self.slices is not None:
                self.slices.maybe_dump(state)
            if self.mintdump is not None:
                self.mintdump.maybe_sample(state)
            if self.treedump is not None:
                self.treedump.maybe_sample(state)
            if self.monitor and (t >= self.tnextcheck if self.tcheck > 0
                                 else nsteps % 50 == 0):
                # modchecksim.f90: every tcheck simulated seconds; tcheck=0
                # means every step in the reference — here throttled to every
                # 50 steps to avoid a device sync per step (deviation).
                self.tnextcheck = t + self.tcheck
                self._checksim(state, nsteps, wall0)
            if (self.facwriter is not None and state.fac is not None
                    and t >= self._last_facwrite + self.cfg.eb.dtEB):
                self._last_facwrite = t
                self._write_fac(state, t)
            if (self.facstatwriter is not None
                    and state.facstats is not None
                    and t >= self.tnextfacstat):
                state = self._write_facstats(state, t)
                self.tnextfacstat = round(t + self.cfg.walls.dtfac)
            if t >= self.tnextrestart:
                self.tnextrestart += cfg.run.trestart
                self._write_restart(state)
            if self._monitor_file is None:
                self._monitor_file = open(self._monitor_path, "a")
            self._monitor_file.write(f"{t:14.6e} {float(state.dt):14.6e}\n")
            if (self.outdir / f"exit_now.{self._exp()}").exists():
                self._write_restart(state)
                break
            if prof_ctx is not None and nsteps == 12:
                jax.profiler.stop_trace()
                prof_ctx = None
        if self._monitor_file is not None:
            self._monitor_file.close()
            self._monitor_file = None
        if self.fielddump:
            self.fielddump.close()
        if self.xytdump:
            self.xytdump.close()
        if self.driver_rec is not None:
            self.driver_rec.save()
        if self.inlet_rec:
            np.savez(self.outdir / f"inletdata.{self._exp()}.npz",
                     t=np.asarray(self._inlet_rec_t),
                     u=np.stack([f["u"] for f in self.inlet_rec]),
                     v=np.stack([f["v"] for f in self.inlet_rec]),
                     w=np.stack([f["w"] for f in self.inlet_rec]),
                     thl=np.stack([f["thl"] for f in self.inlet_rec]))
        if self.facstatwriter is not None:
            self.facstatwriter.close()
        for extra in (self.tdump, self.ytdump, self.slices, self.tkedump,
                      self.xydump, self.ydump, self.mintdump, self.treedump):
            if extra is not None:
                extra.close()
        if prof_ctx is not None:
            jax.profiler.stop_trace()
        return state

    def _write_facstats(self, state, t):
        """fac.<exp>.nc write (modibm.f90:1256-1280): normalize the
        dt-weighted sums by the elapsed interval, write, reset.  The
        pressure fluctuation is the proper interval variance
        <p^2> - <p>^2 (the reference's expression at modibm.f90:1265 mixes
        dtfac and tfac in the mean-square term; deliberate deviation)."""
        import numpy as np
        from .state import zero_facstats
        fs = state.facstats
        tint = max(t - float(fs.tlast), 1e-9)
        avg = lambda a: np.asarray(a) / tint
        pav = avg(fs.pres)
        self.facstatwriter.append(t, {
            "tau_x": avg(fs.tau_x), "tau_y": avg(fs.tau_y),
            "tau_z": avg(fs.tau_z), "pres": pav,
            "htc": avg(fs.htc), "cth": avg(fs.cth),
            "pres_flc": avg(fs.pres2) - pav * pav,
        })
        nf = len(np.asarray(fs.tau_x))
        fresh = zero_facstats(nf, self.model.grid.dtype)
        import dataclasses
        fresh = dataclasses.replace(fresh, tlast=jnp.asarray(
            t, self.model.grid.dtype))
        return state.replace(facstats=fresh)

    def _write_fac(self, state, t):
        """facT/facEB outputs (modEB.f90:510-532)."""
        import numpy as np
        from udales_jax.config import const
        eb = self.model.eb
        fac = state.fac
        wT, wEB = self.facwriter
        T = np.asarray(fac.T)
        wT.append(t, {"T": T, "dTdz": np.asarray(fac.Tdash)})
        em = np.asarray(eb.facem)
        wEB.append(t, {
            "netsw": np.asarray(eb.netsw),
            "LWin": np.asarray(eb.calclw(fac.T)),
            "LWout": const.boltz * em * T[:, 0] ** 4,
            "hf": np.asarray(fac.hfi),
            "ef": np.asarray(fac.efi),
            "WGR": np.asarray(fac.wsoil),
        })

    def _stats_writers(self):
        """Active statistics writers with resumable accumulators."""
        out = {}
        for name in ("xytdump", "tdump", "ytdump", "tkedump", "mintdump",
                     "treedump"):
            w = getattr(self, name, None)
            if w is not None and hasattr(w, "acc"):
                out[name] = w
        return out

    def _write_restart(self, state):
        name = self.outdir / f"initd{self.ntrun:08d}.{self._exp()}.npz"
        # statistics continuation (the reference's lreadmean pathway,
        # modstartup.f90:2225-2280, reads legacy means/SGS files; here the
        # live accumulators of every enabled family ride the checkpoint as
        # stats/<fam>/acc/<name>, with the cadence under stats/<fam>/)
        extra = {}
        for fam, w in self._stats_writers().items():
            acc = jax.device_get(w.acc)
            items = (acc.items() if isinstance(acc, dict)
                     else dataclasses.asdict(acc).items())
            for k, v in items:
                extra[f"stats/{fam}/acc/{k}"] = v
            extra[f"stats/{fam}/tnext_sample"] = w.tnext_sample
            extra[f"stats/{fam}/tnext_write"] = w.tnext_write
        save_checkpoint(name, state, self.ntrun, extra=extra)

    def resume_stats(self, ckpt_path):
        """Restore statistics accumulators from a checkpoint written by
        _write_restart (lreadmean-equivalent continuation)."""
        with np.load(ckpt_path) as f:
            for fam, w in self._stats_writers().items():
                pre = f"stats/{fam}/"
                if pre + "tnext_sample" not in f:
                    continue
                data = {k[len(pre + "acc/"):]: jnp.asarray(f[k])
                        for k in f.files if k.startswith(pre + "acc/")}
                if isinstance(w.acc, dict):
                    w.acc = {k: data.get(k, v) for k, v in w.acc.items()}
                else:
                    w.acc = type(w.acc)(**data)
                w.tnext_sample = float(f[pre + "tnext_sample"])
                w.tnext_write = float(f[pre + "tnext_write"])

    def _checksim(self, state, nsteps, wall0):
        """Runtime monitor (modchecksim.f90:76-205): Courant number,
        diffusion number, and max divergence."""
        grid = self.model.grid
        cfg = self.model.cfg
        c = state.c
        nz = grid.ktot
        cour = float(jnp.max(
            jnp.abs(c.u) * grid.dxi + jnp.abs(c.v) * grid.dyi
            + jnp.abs(c.w[..., :nz])
            / jnp.asarray(grid.j("dzh"))[:nz][None, None, :]) * state.dt)
        gu = jnp.pad(c.u, ((0, 1), (0, 0), (0, 0)), mode="wrap")
        gv = jnp.pad(c.v, ((0, 0), (0, 1), (0, 0)), mode="wrap")
        div = ((gu[1:] - gu[:-1]) * grid.dxi
               + (gv[:, 1:] - gv[:, :-1]) * grid.dyi
               + (c.w[:, :, 1:] - c.w[:, :, :-1])
               * jnp.asarray(grid.j("dzfi"))[None, None, :])
        # diffusion number (modchecksim.calcdiffnr:129-160): recompute the
        # closure on the current fields, max over ekm AND ekh
        from udales_jax.ops import subgrid as sgs
        from udales_jax.ops.thermo import thermodynamics
        from udales_jax.run import _velocity_ghosts
        th = thermodynamics(c, cfg, grid,
                            self.model.ibm.masks if self.model.ibm else None)
        gvel = _velocity_ghosts(c, cfg, grid)
        thvs = cfg.bc.thls if cfg.bc.thls > 0 else 288.0
        ekm, ekh, _ = sgs.closure(gvel, grid, cfg, e12=c.e12,
                                  dthvdz=th.dthvdz, thl=c.thl, thvs=thvs)
        dzh2i = jnp.asarray(grid.j("dzh2i"))[:nz][None, None, :]
        diffnr = float(jnp.maximum(
            jnp.max(ekm * (dzh2i + grid.dx2i + grid.dy2i)),
            jnp.max(ekh * (dzh2i + grid.dx2i + grid.dy2i))) * state.dt)
        rate = nsteps / max(time.time() - wall0, 1e-9)
        print(f"  t={float(state.timee):9.2f}s dt={float(state.dt):.4f} "
              f"CFL={cour:.3f} diffnr={diffnr:.3f} "
              f"max|div|={float(jnp.abs(div).max()):.2e} "
              f"[{rate:.1f} steps/s]", flush=True)


def execute_runmode_actions(model, case_dir) -> int | None:
    """In-solver test runmodes dispatched before the time loop
    (program.f90:239-275; test bodies src/tests.f90). Returns an exit code
    for runmodes 1003/1004/1005, None for a normal run (runmode 1)."""
    import jax.numpy as jnp
    from .ops.thermo import avexy_masked
    cfg, grid = model.cfg, model.grid
    rm = cfg.run.runmode
    if rm == 1003:
        # tests_2decomp_init_exit (tests.f90:30-45): print the layout
        devs = jax.devices()
        print(f"runmode 1003: {len(devs)} device(s): {devs}")
        if model.mesh is not None:
            print(f"mesh {dict(zip(model.mesh.axis_names, model.mesh.devices.shape))}")
        print(f"grid {grid.itot}x{grid.jtot}x{grid.ktot}")
        return 0
    if rm == 1004:
        # tests_read_sparse_ijk (tests.f90:47-133): the sparse readers must
        # agree with the &WALLS counts and stay inside the grid
        from .io.inputs import read_sparse_ijk
        exp = f"{cfg.run.iexpnr:03d}"
        ok = True
        lims = {"u": (grid.itot, grid.jtot, grid.ktot),
                "v": (grid.itot, grid.jtot, grid.ktot),
                "w": (grid.itot, grid.jtot, grid.ktot + 1),
                "c": (grid.itot, grid.jtot, grid.ktot)}
        for s in "uvwc":
            for stem, key in ((f"solid_{s}.txt", f"nsolpts_{s}"),
                              (f"fluid_boundary_{s}.txt", f"nbndpts_{s}")):
                p = Path(case_dir) / stem
                if not p.exists():
                    continue
                ijk = read_sparse_ijk(p)
                want = getattr(cfg.walls, key)
                if len(ijk) != want:
                    print(f"runmode 1004 FAIL: {stem} has {len(ijk)} "
                          f"points, &WALLS says {want}")
                    ok = False
                if len(ijk) and (ijk.min() < 0
                                 or (ijk.max(axis=0) >= lims[s]).any()):
                    print(f"runmode 1004 FAIL: {stem} out of bounds")
                    ok = False
        print(f"runmode 1004: {'PASS' if ok else 'FAIL'}")
        return 0 if ok else 1
    if rm == 1005:
        # tests_mpi_operators (tests.f90:215-429): masked reductions vs
        # local brute force — here the distributed path is XLA GSPMD, so
        # the oracle is plain numpy on the gathered arrays
        rng = np.random.default_rng(7)
        nx, ny, nz = grid.shape
        f = rng.random((nx, ny, nz))
        mask = (rng.random((nx, ny, nz)) > 0.3).astype(float)
        got = np.asarray(avexy_masked(jnp.asarray(f), jnp.asarray(mask)))
        cnt = mask.sum(axis=(0, 1))
        want = np.where(cnt > 0, (f * mask).sum(axis=(0, 1))
                        / np.maximum(cnt, 1), -999.0)
        ok = np.allclose(got, want, atol=1e-12)
        # avey/sumx/sumy semantics (modmpi.f90:691-752)
        gy = np.asarray(jnp.sum(jnp.asarray(f * mask), axis=1)
                        / jnp.maximum(jnp.sum(jnp.asarray(mask), axis=1), 1))
        wy = (f * mask).sum(axis=1) / np.maximum(mask.sum(axis=1), 1)
        ok &= np.allclose(gy, wy, atol=1e-12)
        ok &= np.allclose(np.asarray(jnp.sum(jnp.asarray(f * mask), axis=0)),
                          (f * mask).sum(axis=0), atol=1e-12)
        print(f"runmode 1005: {'PASS' if ok else 'FAIL'}")
        return 0 if ok else 1
    return None


def main(argv=None):
    """CLI: python -m udales_jax <case_dir_or_namoptions> [outdir]"""
    import argparse
    from .run import load_case
    ap = argparse.ArgumentParser(prog="udales_jax",
                                 description="urban LES (uDALES in JAX)")
    ap.add_argument("case", help="case directory or namoptions.<exp> path")
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--runtime", type=float, default=None)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=43)
    ap.add_argument("--profile", default=None,
                    help="directory for a jax.profiler trace of the first "
                         "~12 steps")
    args = ap.parse_args(argv)
    from .device import enable_compile_cache
    enable_compile_cache()

    case = Path(args.case)
    if case.is_file():
        expnr = case.suffix[1:]
        case = case.parent
    else:
        expnr = None
    model = load_case(case, expnr, dtype=args.dtype)
    rc = execute_runmode_actions(model, case)
    if rc is not None:
        raise SystemExit(rc)
    outdir = args.outdir or "."
    sim = Simulation(model, outdir)
    if args.profile:
        sim.profile_dir = args.profile
    print(f"udales_jax: case {case} grid {model.grid} "
          f"devices {jax.devices()}", flush=True)
    state = None
    if ((model.cfg.run.lwarmstart or model.cfg.run.lstratstart)
            and model.cfg.run.startfile):
        exp = f"{model.cfg.run.iexpnr:03d}"
        if model.cfg.run.startfile.endswith(".npz"):
            # native checkpoint resume
            from .io.restart import load_checkpoint
            ck = case / model.cfg.run.startfile
            ck = ck if ck.exists() else Path(outdir) / model.cfg.run.startfile
            state = load_checkpoint(ck, model.grid, model=model)
            sim.resume_stats(ck)   # lreadmean-equivalent continuation
        else:
            # reference Fortran unformatted restart files
            from .io.restart import warmstart_state
            sdir = case / "warmstart_files"
            sdir = sdir if sdir.exists() else case
            state = warmstart_state(sdir, model.cfg.run.startfile, exp,
                                    model.cfg, model.grid)
        if model.cfg.run.lstratstart and model.inputs is not None:
            # lstratstart (modstartup.f90:991-1084): keep the restart
            # velocities but re-impose the thl/qt profiles from prof.inp
            import dataclasses
            import jax.numpy as jnp
            p = model.inputs.prof
            nx, ny, nz = model.grid.shape
            dt_ = model.grid.dtype
            tile = lambda prof: jnp.broadcast_to(
                jnp.asarray(prof, dt_)[None, None, :], (nx, ny, nz))
            thl3, qt3 = tile(p["thl"]), tile(p["qt"])
            newf = lambda f: dataclasses.replace(f, thl=thl3, qt=qt3)
            state = state.replace(m=newf(state.m), c=newf(state.c))
        state = model.attach_params(state)
        print(f"warmstart from {model.cfg.run.startfile} "
              f"t={float(state.timee):.2f}", flush=True)
    final = sim.run(state, runtime=args.runtime, seed=args.seed)
    print(f"done: t={float(final.timee):.3f}s", flush=True)
    return final
