"""Output subsystem tests: NetCDF writer round-trip, fielddump naming,
statistics accumulation, checkpoint round-trip, Fortran restart ingest."""
import struct
from pathlib import Path

import jax
import numpy as np
import pytest

from tests.test_core import make_cfg, make_model, init_state


class TestNetCDF:
    def test_roundtrip(self, tmp_path):
        from udales_jax.io.netcdf import NCWriter
        from scipy.io import netcdf_file
        model = make_model()
        w = NCWriter(tmp_path / "t.nc", model.grid)
        w.define("u", ("zt", "yt", "xm"), "m/s")
        arr = np.random.default_rng(0).standard_normal(model.grid.shape)
        w.append(1.5, {"u": arr})
        w.append(2.5, {"u": arr * 2})
        w.close()
        f = netcdf_file(str(tmp_path / "t.nc"), "r", mmap=False)
        assert list(f.variables["time"][:]) == [1.5, 2.5]
        got = f.variables["u"][0].transpose(2, 1, 0)
        np.testing.assert_allclose(got, arr.astype(np.float32), rtol=1e-6)
        assert f.variables["xt"].shape[0] == model.grid.itot

    def test_fielddump(self, tmp_path):
        import dataclasses
        from udales_jax.io.fielddump import FieldDump
        from scipy.io import netcdf_file
        cfg = make_cfg()
        cfg = dataclasses.replace(cfg, output=dataclasses.replace(
            cfg.output, lfielddump=True, tfielddump=1.0,
            fieldvars="u0,w0,th"))
        model = make_model(cfg)
        state = init_state(model)
        fd = FieldDump(cfg, model.grid, tmp_path)
        fd.dump(state)
        fd.close()
        f = netcdf_file(str(tmp_path / "fielddump.000.nc"), "r", mmap=False)
        assert set(f.variables) >= {"u", "w", "thl", "time", "xt", "zm"}
        assert f.variables["u"].shape[1:] == (8, 12, 16)  # (zt, yt, xm)


class TestStats:
    def test_xyt_accumulation(self, tmp_path):
        from udales_jax.io.stats import XYTDump
        import dataclasses
        cfg = make_cfg()
        cfg = dataclasses.replace(cfg, output=dataclasses.replace(
            cfg.output, lxytdump=True, tsample=0.01, tstatsdump=0.02))
        model = make_model(cfg)
        state = init_state(model)
        xy = XYTDump(cfg, model.grid, tmp_path)
        state = state.replace(timee=state.timee + 1.0)
        xy.maybe_sample(state)
        xy.close()
        from scipy.io import netcdf_file
        f = netcdf_file(str(tmp_path / "xytdump.000.nc"), "r", mmap=False)
        u = f.variables["uxyt"][0]
        np.testing.assert_allclose(
            u, np.asarray(state.c.u).mean(axis=(0, 1)), rtol=1e-5)


class TestRestart:
    def test_checkpoint_roundtrip(self, tmp_path):
        from udales_jax.io.restart import save_checkpoint, load_checkpoint
        model = make_model()
        state = init_state(model)
        save_checkpoint(tmp_path / "ck.npz", state)
        s2 = load_checkpoint(tmp_path / "ck.npz", model.grid)
        np.testing.assert_array_equal(np.asarray(s2.c.u),
                                      np.asarray(state.c.u))
        assert float(s2.dt) == float(state.dt)

    def test_fortran_restart_synthetic(self, tmp_path):
        """Write a synthetic reference-format initd pair and read it back."""
        from udales_jax.io.restart import read_fortran_restart
        itot = jtot = 8
        ktot = 4
        npx = npy = 2
        imax, jmax = itot // npx, jtot // npy
        shape = (imax + 2, jmax + 2, ktot + 1)
        rng = np.random.default_rng(5)
        glob = {n: rng.standard_normal((itot, jtot, ktot + 1))
                for n in ["u", "v", "w", "pres", "thl", "e12", "ekm",
                          "qt", "ql", "qlh"]}

        def rec(payload):
            return (struct.pack("<i", len(payload)) + payload
                    + struct.pack("<i", len(payload)))

        for px in range(npx):
            for py in range(npy):
                parts = []
                parts.append(rec(np.zeros((imax, jmax, ktot)).tobytes()))
                parts.append(rec(np.zeros((imax, jmax, ktot, 5)).tobytes()))
                for n in ["u", "v", "w", "pres", "thl", "e12", "ekm",
                          "qt", "ql", "qlh"]:
                    loc = np.zeros(shape)
                    # fill interior from the global array (halos stay 0)
                    loc[1:-1, 1:-1, :] = glob[n][px * imax:(px + 1) * imax,
                                                 py * jmax:(py + 1) * jmax]
                    parts.append(rec(loc.astype("<f8").tobytes(order="F")))
                parts.append(rec(struct.pack("<2d", 7.25, 0.125)))
                (tmp_path / f"initd00000001_{px:03d}_{py:03d}.042").write_bytes(
                    b"".join(parts))
        out, _, timee, dt = read_fortran_restart(
            tmp_path, "initd00000001_xxx_xxx.042", "042",
            itot, jtot, ktot, npx, npy)
        assert timee == 7.25 and dt == 0.125
        np.testing.assert_allclose(out["u"], glob["u"])
        np.testing.assert_allclose(out["qlh"], glob["qlh"])


class TestSimulation:
    def test_cli_driver(self, tmp_path):
        """End-to-end: Simulation drives a tiny case with outputs."""
        import dataclasses
        from udales_jax.sim import Simulation
        cfg = make_cfg()
        cfg = dataclasses.replace(
            cfg,
            run=dataclasses.replace(cfg.run, ladaptive=False, dtmax=0.05,
                                    trestart=0.2, lrandomize=True),
            output=dataclasses.replace(cfg.output, lfielddump=True,
                                       tfielddump=0.1, fieldvars="u0,w0",
                                       lxytdump=True, tsample=0.05,
                                       tstatsdump=0.15))
        model = make_model(cfg)
        sim = Simulation(model, tmp_path, monitor=False)
        final = sim.run(runtime=0.3)
        assert float(final.timee) >= 0.3
        assert (tmp_path / "fielddump.000.nc").exists()
        assert (tmp_path / "xytdump.000.nc").exists()
        assert list(tmp_path.glob("initd*.npz"))

    def test_tdump_slices_ytdump(self, tmp_path):
        import dataclasses
        from udales_jax.sim import Simulation
        from scipy.io import netcdf_file
        cfg = make_cfg()
        cfg = dataclasses.replace(
            cfg,
            run=dataclasses.replace(cfg.run, ladaptive=False, dtmax=0.05,
                                    lrandomize=True),
            output=dataclasses.replace(cfg.output, ltdump=True,
                                       lytdump=True, lkslicedump=True,
                                       lislicedump=True, kslice=2, islice=3,
                                       tsample=0.05, tstatsdump=0.15))
        model = make_model(cfg)
        sim = Simulation(model, tmp_path, monitor=False)
        sim.run(runtime=0.3)
        td = netcdf_file(str(tmp_path / "tdump.000.nc"), "r", mmap=False)
        assert td.variables["ut"].shape[1:] == (8, 12, 16)
        assert np.isfinite(td.variables["upwpt"][:]).all()
        yt = netcdf_file(str(tmp_path / "ytdump.000.nc"), "r", mmap=False)
        assert yt.variables["uyt"].shape[1:] == (8, 16)
        ks = netcdf_file(str(tmp_path / "kslicedump.000.nc"), "r",
                         mmap=False)
        assert ks.variables["u_kslice"].shape[1:] == (12, 16)
        assert ks.variables["time"].shape[0] >= 4

    def test_mintdump_treedump(self, tmp_path):
        """lmintdump/ltreedump write time-averaged prognostics and
        vegetation tendencies (modstatsdump.f90:341,364)."""
        import dataclasses
        from udales_jax.sim import Simulation
        from udales_jax.config import TreesConfig
        from udales_jax.physics import Vegetation
        from scipy.io import netcdf_file
        cfg = make_cfg()
        cfg = dataclasses.replace(
            cfg,
            run=dataclasses.replace(cfg.run, ladaptive=False, dtmax=0.05,
                                    lrandomize=True),
            trees=dataclasses.replace(cfg.trees, ltrees=True),
            output=dataclasses.replace(cfg.output, lmintdump=True,
                                       ltreedump=True,
                                       tsample=0.05, tstatsdump=0.15))
        model = make_model(cfg)
        nx, ny, nz = model.grid.shape
        lad = np.zeros((nx, ny, nz))
        lad[4:8, 4:8, 0:3] = 1.2
        model.vegetation = Vegetation(cfg, model.grid, lad, lad * 0.2,
                                      np.full_like(lad, 0.01) * (lad > 0),
                                      np.full_like(lad, 0.05),
                                      np.full_like(lad, 100.0))
        sim = Simulation(model, tmp_path, monitor=False)
        sim.run(runtime=0.3)
        mt = netcdf_file(str(tmp_path / "mintdump.000.nc"), "r", mmap=False)
        assert mt.variables["ut"].shape[1:] == (8, 12, 16)
        assert np.isfinite(mt.variables["pt"][:]).all()
        tr = netcdf_file(str(tmp_path / "treedump.000.nc"), "r", mmap=False)
        tru = tr.variables["tr_u"][:]
        assert np.isfinite(tru).all()
        # drag opposes the mean flow inside the canopy, zero outside
        assert tru[0, 1, 5, 5] < 0
        assert tru[0, 1, 5, 12] == 0.0


class TestStatsContinuation:
    def test_lreadmean_equivalent(self, tmp_path):
        """Statistics continuation across a restart (lreadmean pathway,
        modstartup.f90:2225): [run A, checkpoint, resume, run B] must
        produce the same xytdump means as one uninterrupted run."""
        import dataclasses as dc
        import sys
        sys.path.insert(0, str(Path(__file__).parent))
        from test_core import make_cfg, make_model
        from udales_jax.run import Model
        from udales_jax.sim import Simulation
        from scipy.io import netcdf_file

        def build(outdir):
            cfg = make_cfg()
            cfg = dc.replace(cfg, run=dc.replace(cfg.run, trestart=1e9),
                             output=dc.replace(cfg.output, lxytdump=True,
                                               tsample=0.02,
                                               tstatsdump=0.16))
            m = make_model(cfg)
            return Simulation(m, outdir, monitor=False)

        d1 = tmp_path / "full"
        d1.mkdir()
        sim1 = build(d1)
        st = sim1.model.cold_start(seed=4)
        sim1.run(st, runtime=0.17)
        sim1.xytdump.close()

        d2 = tmp_path / "split"
        d2.mkdir()
        sim2 = build(d2)
        st2 = sim2.model.cold_start(seed=4)
        # phase A: ~half the window, then checkpoint with live accumulators
        stA = sim2.run(st2, runtime=0.08)
        sim2._write_restart(stA)
        ck = sorted(d2.glob("initd*.npz"))[-1]
        # phase B: fresh Simulation resumes the accumulators
        sim3 = build(d2)
        from udales_jax.io.restart import load_checkpoint
        stB = load_checkpoint(ck, sim3.model.grid, model=sim3.model)
        sim3.resume_stats(ck)
        assert float(np.asarray(sim3.xytdump.acc.n)) > 0
        sim3.run(stB, runtime=0.17 - 0.08)
        sim3.xytdump.close()

        f1 = netcdf_file(str(d1 / "xytdump.000.nc"), "r", mmap=False)
        f2 = netcdf_file(str(d2 / "xytdump.000.nc"), "r", mmap=False)
        u1 = f1.variables["uxyt"][:]
        u2 = f2.variables["uxyt"][:]
        assert u1.shape[0] >= 1 and u2.shape[0] >= 1
        np.testing.assert_allclose(u2[-1], u1[-1], rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(
            f2.variables["upwpxyt"][:][-1],
            f1.variables["upwpxyt"][:][-1], rtol=1e-5, atol=1e-9)
