"""Two-stage precursor/driver workflow on the REAL 949/950 geometries
(examples/949 geom.949.STL -> records reference-format ?driver_* files ->
examples/950 uDALES_shape.STL consumes them as its inlet BC).

The shipped cases are 256x128x128 (~18 s/step on this CPU), so the CI
variant re-preprocesses BOTH real STLs onto a 64x32x32 grid with this
framework's own IBM preprocessor and runs the identical two-stage pipeline
(moddriver.f90 drivergen:174 / writedriverfile:515 -> readdriverfile:750 ->
xmi_driver inlet, modboundary.f90:720).  Everything else (namoptions,
factypes, profiles) comes from the shipped files.
"""
import re
import shutil
from pathlib import Path

import numpy as np
import pytest

EXAMPLES = Path("/root/reference/examples")

pytestmark = pytest.mark.skipif(not EXAMPLES.exists(),
                                reason="reference absent")

IT, JT, KT = 64, 32, 32


def _regrid_profile(src, dst, kt, zsize):
    """Interpolate a z-profile table (2 header lines) onto kt uniform
    cells."""
    with open(src) as f:
        hdr = [f.readline(), f.readline()]
    tab = np.loadtxt(src, skiprows=2, ndmin=2)
    zc = (np.arange(kt) + 0.5) * (zsize / kt)
    out = np.column_stack(
        [zc] + [np.interp(zc, tab[:, 0], tab[:, c])
                for c in range(1, tab.shape[1])])
    with open(dst, "w") as f:
        f.writelines(hdr)
        np.savetxt(f, out, fmt="%14.6e")


def _patch_namoptions(text, domain, counts, extra):
    """Rewrite key=value lines (Fortran namelist style)."""
    vals = {"itot": IT, "jtot": JT, "ktot": KT,
            "nprocx": 1, "nprocy": 1}
    vals.update(domain)
    vals.update(counts)
    vals.update(extra)
    for key, val in vals.items():
        pat = re.compile(rf"^({key}\s*=\s*)\S+", re.M)
        if pat.search(text):
            text = pat.sub(rf"\g<1>{val}", text)
        else:
            text = text.replace("&RUN", f"&RUN\n{key}      = {val}", 1)
    return text


def _stage_mini(case: str, stl: str, tmp: Path, extra: dict) -> Path:
    from udales_jax.grid import Grid
    from udales_jax.prep.ibmprep import IBMPreproc
    src = EXAMPLES / case
    dst = tmp / case
    dst.mkdir()
    nam = (src / f"namoptions.{case}").read_text()
    zsize = float(re.search(r"zsize\s*=\s*([\d.]+)", nam).group(1))
    xlen = float(re.search(r"xlen\s*=\s*([\d.]+)", nam).group(1))
    ylen = float(re.search(r"ylen\s*=\s*([\d.]+)", nam).group(1))
    for f in ("factypes.inp", "prof.inp", "lscale.inp"):
        p = src / f"{f}.{case}"
        if f.startswith("prof") or f.startswith("lscale"):
            _regrid_profile(p, dst / f"{f}.{case}", KT, zsize)
        elif p.exists():
            shutil.copy(p, dst / p.name)
    grid = Grid.uniform(IT, JT, KT, xlen, ylen, zsize, dtype=np.float64)
    pp = IBMPreproc.from_stl(src / stl, grid)
    counts = pp.run(dst, case)
    (dst / f"namoptions.{case}").write_text(
        _patch_namoptions(nam, {}, counts, extra))
    return dst


@pytest.fixture(scope="module")
def driver_pair_dirs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("driver_pair")
    c949 = _stage_mini("949", "geom.949.STL", tmp, {
        "runtime": "6.5", "tdriverstart": "0.5", "dtdriver": "0.5",
        "driverstore": "0", "iplane": str(IT), "tstatsdump": "1000.",
    })
    c950 = _stage_mini("950", "uDALES_shape.STL", tmp, {
        "runtime": "3.0", "driverstore": "0", "tstatsdump": "1000.",
        "lfielddump": ".false.", "ltdump": ".false.",
    })
    return c949, c950


class TestDriverPair:
    def test_record_then_replay(self, driver_pair_dirs):
        import jax
        from udales_jax.io.driverfiles import read_driver_files
        from udales_jax.run import load_case
        from udales_jax.sim import Simulation
        c949, c950 = driver_pair_dirs

        # --- stage 1: precursor records reference-format driver files ----
        model = load_case(c949, dtype="float64")
        sim = Simulation(model, c949)
        sim.run(runtime=6.5)
        assert (c949 / "tdriver_000.949").exists()
        assert (c949 / "udriver_000.949").exists()
        d = read_driver_files(c949, 949, JT, KT)
        assert len(d["t"]) >= 5
        assert np.isfinite(d["u"]).all() and np.isfinite(d["w"]).all()
        assert 0.2 < np.abs(d["u"]).max() < 10.0
        assert (np.diff(d["t"]) > 0).all()

        # --- stage 2: main run consumes them as driver inlet -------------
        for p in c949.glob("?driver_*.949"):
            shutil.copy(p, c950 / p.name)
        model2 = load_case(c950, dtype="float64")
        from udales_jax.ops import openbc
        assert model2.inlet is not None
        assert model2.inlet.mode == openbc.BC_DRIVER
        state = model2.cold_start()
        step = jax.jit(model2.step)
        for _ in range(4):
            state = step(state)
        c = state.c
        for name in ("u", "v", "w", "e12"):
            assert np.isfinite(np.asarray(getattr(c, name))).all(), name
        # the inlet face must track the time-interpolated driver plane
        planes = model2.inlet.planes(float(state.timee), JT, KT)
        got = np.asarray(c.u[0])
        want = np.asarray(planes["u"])
        mask = np.abs(want) > 1e-8
        assert mask.sum() > 0.5 * mask.size
        err = np.abs(got - want)[mask].max()
        assert err < 1e-6, err

        # --- stage 2b: chunked streaming replay (lchunkread) must track
        # the full-in-memory replay bit-for-bit across window refills ----
        nam = (c950 / "namoptions.950").read_text()
        nam = nam.replace(
            "&DRIVER",
            "&DRIVER\nlchunkread = .true.\nchunkread_size = 4", 1)
        (c950 / "namoptions.950").write_text(nam)
        model3 = load_case(c950, dtype="float64")
        assert model3.driver_stream is not None
        assert model3.driver_stream.chunk == 4
        state_c = model3.cold_start()
        state_f = model2.cold_start()
        step3 = jax.jit(model3.step)
        step2 = jax.jit(model2.step)
        refills = {model3.driver_stream.n0}
        for _ in range(8):
            state_c = model3.driver_stream.ensure(state_c)
            refills.add(model3.driver_stream.n0)
            state_c = step3(state_c)
            state_f = step2(state_f)
        assert len(refills) >= 2   # the run crossed at least one window
        np.testing.assert_array_equal(np.asarray(state_c.c.u),
                                      np.asarray(state_f.c.u))
        np.testing.assert_array_equal(np.asarray(state_c.c.thl),
                                      np.asarray(state_f.c.thl))
