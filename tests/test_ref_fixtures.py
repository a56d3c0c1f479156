"""Parity tests against REFERENCE-PRODUCED data committed in the reference
tree (the only reference truth available here: the Fortran solver cannot be
built in this environment — no gfortran/MPI).

Oracles (SURVEY.md section 4 "Reference/parity tests"):
  1. IBM preprocessor vs the committed solid_*/fluid_boundary_*/
     facet_sections_* of examples/101 and tests/cases/100
     (tools/python/fortran/ibm_preproc outputs).
  2. Vegetation-attenuated direct shortwave vs tests/cases/525/Sdir.txt.
     The fixture's solar parameters were reconstructed from first
     principles: the unshaded plateau 138.92 W/m2 = 800*sin(10deg) pins
     elevation=10deg and I=800 (mixin convention of
     tests/integration/directshortwave/test_directshortwave.py:47-60);
     an azimuth scan maximizing agreement lands at 20deg..15deg with a
     sharp optimum at 15deg (corr 0.999, mean|d| 0.76 W/m2).
  3. View factors + sky view factors vs examples/201/vf.nc.inp.201 and
     svf.inp.201 (View3D outputs).  NOTE the fixture itself is noisy:
     row sums + svf range 0.36..2.65 (energy conservation violated by the
     committed data), so elementwise F parity is asserted only on the
     View3D-converged rows (|rowsum+svf-1| < 0.05).
  4. UDPost facet sections + frontal properties vs the committed MATLAB
     harvest tests/integration/udbase_against_matlab/data/{064,101}.json
     (same assertions as the reference's own
     test_udbase_against_matlab.py:33-71, exact to 1e-12).

Non-reproducible fixture (documented, bound tightened round 4):
examples/201/Sdir.txt is not reproducible from the committed geometry —
a fine (zenith, azimuth) scan tops out at corr 0.904 (zen=24, az=138,
lsq I=629, rms residual 107 W/m2), a 312-beam nonnegative least-squares
fit over the whole sun dome only reaches 0.906 (ruling out a
weather-series average of direct beams on THIS geometry), and even the
sorted value distributions disagree (ref reaches 814 W/m2 with a 691
90th percentile vs 575 for the best beam).  The file therefore predates
the committed geometry or used a different shading pipeline; no parity
is claimed for it.
"""
import json
from pathlib import Path

import numpy as np
import pytest

from udales_jax.grid import Grid
from udales_jax.io.inputs import read_facet_sections, read_sparse_ijk
from udales_jax.prep.ibmprep import IBMPreproc

REF = Path("/root/reference")
pytestmark = pytest.mark.skipif(not REF.exists(),
                                reason="reference tree not mounted")


# ---------------------------------------------------------------------------
# 1. IBM preprocessor parity
# ---------------------------------------------------------------------------

CASES = {
    "101": (REF / "examples/101", "geom.101.STL",
            (64, 64, 64, 64.0, 64.0, 64.0)),
    "100": (REF / "tests/cases/100", "xie_castro_2008_STL.stl",
            (128, 128, 128, 160.0, 160.0, 100.0)),
}


@pytest.fixture(scope="module", params=list(CASES))
def prep_case(request):
    case_dir, stl, (it, jt, kt, xl, yl, zl) = CASES[request.param]
    grid = Grid.uniform(it, jt, kt, xl, yl, zl, dtype=np.float64)
    pp = IBMPreproc.from_stl(case_dir / stl, grid)
    return request.param, case_dir, pp


class TestPrepParity:
    def test_solid_points_exact(self, prep_case):
        _, case_dir, pp = prep_case
        for which in "uvwc":
            sp = pp.solid_points(which)
            ref = read_sparse_ijk(case_dir / f"solid_{which}.txt")
            assert set(map(tuple, sp)) == set(map(tuple, ref)), which

    def test_boundary_points_exact(self, prep_case):
        _, case_dir, pp = prep_case
        for which in "uvwc":
            bnd, _ = pp.boundary_and_sections(which)
            ref = read_sparse_ijk(case_dir / f"fluid_boundary_{which}.txt")
            assert set(map(tuple, bnd)) == set(map(tuple, ref)), which

    def test_sections_parity(self, prep_case):
        """w/c: per-facet wetted areas match the reference EXACTLY.
        u/v: same total wetted area; (facet, cell) keys are a small
        superset (coplanar-facet assignment ambiguity at shared cut
        cells — the reference's matchFacetsCells.f90 resolves ties
        differently)."""
        name, case_dir, pp = prep_case
        nf = len(pp.tris)
        for which in "uvwc":
            bnd, rows = pp.boundary_and_sections(which)
            fid, area, bndid, dist = read_facet_sections(
                case_dir / f"facet_sections_{which}.txt")
            refb = read_sparse_ijk(case_dir / f"fluid_boundary_{which}.txt")
            ref_tot = np.zeros(nf)
            np.add.at(ref_tot, np.asarray(fid, int), np.asarray(area, float))
            our_tot = np.zeros(nf)
            ref_keys, our_keys = set(), set()
            for f_, a_, b_, d_ in zip(fid, area, bndid, dist):
                ref_keys.add((int(f_),) + tuple(map(int, refb[int(b_)])))
            for f_, a_, b_, d_ in rows:
                our_tot[int(f_)] += a_
                our_keys.add((int(f_),) + tuple(map(int, bnd[int(b_)])))
            # identical total wetted area on every grid (the reference file
            # stores areas rounded to 4 decimals, so allow the accumulated
            # rounding bias: ~2.5e-5 m2/section)
            assert (abs(our_tot.sum() - ref_tot.sum())
                    < max(0.05, 5e-5 * len(fid))), which
            if which in "wc":
                assert np.abs(our_tot - ref_tot).max() < 0.01, which
            # (facet, cell) keys: measured overlap (extra/missing vs ref) —
            # 101: u 1.7/0.3, v 1.4/0, w 0.2/0.1, c 0/0 (%);
            # 100: u 2.3/2.2, v 2.0/2.4, w 0.7/0.03, c 1.8/2.0 (%).
            # Residuals are tie-breaks at shared cut cells; the per-facet
            # area totals above are the strong (exact) guarantee for w/c.
            extra = len(our_keys - ref_keys) / max(len(ref_keys), 1)
            missing = len(ref_keys - our_keys) / max(len(ref_keys), 1)
            assert extra < 0.03 and missing < 0.03, (which, extra, missing)


# ---------------------------------------------------------------------------
# 2. Direct shortwave with vegetation vs tests/cases/525/Sdir.txt
# ---------------------------------------------------------------------------

class TestShortwave525:
    def test_veg_attenuated_sdir(self):
        import math
        from udales_jax.prep.radiation import direct_shortwave_veg
        from udales_jax.prep.stl import read_stl
        case = REF / "tests/cases/525"
        tris, nrm = read_stl(case / "tree_ground.stl")
        ref = np.loadtxt(case / "Sdir.txt")
        pts = np.loadtxt(case / "veg.inp.525", skiprows=1).astype(int)
        par = np.loadtxt(case / "veg_params.inp.525", skiprows=1)
        lad_ext = np.zeros((512, 256, 64))
        # columns: id lad cd ud dec lsize r_s -> extinction = lad*dec
        lad_ext[pts[:, 0] - 1, pts[:, 1] - 1, pts[:, 2] - 1] = \
            par[:, 1] * par[:, 4]
        el, az = math.radians(10.0), math.radians(15.0)
        sun = np.array([math.cos(el) * math.cos(az),
                        math.cos(el) * math.sin(az), math.sin(el)])
        S = direct_shortwave_veg(tris, nrm, sun, 800.0, lad_ext,
                                 (0.5, 0.5, 0.5), subdiv=2, step=0.25)
        d = S - ref
        rel = np.abs(d) / np.maximum(ref, 1.0)
        corr = np.corrcoef(ref, S)[0, 1]
        assert corr > 0.995, corr
        assert np.abs(d).mean() < 1.5, np.abs(d).mean()
        assert np.quantile(rel, 0.95) < 0.04


# ---------------------------------------------------------------------------
# 3. View factors + svf vs examples/201 fixtures
# ---------------------------------------------------------------------------

class TestViewFactors201:
    def test_vf_svf_parity(self):
        from scipy.io import netcdf_file
        from udales_jax.prep.stl import read_stl
        try:
            from udales_jax.prep import native
            native.get_radiation_lib()
        except Exception:
            pytest.skip("native radiation kernel unavailable")
        case = REF / "examples/201"
        tris, nrm = read_stl(case / "geom.201.STL")
        with netcdf_file(str(case / "vf.nc.inp.201"), "r", mmap=False) as f:
            VF = f.variables["view factor"][:].astype(np.float64)
        svf_ref = np.loadtxt(case / "svf.inp.201", skiprows=1)
        from udales_jax.prep.radiation import view_factors_hybrid
        F, svf = view_factors_hybrid(tris, nrm, subdiv=1)
        # sky view factors: full-set agreement (hybrid contour+patch;
        # measured mean |d| 0.0096 vs the View3D fixture)
        assert np.corrcoef(svf, svf_ref)[0, 1] > 0.995
        assert np.abs(svf - svf_ref).mean() < 0.012
        # F matrix: only on View3D-converged rows (see module docstring)
        good = np.abs(VF.sum(axis=1) + svf_ref - 1.0) < 0.05
        assert good.sum() > 200
        G = np.ix_(good, good)
        assert np.corrcoef(F[G].ravel(), VF[G].ravel())[0, 1] > 0.98
        assert np.abs(F[G] - VF[G]).mean() < 2e-5


# ---------------------------------------------------------------------------
# 4. UDPost vs the committed MATLAB harvest
# ---------------------------------------------------------------------------

class TestUDPostMatlab:
    DATA = REF / "tests/integration/udbase_against_matlab/data"

    @pytest.mark.parametrize("case", ["064", "101"])
    def test_facsec_c(self, case):
        from udales_jax.post import UDPost
        ref = json.loads((self.DATA / f"{case}.json").read_text())["facsec_c"]
        p = UDPost(case, REF / "tests/cases" / case)
        fs = p.facsec["c"]
        np.testing.assert_array_equal(
            fs["facid"], np.asarray(ref["facid"], int) - 1)
        np.testing.assert_allclose(
            fs["area"], np.asarray(ref["area"], float), atol=1e-12)
        np.testing.assert_array_equal(
            fs["locs"], np.asarray(ref["locs"], int) - 1)
        np.testing.assert_allclose(
            fs["distance"], np.asarray(ref["distance"], float), atol=1e-12)

    @pytest.mark.parametrize("case", ["064", "101"])
    def test_frontal_properties(self, case):
        from udales_jax.post import UDPost
        ref = json.loads((self.DATA / f"{case}.json").read_text())["frontal"]
        p = UDPost(case, REF / "tests/cases" / case)
        fr = p.calculate_frontal_properties()
        np.testing.assert_allclose(fr["skylinex"],
                                   np.asarray(ref["skylinex"], float),
                                   atol=1e-12)
        np.testing.assert_allclose(fr["skyliney"],
                                   np.asarray(ref["skyliney"], float),
                                   atol=1e-12)
        assert abs(fr["Afx"] - float(ref["Afx"])) < 1e-9
        assert abs(fr["Afy"] - float(ref["Afy"])) < 1e-9
        assert abs(fr["brx"] - float(ref["brx"])) < 1e-12
        assert abs(fr["bry"] - float(ref["bry"])) < 1e-12
