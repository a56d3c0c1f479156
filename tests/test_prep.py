"""Preprocessing tests: STL parsing, masking parity vs reference example 001
(downscaled for speed), view-factor physics, shortwave shading, and a full
prep -> solve round trip."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from udales_jax.grid import Grid
from udales_jax.prep.stl import read_stl, write_stl, triangle_areas
from udales_jax.prep.ibmprep import IBMPreproc
from udales_jax.prep.radiation import (direct_shortwave, solar_direction,
                                       view_factors)
from udales_jax.prep.prep import PrepConfig, make_box_stl, prepare_case

REF001 = Path("/root/reference/examples/001")


class TestSTL:
    def test_roundtrip(self, tmp_path):
        tris = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                         [[0, 0, 1], [1, 0, 1], [1, 1, 1]]], float)
        write_stl(tmp_path / "t.stl", tris)
        t2, n2 = read_stl(tmp_path / "t.stl")
        np.testing.assert_allclose(t2, tris, atol=1e-6)
        np.testing.assert_allclose(n2[0], [0, 0, 1], atol=1e-6)

    @pytest.mark.skipif(not REF001.exists(), reason="reference absent")
    def test_reads_matlab_stl(self):
        tris, normals = read_stl(REF001 / "flat_ground.stl")
        assert len(tris) == 128
        np.testing.assert_allclose(np.abs(normals[:, 2]), 1.0)


class TestMasking:
    def test_box_building(self):
        """One 4x4x4-cell cube on a 16^3 grid: counts derivable by hand."""
        grid = Grid.uniform(16, 16, 16, 16.0, 16.0, 16.0, dtype=np.float64)
        tris = make_box_stl("/tmp/_box.stl", 6, 10, 6, 10, 4, 16.0, 16.0)
        pp = IBMPreproc.from_stl("/tmp/_box.stl", grid)
        # c solid: strictly inside the cube: 4x4 cells x 4 levels
        assert len(pp.solid_points("c")) == 4 * 4 * 4
        # u solid: faces x=6..10 inclusive -> 5 x-planes x 4 y x 4 z
        assert len(pp.solid_points("u")) == 5 * 4 * 4
        # w solid: 4x4 columns x faces 0..4 (floor + cube internal + roof)
        # plus the rest of the floor
        sw = pp.solid_points("w")
        assert (sw[:, 2] == 0).sum() == 16 * 16      # whole floor
        assert len(sw) == 16 * 16 + 4 * 4 * 4        # + cube faces 1..4

    @pytest.mark.skipif(not REF001.exists(), reason="reference absent")
    def test_001_parity_subset(self):
        """Full-resolution parity for solid_w on example 001."""
        from udales_jax.io.inputs import read_sparse_ijk
        grid = Grid.uniform(128, 128, 128, 64.0, 64.0, 64.0,
                            dtype=np.float64)
        pp = IBMPreproc.from_stl(REF001 / "flat_ground.stl", grid)
        sp = pp.solid_points("w")
        ref = read_sparse_ijk(REF001 / "solid_w.txt")
        assert set(map(tuple, sp)) == set(map(tuple, ref))


class TestViewFactors:
    def test_parallel_plates(self):
        """Two directly-facing unit squares at distance d: F must approach
        the analytic parallel-plate value and satisfy reciprocity."""
        sq1 = np.array([[[0, 0, 0], [1, 0, 0], [1, 1, 0]],
                        [[0, 0, 0], [1, 1, 0], [0, 1, 0]]], float)
        d = 1.0
        sq2 = sq1.copy()
        sq2[:, :, 2] = d
        sq2 = sq2[:, ::-1]  # flip winding so the normal points down
        tris = np.concatenate([sq1, sq2])
        normals = np.array([[0, 0, 1], [0, 0, 1], [0, 0, -1], [0, 0, -1]],
                           float)
        F, svf = view_factors(tris, normals, subdiv=3)
        # analytic F for unit squares at d=1: 0.199825 (Howell C-11);
        # subdiv=3 quadrature lands at 0.20046 — assert within 0.5%
        F12 = F[0, 2] + F[0, 3]
        assert abs(F12 - 0.199825) < 1e-3, F12
        # reciprocity: A_i F_ij = A_j F_ji (equal areas here)
        np.testing.assert_allclose(F[0, 2], F[2, 0], rtol=1e-6)
        # the analytic contour method must hit the value to quadrature
        # precision (<1e-6), including the quad-average of the
        # shared-edge perpendicular case (Howell C-14: 0.20004)
        from udales_jax.prep.radiation import view_factors_exact
        Fe, _ = view_factors_exact(tris, normals, occlusion=False)
        assert abs(Fe[0, 2] + Fe[0, 3] - 0.199825) < 1e-5
        sq3 = np.array([[[0, 0, 0], [1, 0, 0], [1, 0, 1]],
                        [[0, 0, 0], [1, 0, 1], [0, 0, 1]]], float)
        n3 = np.array([[0, 1, 0], [0, 1, 0]], float)
        tp = np.concatenate([sq1, sq3])
        npn = np.concatenate([normals[:2], n3])
        Fp, _ = view_factors_exact(tp, npn, occlusion=False)
        a = np.array([0.5, 0.5])
        quad_F = (a @ (Fp[:2, 2:] @ np.ones(2))) / 1.0
        assert abs(quad_F - 0.20004) < 1e-4, quad_F
        assert 0.4 < svf[0] < 0.9

    def test_enclosure_bound(self):
        tris = make_box_stl("/tmp/_box2.stl", 2, 6, 2, 6, 4, 8.0, 8.0)
        from udales_jax.prep.stl import read_stl
        t, n = read_stl("/tmp/_box2.stl")
        F, svf = view_factors(t, n, subdiv=1)
        assert (F.sum(axis=1) + svf <= 1.0 + 1e-9).all()
        assert (F >= 0).all()


class TestShortwave:
    def test_shading(self):
        """A wall shades the ground behind it for a low sun."""
        # ground strip + tall wall at x=2 facing -x
        ground = np.array([[[0, 0, 0], [4, 0, 0], [4, 1, 0]],
                           [[0, 0, 0], [4, 1, 0], [0, 1, 0]]], float)
        wall = np.array([[[2, 0, 0], [2, 0, 3], [2, 1, 3]],
                         [[2, 0, 0], [2, 1, 3], [2, 1, 0]]], float)
        tris = np.concatenate([ground, wall])
        normals = np.array([[0, 0, 1], [0, 0, 1], [-1, 0, 0], [-1, 0, 0]],
                           float)
        # sun low in the +x direction (azimuth east=90), zenith 70 deg
        sun = solar_direction(70.0, 90.0)
        S = direct_shortwave(tris, normals, sun, 1000.0, subdiv=3)
        # the wall's -x face looks away from the sun: dark
        assert S[2] < 1.0
        # strips: ground east of the wall is lit, west is in its shadow
        g_lit = np.array([[[3, 0, 0], [4, 0, 0], [4, 1, 0]]], float)
        g_shade = np.array([[[0, 0, 0], [1, 0, 0], [1, 1, 0]]], float)
        tris2 = np.concatenate([g_shade, g_lit, wall])
        n2 = np.array([[0, 0, 1], [0, 0, 1], [-1, 0, 0], [-1, 0, 0]], float)
        S2 = direct_shortwave(tris2, n2, sun, 1000.0, subdiv=3)
        assert S2[1] > 0.9 * 1000.0 * np.cos(np.radians(70.0))
        assert S2[0] < 0.2 * S2[1]   # shadow side


class TestRoundTrip:
    def test_prep_then_solve(self, tmp_path):
        """Full pipeline: generate a case from an STL, load it, run 2 steps
        on the solver — the complete reference workflow in one test."""
        import jax
        stl = tmp_path / "geom.stl"
        make_box_stl(stl, 6, 10, 6, 10, 4, 16.0, 16.0)
        cfg = PrepConfig(itot=16, jtot=16, ktot=16, xlen=16.0, ylen=16.0,
                         zsize=16.0, expnr="901", u0=1.0, dpdx=1e-4,
                         with_radiation=True, vf_subdiv=1)
        counts = prepare_case(stl, tmp_path, cfg)
        assert counts["nfcts"] == 18  # 8 floor + 2 roof + 8 wall triangles
        assert counts["nsolpts_c"] == 64
        # write a namoptions for the solver
        nam = tmp_path / "namoptions.901"
        walls = "\n".join(
            [f"nfcts = {counts['nfcts']}"]
            + [f"nsolpts_{w} = {counts[f'nsolpts_{w}']}" for w in "uvwc"]
            + [f"nbndpts_{w} = {counts[f'nbndpts_{w}']}" for w in "uvwc"]
            + [f"nfctsecs_{w} = {counts[f'nfctsecs_{w}']}" for w in "uvwc"])
        nam.write_text(f"""
&RUN
iexpnr = 901
runtime = 1.
ladaptive = .true.
dtmax = 0.1
/
&DOMAIN
itot = 16
jtot = 16
ktot = 16
xlen = 16.
ylen = 16.
/
&PHYSICS
ltempeq = .true.
lbuoyancy = .true.
/
&WALLS
{walls}
iwalltemp = 2
/
&BC
thls = 290.
z0 = 0.05
z0h = 0.00035
/
""")
        from udales_jax.run import load_case
        model = load_case(tmp_path, "901", dtype="float64")
        assert model.ibm is not None
        state = model.cold_start(seed=1)
        step = jax.jit(model.step)
        for _ in range(2):
            state = step(state)
        u = np.asarray(state.c.u)
        assert np.isfinite(u).all()
        # solid u inside the building stays ~0
        assert np.abs(u[7:9, 7:9, 1]).max() < 0.1
        assert np.abs(u).max() < 5.0


class TestPrepPipelineExtras:
    def test_solar_datetime_and_trees(self, tmp_path):
        """prepare_case with a date/site solar state and a trees.inp file
        produces netsw from the computed sun and the sparse veg set."""
        stl = tmp_path / "geom.stl"
        make_box_stl(stl, 6, 10, 6, 10, 4, 16.0, 16.0)
        trees = tmp_path / "trees.inp.902"
        trees.write_text("# trees\n 2 4 2 4 1 3\n")
        cfg = PrepConfig(itot=16, jtot=16, ktot=16, xlen=16.0, ylen=16.0,
                         zsize=16.0, expnr="902", with_radiation=True,
                         vf_subdiv=1,
                         solar_datetime="2011-06-21T12:00",
                         latitude=51.5, longitude=0.0,
                         trees_file=str(trees))
        counts = prepare_case(stl, tmp_path, cfg)
        assert counts["ntrees"] == 3 * 3 * 3
        nsw = np.loadtxt(tmp_path / "netsw.inp.902", skiprows=1)
        assert len(nsw) == counts["nfcts"]
        # June noon at 51.5N: strong sun, roof well lit
        assert nsw.max() > 300.0
        veg = np.loadtxt(tmp_path / "veg.inp.902", skiprows=1)
        assert len(veg) == 27
