"""Vegetation preprocessing tests.

Parity oracle: expanding the committed trees.inp.525 block must reproduce
the committed veg.inp.525 point list EXACTLY (the reference generated the
latter from the former via udprep_vegetation.load_block).
"""
from pathlib import Path

import numpy as np
import pytest

from udales_jax.prep.vegetation import (VegParams, compute_sveg, stl_to_veg,
                                        trees_to_veg, write_veg_files)

REF525 = Path("/root/reference/tests/cases/525")


@pytest.mark.skipif(not REF525.exists(), reason="reference absent")
class TestTreesBlockParity:
    def test_committed_525_expansion_exact(self):
        pts, ids = trees_to_veg(REF525 / "trees.inp.525", 512, 256, 64)
        ref = np.loadtxt(REF525 / "veg.inp.525", skiprows=1).astype(int)
        assert len(pts) == len(ref) == 26325
        assert set(map(tuple, pts)) == set(map(tuple, ref))
        par = np.loadtxt(REF525 / "veg_params.inp.525", skiprows=1)
        # committed params: lad=1.0 cd=0.3 ud=2e-4 dec=0.3 lsize=0.15 r_s=50
        np.testing.assert_allclose(par[0, 1:],
                                   [1.0, 0.3, 2e-4, 0.3, 0.15, 50.0])

    def test_write_roundtrip(self, tmp_path):
        pts, ids = trees_to_veg(REF525 / "trees.inp.525", 512, 256, 64)
        n = write_veg_files(tmp_path, "525", pts, ids, VegParams())
        assert n == 26325
        from udales_jax.io.inputs import read_sparse_ijk
        back = read_sparse_ijk(tmp_path / "veg.inp.525")
        assert set(map(tuple, back + 1)) == set(map(tuple, pts))
        par = np.loadtxt(tmp_path / "veg_params.inp.525", skiprows=1)
        np.testing.assert_allclose(par[0, 1:],
                                   [1.0, 0.3, 2e-4, 0.3, 0.15, 50.0])


class TestSTLVoxelize:
    def test_box_crown(self, tmp_path):
        from udales_jax.grid import Grid
        from udales_jax.prep.prep import make_box_stl
        stl = tmp_path / "crown.stl"
        # closed box 4..8 x 4..8 x 0..4 (floor=False keeps it one solid;
        # bottom open -> extrude closes it)
        make_box_stl(stl, 4, 8, 4, 8, 4, 16.0, 16.0, floor=False)
        grid = Grid.uniform(16, 16, 16, 16.0, 16.0, 16.0,
                            dtype=np.float64)
        pts, ids = stl_to_veg(stl, grid)
        assert len(pts) == 4 * 4 * 4
        assert pts[:, 0].min() == 5 and pts[:, 0].max() == 8
        assert pts[:, 2].max() == 4


class TestSveg:
    def test_attenuation_monotone(self):
        """Cells deeper in the canopy absorb less (Beer-Lambert)."""
        import math
        ni = nj = 8
        nk = 10
        lad = np.zeros((ni, nj, nk))
        lad[4, 4, 2:9] = 0.5     # one column of canopy
        pts = np.array([[5, 5, k] for k in range(3, 10)])   # 1-based
        sun = np.array([0.0, 0.0, 1.0])                     # overhead
        sveg = compute_sveg(pts, lad, (1.0, 1.0, 1.0), sun, 800.0,
                            step=0.1)
        assert (np.diff(sveg) > 0).all()       # higher cells absorb more
        # top canopy cell: tau ~ 0.5*0.5 above centre -> I*k*exp(-0.25)
        assert abs(sveg[-1] - 800.0 * 0.5 * np.exp(-0.25)) < 25.0
