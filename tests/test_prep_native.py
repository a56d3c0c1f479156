"""Native (C++) preprocessing kernels vs the numpy reference semantics."""
import shutil

import numpy as np
import pytest

from udales_jax.grid import Grid
from udales_jax.prep.ibmprep import IBMPreproc
from udales_jax.prep.prep import make_box_stl

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++")


@pytest.fixture(scope="module")
def stl(tmp_path_factory):
    p = tmp_path_factory.mktemp("stl") / "box.stl"
    make_box_stl(p, 6, 10, 6, 10, 4, 16.0, 16.0)
    return p


def test_native_builds():
    from udales_jax.prep.native import get_lib
    assert get_lib() is not None


def test_masks_match(stl):
    grid = Grid.uniform(16, 16, 16, 16.0, 16.0, 16.0, dtype=np.float64)
    a = IBMPreproc.from_stl(stl, grid, use_native=False)
    b = IBMPreproc.from_stl(stl, grid, use_native=True)
    for which in "uvwc":
        ma = a.solid_mask(which)
        mb = b.solid_mask(which)
        assert (ma == mb).all(), which


def test_sections_match(stl):
    grid = Grid.uniform(16, 16, 16, 16.0, 16.0, 16.0, dtype=np.float64)
    a = IBMPreproc.from_stl(stl, grid, use_native=False)
    b = IBMPreproc.from_stl(stl, grid, use_native=True)
    for which in "uvwc":
        bnd_a, rows_a = a.boundary_and_sections(which)
        bnd_b, rows_b = b.boundary_and_sections(which)
        np.testing.assert_array_equal(bnd_a, bnd_b)
        pack = lambda bnd, rows: sorted(
            (f, tuple(bnd[bi]), round(ar, 9), round(d, 9))
            for f, ar, bi, d in rows)
        assert pack(bnd_a, rows_a) == pack(bnd_b, rows_b), which


def test_native_speed(stl):
    """Native path must not be slower than numpy on the box case."""
    import time
    grid = Grid.uniform(32, 32, 32, 16.0, 16.0, 16.0, dtype=np.float64)
    b = IBMPreproc.from_stl(stl, grid, use_native=True)
    t0 = time.time()
    for which in "uvwc":
        b.boundary_and_sections(which)
    t_native = time.time() - t0
    a = IBMPreproc.from_stl(stl, grid, use_native=False)
    t0 = time.time()
    for which in "uvwc":
        a.boundary_and_sections(which)
    t_numpy = time.time() - t0
    assert t_native < t_numpy, (t_native, t_numpy)


class TestNativeRadiation:
    """native/radiation.cpp vs prep/radiation.py — identical contracts."""

    @pytest.fixture(scope="class")
    def geom(self, stl):
        from udales_jax.prep.stl import read_stl
        return read_stl(stl)

    def test_view_factors_match(self, geom):
        from udales_jax.prep import native, radiation
        tris, normals = geom
        Fn, svfn = native.view_factors(tris, normals, subdiv=1)
        Fp, svfp = radiation.view_factors(tris, normals, subdiv=1)
        assert np.abs(Fn - Fp).max() < 1e-10
        assert np.abs(svfn - svfp).max() < 1e-10
        # enclosure property: rows sum to <= 1, svf complements
        assert (Fn.sum(axis=1) <= 1.0 + 1e-12).all()

    def test_view_factors_no_occlusion(self, geom):
        from udales_jax.prep import native, radiation
        tris, normals = geom
        Fn, _ = native.view_factors(tris, normals, subdiv=1,
                                    occlusion=False)
        Fp, _ = radiation.view_factors(tris, normals, subdiv=1,
                                       occlusion=False)
        assert np.abs(Fn - Fp).max() < 1e-10

    def test_direct_shortwave_match(self, geom):
        from udales_jax.prep import native, radiation
        tris, normals = geom
        sun = radiation.solar_direction(35.0, 160.0)
        Sn = native.direct_shortwave(tris, normals, sun, 800.0)
        Sp = radiation.direct_shortwave(tris, normals, sun, 800.0)
        assert np.abs(Sn - Sp).max() < 1e-8
        assert (Sn >= 0).all() and Sn.max() <= 800.0 + 1e-9
