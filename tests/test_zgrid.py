"""Stretched vertical grid generation (udprep GridSection equivalent,
tools/python/udprep/udprep_grid.py:61-290)."""
import numpy as np
import pytest

from udales_jax.prep.zgrid import zgrid_centers, zgrid_faces


def _check_basic(zh, ktot, zsize, hlin, dzlin):
    assert zh.shape == (ktot + 1,)
    assert zh[0] == 0.0
    assert zh[-1] == pytest.approx(zsize, rel=1e-12)
    dz = np.diff(zh)
    assert (dz > 0).all()
    # linear prefix at dzlin spacing
    il = int(round(hlin / dzlin))
    np.testing.assert_allclose(dz[:il], dzlin, rtol=1e-9)
    return dz


def test_uniform():
    zh = zgrid_faces(16, 32.0)
    np.testing.assert_allclose(np.diff(zh), 2.0)


@pytest.mark.parametrize("method", ["exp", "tanh", "2tanh"])
def test_stretch_methods(method):
    ktot, zsize, hlin, dzlin = 64, 400.0, 40.0, 1.0
    # exp/tanh deliberately coarsen hard toward the lid and the advisory
    # warning is part of the contract (udprep_grid.py warns the same
    # way) — assert it instead of letting it leak into the summary;
    # 2tanh refines again at the lid, so its final spacing stays small
    import contextlib
    expect = (pytest.warns(RuntimeWarning, match="final grid spacing")
              if method != "2tanh" else contextlib.nullcontext())
    with expect:
        zh = zgrid_faces(ktot, zsize, lzstretch=True, method=method,
                         hlin=hlin, dzlin=dzlin, stretchconst=3.0)
    dz = _check_basic(zh, ktot, zsize, hlin, dzlin)
    il = int(round(hlin / dzlin))
    # first stretched spacing at least the linear one (the fit criterion,
    # udprep_grid.py:190-196), and spacing grows toward the top
    assert dz[il] >= dzlin - 1e-9
    # exp/tanh coarsen monotonically to the top; 2tanh is symmetric
    # (coarse mid-column, refined again at the lid)
    assert dz.max() > 2.0 * dzlin
    if method != "2tanh":
        assert dz[-1] > 2.0 * dzlin


def test_expcheck_alpha_identity():
    """expcheck: the fitted alpha satisfies alpha/(exp(alpha)-1) =
    dzlin*ir/L, and the first stretched spacing is C1-matched (== dzlin to
    first order)."""
    ktot, zsize, hlin, dzlin = 48, 300.0, 24.0, 1.0
    with pytest.warns(RuntimeWarning, match="stretch factor outside"):
        zh = zgrid_faces(ktot, zsize, lzstretch=True, method="expcheck",
                         hlin=hlin, dzlin=dzlin)
    dz = _check_basic(zh, ktot, zsize, hlin, dzlin)
    il = int(round(hlin / dzlin))
    # smooth transition: spacing ratio near 1 at the junction
    assert dz[il] / dz[il - 1] == pytest.approx(1.0, abs=0.1)
    ratios = dz[il + 1:] / dz[il:-1]
    np.testing.assert_allclose(ratios, ratios[0], rtol=1e-9)  # geometric


def test_too_shallow_raises():
    with pytest.raises(ValueError):
        # stretched region shorter than ir linear spacings -> unfittable
        zgrid_faces(26, 20.0, lzstretch=True, method="tanh", hlin=16.0,
                    dzlin=1.0, stretchconst=1.5)


def test_prepare_case_stretched(tmp_path):
    """prepare_case writes a stretched prof.inp whose z column matches the
    generator, and the case loads through from_prof_inp."""
    from udales_jax.grid import Grid
    from udales_jax.prep.prep import (PrepConfig, make_box_stl,
                                      prepare_case)
    make_box_stl(tmp_path / "g.stl", 4, 8, 4, 8, 6, 16.0, 16.0)
    cfg = PrepConfig(itot=16, jtot=16, ktot=32, xlen=16.0, ylen=16.0,
                     zsize=100.0, expnr="905", lzstretch=True,
                     stretch_method="tanh", hlin=10.0, dzlin=1.0,
                     stretchconst=2.0)
    with pytest.warns(RuntimeWarning, match="final grid spacing large"):
        prepare_case(tmp_path / "g.stl", tmp_path, cfg)
    with pytest.warns(RuntimeWarning, match="final grid spacing large"):
        zf_want = zgrid_centers(32, 100.0, lzstretch=True, method="tanh",
                                hlin=10.0, dzlin=1.0, stretchconst=2.0)
    prof = np.loadtxt(tmp_path / "prof.inp.905", skiprows=2)
    np.testing.assert_allclose(prof[:, 0], zf_want, atol=1e-5)
    g = Grid.from_prof_inp(tmp_path / "prof.inp.905", 16, 16, 32, 16.0,
                           16.0, dtype=np.float64)
    assert g.zh[-1] == pytest.approx(100.0, rel=1e-4)
