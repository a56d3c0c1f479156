"""UDPost postprocessing against committed reference case inputs and
against this framework's own NetCDF outputs (udbase.py parity semantics)."""
import numpy as np
import pytest

CASE102 = "/root/reference/examples/102"


@pytest.fixture(scope="module")
def case102():
    from pathlib import Path
    if not Path(CASE102).is_dir():
        pytest.skip(f"reference example tree {CASE102} not present")
    return CASE102


@pytest.fixture(scope="module")
def post102(case102):
    from udales_jax.post import UDPost
    return UDPost("102", case102)


class TestCaseLoading:
    def test_grid_and_counts(self, post102):
        p = post102
        assert (p.itot, p.jtot, p.ktot) == (64, 64, 64)
        assert p.nfcts == 2885
        assert set(p.facsec) == {"u", "v", "w", "c"}
        # counts from examples/102/info.txt (&WALLS)
        assert len(p.facsec["u"]["facid"]) == 13354
        assert len(p.facsec["c"]["facid"]) == 12240

    def test_solid_masks(self, post102):
        m = post102.load_solid_masks()
        assert m["c"].sum() == 8192          # nsolpts_c in info.txt
        assert m["u"].shape == (64, 64, 64)

    def test_prof_and_lscale(self, post102):
        prof = post102.load_prof()
        assert len(prof["u"]) == 64
        ls = post102.load_lscale()
        assert len(ls["ug"]) == 64


class TestFacetProps:
    def test_assign_prop_scalar(self, post102):
        z0 = post102.assign_prop_to_fac("z0")
        assert z0.shape == (2885,)
        assert np.all(z0 > 0)

    def test_assign_prop_layered(self, post102):
        lam = post102.assign_prop_to_fac("lam")
        d = post102.assign_prop_to_fac("d")
        assert lam.shape == d.shape == (2885, post102.cfg.eb.nfaclyrs)
        assert np.all(d > 0)

    def test_area_average(self, post102):
        # area-average of a constant is that constant
        ones = np.ones(post102.nfcts)
        assert np.isclose(post102.area_average_fac(ones), 1.0)
        # selection restricts the weights
        sel = np.arange(100)
        v = np.zeros(post102.nfcts)
        v[:100] = 2.0
        assert np.isclose(post102.area_average_fac(v, sel), 2.0)


class TestFacetFieldConversion:
    def test_fac_to_field_constant(self, post102):
        """Cells covered by sections of a constant facet value get exactly
        that value (area-weighted mean of a constant)."""
        f = post102.convert_fac_to_field(np.full(post102.nfcts, 3.5))
        covered = np.isfinite(f)
        assert covered.sum() > 0
        assert np.allclose(f[covered], 3.5)

    def test_frontal_properties(self, post102):
        fp = post102.calculate_frontal_properties()
        assert fp["skylinex"].shape == (64, 64)
        assert 0.0 < fp["brx"] <= 1.0
        assert 0.0 < fp["bry"] <= 1.0
        assert fp["Afx"] > 0 and fp["Afy"] > 0

    def test_facflx_density_integral(self, post102):
        """convert_facflx_to_field conserves sum(var*area) when integrated
        over cell volumes."""
        var = np.linspace(0.5, 1.5, post102.nfcts)
        rho = post102.convert_facflx_to_field(var)
        fs = post102.facsec["c"]
        expect = float((var[fs["facid"]] * fs["area"]).sum())
        cellv = post102.dx * post102.dy * post102.dzt[None, None, :]
        assert np.isclose(float((rho * cellv).sum()), expect, rtol=1e-10)


class TestOutputsRoundtrip:
    def test_seb_roundtrip(self, tmp_path, case102):
        """Write facT/facEB via NCWriter, reassemble SEB via UDPost."""
        import shutil
        from udales_jax.io.netcdf import NCWriter
        from udales_jax.post import UDPost

        case = tmp_path / "case"
        case.mkdir()
        for f in ("namoptions.102", "prof.inp.102", "facets.inp.102",
                  "factypes.inp.102", "facetarea.inp.102"):
            src = f"{CASE102}/{f}"
            import os
            if os.path.exists(src):
                shutil.copy(src, case / f)
        # facetarea may not exist in 102; synthesize
        p0 = UDPost("102", case) if (case / "facetarea.inp.102").exists() \
            else None
        nf, L = 2885, 3
        if p0 is None:
            np.savetxt(case / "facetarea.inp.102",
                       np.ones(nf), header="area", comments="# ")
            p0 = UDPost("102", case)

        wT = NCWriter(case / "facT.102.nc", nfcts=nf, nlayers=L + 1)
        wT.define("T", ("facet", "layer"), "K", "T")
        wT.define("dTdz", ("facet", "layer"), "K/m", "grad")
        T = np.full((nf, L + 1), 300.0)
        dTdz = np.full((nf, L + 1), -2.0)
        wT.append(0.0, {"T": T, "dTdz": dTdz})
        wT.close()
        wEB = NCWriter(case / "facEB.102.nc", nfcts=nf)
        for v in ("netsw", "LWin", "LWout", "hf", "ef"):
            wEB.define(v, ("facet",), "W/m^2", v)
        wEB.append(0.0, {"netsw": np.full(nf, 100.0),
                         "LWin": np.full(nf, 350.0),
                         "LWout": np.full(nf, 400.0),
                         "hf": np.full(nf, 30.0),
                         "ef": np.full(nf, 10.0)})
        wEB.close()

        seb = p0.load_seb()
        assert np.allclose(seb["Kstar"], 100.0)
        assert np.allclose(seb["Lstar"], -50.0)
        assert np.allclose(seb["H"], -30.0)
        assert np.allclose(seb["Tsurf"], 300.0)
        lam1 = p0.assign_prop_to_fac("lam")[:, 0]
        assert np.allclose(seb["G"][:, 0], -lam1 * -2.0)
        avg = p0.area_average_seb(seb)
        assert np.isclose(avg["Kstar"][0], 100.0)


class TestMergeStat:
    """udstats.merge_stat semantics (udbase.merge_stat:1296)."""

    def test_mean_only(self):
        from udales_jax.post import merge_stat
        X = np.arange(12.0)
        np.testing.assert_allclose(merge_stat(X, 4),
                                   [1.5, 5.5, 9.5])

    def test_incomplete_window_drops_oldest(self):
        from udales_jax.post import merge_stat
        X = np.arange(10.0)   # 10 samples, n=4 -> drop the 2 OLDEST
        np.testing.assert_allclose(merge_stat(X, 4), [3.5, 7.5])

    def test_variance_law_of_total_variance(self):
        """Merged variance must equal the population variance computed
        directly from the raw samples when the short windows carry their
        own variances."""
        from udales_jax.post import merge_stat
        rng = np.random.default_rng(5)
        raw = rng.standard_normal((3, 24))   # 24 raw samples per row
        # short windows of 4 raw samples -> 6 short stats
        short = raw.reshape(3, 6, 4)
        Xs = short.mean(axis=-1)
        XpXp = short.var(axis=-1)
        # merge 3 short windows -> 2 long windows of 12 raw samples
        Xm, var = merge_stat(Xs, XpXp, 3)
        want_m = raw.reshape(3, 2, 12).mean(axis=-1)
        want_v = raw.reshape(3, 2, 12).var(axis=-1)
        np.testing.assert_allclose(Xm, want_m, rtol=1e-12)
        np.testing.assert_allclose(var, want_v, rtol=1e-12)

    def test_covariance_merging(self):
        from udales_jax.post import merge_stat
        rng = np.random.default_rng(7)
        a = rng.standard_normal(24)
        b = 0.5 * a + rng.standard_normal(24)
        As = a.reshape(6, 4).mean(axis=-1)
        Bs = b.reshape(6, 4).mean(axis=-1)
        cov_s = ((a.reshape(6, 4) - As[:, None])
                 * (b.reshape(6, 4) - Bs[:, None])).mean(axis=-1)
        Am, Bm, cov = merge_stat(As, Bs, cov_s, 6)
        np.testing.assert_allclose(Am, a.mean(), rtol=1e-12)
        np.testing.assert_allclose(
            cov, ((a - a.mean()) * (b - b.mean())).mean(), rtol=1e-12)

    def test_keyword_forms_and_errors(self):
        from udales_jax.post import merge_stat
        X = np.arange(8.0)
        # keyword XpXp form
        m, v = merge_stat(X, 4, XpXp=np.zeros(8))
        np.testing.assert_allclose(m, [1.5, 5.5])
        with pytest.raises(ValueError, match="positive"):
            merge_stat(X, 0)
        with pytest.raises(ValueError, match="Not enough"):
            merge_stat(X, 9)
        with pytest.raises(ValueError, match="last dimension"):
            merge_stat(X, 4, XpXp=np.zeros(5))


class TestCoarsegrainField:
    def test_uniform_field_unchanged(self):
        from udales_jax.post import coarsegrain_field
        v = np.full((8, 8, 3), 2.5)
        xm = np.arange(8) * 1.0
        out = coarsegrain_field(v, [4.0], xm, xm)
        assert out.shape == (8, 8, 3, 1)
        np.testing.assert_allclose(out[..., 0], 2.5, rtol=1e-12)

    def test_matches_direct_periodic_box_average(self):
        from udales_jax.post import coarsegrain_field
        rng = np.random.default_rng(11)
        nx = ny = 12
        v = rng.standard_normal((nx, ny, 2))
        dx = 2.0
        xm = np.arange(nx) * dx
        L = 8.0                      # half-width = round((L/dx)/2) = 2
        out = coarsegrain_field(v, L, xm, xm)
        ng = 2
        want = np.zeros_like(v)
        for i in range(nx):
            for j in range(ny):
                acc = []
                for di in range(-ng, ng + 1):
                    for dj in range(-ng, ng + 1):
                        acc.append(v[(i + di) % nx, (j + dj) % ny])
                want[i, j] = np.mean(acc, axis=0)
        np.testing.assert_allclose(out[..., 0], want, atol=1e-12)

    def test_mean_preserved_multiple_filters(self):
        from udales_jax.post import coarsegrain_field
        rng = np.random.default_rng(13)
        v = rng.standard_normal((16, 16, 4))
        xm = np.arange(16) * 0.5
        out = coarsegrain_field(v, [1.0, 4.0], xm, xm)
        assert out.shape[-1] == 2
        for i in range(2):
            np.testing.assert_allclose(out[..., i].mean(axis=(0, 1)),
                                       v.mean(axis=(0, 1)), atol=1e-12)
            # larger filters remove more variance
        assert out[..., 1].var() < out[..., 0].var() <= v.var()

    def test_validation(self):
        from udales_jax.post import coarsegrain_field
        with pytest.raises(ValueError, match="3D"):
            coarsegrain_field(np.zeros((4, 4)), 1.0, np.arange(4),
                              np.arange(4))
