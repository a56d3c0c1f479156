"""HARMONIE NWP radiation coupling oracles (prep/harmonie.py vs
tools/python/udprep/harmonie_radiation.py semantics).

All tests run on synthesized accumulated series — no network, no demo
data, no GRIB dependencies."""
import math
from datetime import datetime, timedelta

import numpy as np
import pytest

from udales_jax.prep import harmonie as hm
from udales_jax.prep.weather import (read_weather_table, weather_single_shot,
                                     shortwave_from_weather)

LAT, LON, TZ = 48.85, 2.35, 0.0     # Paris-ish (HARMONIE demo domain)
START = datetime(2023, 8, 20, 6, 0, 0)


def _true_flux(t):
    """Half-sine 'day' flux in W/m^2 over seconds-of-day t."""
    day = np.sin(np.pi * (t - 21600.0) / 43200.0)
    return 800.0 * np.clip(day, 0.0, None)


def _accumulated(offsets):
    """Exact integral of _true_flux from 0 to each offset (J/m^2)."""
    out = []
    for T in offsets:
        # integrate analytically: 800 * 43200/pi * (1 - cos(pi (t-21600)/43200))/ ... do numerically tight
        tt = np.linspace(0.0, float(T), 20001)
        out.append(np.trapezoid(_true_flux(tt), tt))
    return np.asarray(out)


class TestAccumulatedToFlux:
    def test_energy_conservation_exact(self):
        interval = 900
        offsets = np.arange(6 * 3600, 12 * 3600 + 1, interval)
        accum = _accumulated(offsets)
        times, flux = hm.accumulated_to_flux(offsets, accum)
        # invariant: total decomposed energy == accumulated difference
        assert np.sum(flux) * interval == pytest.approx(
            accum[-1] - accum[0], rel=1e-13)
        # model times anchored at the SECOND entry (first flux at t=0)
        assert times[0] == 0.0 and times[-1] == offsets[-1] - offsets[1]

    def test_interval_means_match_analytic(self):
        interval = 900
        offsets = np.arange(6 * 3600, 12 * 3600 + 1, interval)
        accum = _accumulated(offsets)
        _, flux = hm.accumulated_to_flux(offsets, accum)
        for i in range(len(flux)):
            lo, hi = offsets[i], offsets[i + 1]
            tt = np.linspace(lo, hi, 2001)
            want = np.trapezoid(_true_flux(tt), tt) / interval
            assert flux[i] == pytest.approx(want, rel=1e-6, abs=1e-6)

    def test_negative_flux_raises(self):
        offsets = np.array([0, 900, 1800])
        accum = np.array([0.0, 1000.0, 500.0])   # accumulation decreases
        with pytest.raises(ValueError, match="Negative"):
            hm.accumulated_to_flux(offsets, accum)

    def test_roundoff_negative_clamped(self):
        offsets = np.array([0, 900, 1800])
        accum = np.array([0.0, 1000.0, 1000.0 - 1e-4])
        _, flux = hm.accumulated_to_flux(offsets, accum)
        assert flux[1] == 0.0

    def test_nonuniform_offsets_rejected(self):
        with pytest.raises(ValueError, match="uniform"):
            hm.accumulated_to_flux([0, 900, 2700], [0.0, 1.0, 2.0])

    def test_before_forecast_start_rejected(self):
        with pytest.raises(ValueError, match="forecast start"):
            hm.accumulated_to_flux([-900, 0, 900], [0.0, 0.0, 1.0])

    def test_table_roundtrip(self, tmp_path):
        p = tmp_path / "ssrd.txt"
        offsets = np.arange(0, 3601, 900)
        accum = _accumulated(offsets + 6 * 3600)
        with open(p, "w") as f:
            f.write("# offset_s accumulated_J_m2\n")
            for o, a in zip(offsets, accum):
                f.write(f"{o} {float(a)!r}\n")
        off2, acc2 = hm.read_accumulated_table(p)
        np.testing.assert_array_equal(off2, offsets)
        np.testing.assert_allclose(acc2, accum, rtol=1e-15)


class TestErbsSplit:
    def test_diffuse_fraction_branches(self):
        # kt <= 0.22: linear branch
        assert hm.erbs_diffuse_fraction(0.1) == pytest.approx(1 - 0.009)
        # polynomial branch
        kt = 0.5
        want = (0.9511 - 0.1604 * kt + 4.388 * kt ** 2 - 16.638 * kt ** 3
                + 12.336 * kt ** 4)
        assert hm.erbs_diffuse_fraction(kt) == pytest.approx(want)
        # clear-sky cap
        assert hm.erbs_diffuse_fraction(0.9) == 0.165
        assert hm.erbs_diffuse_fraction(-0.3) == pytest.approx(1.0)

    def test_energy_closure(self):
        """dni * cos(zen) + dsky == ghi whenever a direct component
        exists (the split conserves the horizontal energy flux)."""
        when = datetime(2023, 8, 20, 12, 0)
        for ghi, zen in [(600.0, 30.0), (150.0, 60.0), (900.0, 10.0),
                        (50.0, 85.0)]:
            dni, dsky = hm.split_ghi_erbs(ghi, zen, when)
            cz = math.cos(math.radians(zen))
            assert dni * cz + dsky == pytest.approx(ghi, rel=1e-12)
            assert dni >= 0 and 0 <= dsky <= ghi

    def test_night_and_horizon(self):
        when = datetime(2023, 8, 20, 12, 0)
        assert hm.split_ghi_erbs(500.0, 95.0, when) == (0.0, 0.0)
        assert hm.split_ghi_erbs(0.0, 30.0, when) == (0.0, 0.0)
        # near-horizontal sun: all diffuse (ray tracer skips such beams)
        dni, dsky = hm.split_ghi_erbs(30.0, 89.9, when)
        assert dni == 0.0 and dsky == 30.0

    def test_extraterrestrial_eccentricity(self):
        # perihelion-ish (early Jan): +3.3%; aphelion-ish (early Jul): -3.3%
        jan = hm.extraterrestrial_horizontal_irradiance(
            datetime(2023, 1, 1, 12), 1.0)
        jul = hm.extraterrestrial_horizontal_irradiance(
            datetime(2023, 7, 2, 12), 1.0)
        assert jan == pytest.approx(1367.0 * 1.033, rel=1e-3)
        assert jul == pytest.approx(1367.0 * 0.967, rel=1e-3)
        assert hm.extraterrestrial_horizontal_irradiance(
            datetime(2023, 1, 1, 12), -0.1) == 0.0


class TestAtmosphere:
    def _atmos(self, runtime=6 * 3600.0, dtSP=1800.0):
        interval = 900
        start_off = 6 * 3600           # case starts 6 h into the forecast
        offsets = np.arange(start_off - interval,
                            start_off + int(runtime) + interval, interval)
        accum = _accumulated(offsets)
        return hm.harmonie_shortwave_atmosphere(
            offsets, accum, START, runtime, dtSP, LAT, LON, TZ)

    def test_daylight_sanity(self):
        atmos = self._atmos()
        assert atmos.times[0] == 0.0
        # morning-to-noon window at 48 N in August: sun is up, GHI grows
        assert np.all(atmos.ghi >= 0)
        assert np.all(atmos.dni >= 0) and np.all(atmos.dsky >= 0)
        mid = atmos.ghi.size // 2
        assert atmos.ghi[mid:].max() > atmos.ghi[:3].max()
        # per-sample energy closure wherever direct exists
        cz = np.cos(np.radians(atmos.zenith))
        has_dir = atmos.dni > 0
        np.testing.assert_allclose(
            (atmos.dni * cz + atmos.dsky)[has_dir], atmos.ghi[has_dir],
            rtol=1e-12)

    def test_model_times_beyond_series_rejected(self):
        interval = 900
        offsets = np.arange(0, 3601, interval)
        accum = _accumulated(offsets + 6 * 3600)
        with pytest.raises(ValueError, match="ends at"):
            hm.harmonie_shortwave_atmosphere(
                offsets, accum, START, 7200.0, 900.0, LAT, LON, TZ)

    def test_weather_table_roundtrip(self, tmp_path):
        """The emitted weather table must drive the existing isolar=3
        reader with identical per-sample quantities."""
        atmos = self._atmos(runtime=3 * 3600.0, dtSP=3600.0)
        p = tmp_path / "weather.txt"
        hm.write_weather_table(p, atmos, START)
        w = read_weather_table(p)
        assert set(w) == {"date", "TIME", "SOLAR", "SOLAR_1", "HELIOM",
                          "DIFSOLAR"}
        # single-shot lookup at START + 1h reproduces sample 1
        shot = weather_single_shot(p, START + timedelta(hours=1))
        assert shot["zenith"] == pytest.approx(atmos.zenith[1], abs=1e-3)
        # weather.py returns solver azimuth = SOLAR_1 + 90
        assert shot["azimuth"] == pytest.approx(atmos.azimuth_local[1],
                                                abs=1e-3)
        assert shot["I"] == pytest.approx(atmos.dni[1], abs=1e-3)
        assert shot["Dsky"] == pytest.approx(atmos.dsky[1], abs=1e-3)


class TestFacetPathway:
    def _flat_ground(self):
        # unit square split into two up-facing triangles, nothing to shade
        tris = np.array([
            [[0, 0, 0], [1, 0, 0], [1, 1, 0]],
            [[0, 0, 0], [1, 1, 0], [0, 1, 0]],
        ], float)
        normals = np.array([[0, 0, 1.0], [0, 0, 1.0]])
        return tris, normals

    def test_flat_facet_absorbs_one_minus_albedo_times_ghi(self, tmp_path):
        """End-to-end energy oracle: an unshaded horizontal facet's
        non-scattering net shortwave is (1 - albedo) * GHI exactly —
        sdir = DNI cos(zen) and fss = 1, so the Erbs split must hand the
        full horizontal flux through the facet machinery."""
        tris, normals = self._flat_ground()
        interval = 900
        start_off = 6 * 3600
        runtime, dtSP = 4 * 3600.0, 3600.0
        offsets = np.arange(start_off - interval,
                            start_off + int(runtime) + interval, interval)
        accum = _accumulated(offsets)
        albedo = np.array([0.25, 0.25])
        times, sdir, knet, atmos = hm.generate_timedepsw_from_harmonie(
            tris, normals, offsets, accum, START, runtime, dtSP, LAT, LON,
            TZ, albedo=albedo, subdiv=1,
            outpath=tmp_path, expnr="901")
        cz = np.cos(np.radians(atmos.zenith))
        usable = atmos.dni * cz > 1e-9
        for i in np.flatnonzero(usable):
            np.testing.assert_allclose(
                sdir[i], atmos.dni[i] * cz[i], rtol=1e-6,
                err_msg=f"sample {i}")
            np.testing.assert_allclose(
                knet[i], 0.75 * atmos.ghi[i], rtol=1e-6,
                err_msg=f"sample {i}")
        # written file loads in the solver's timedep layout
        d = np.loadtxt(tmp_path / "timedepsw.inp.901", skiprows=1, ndmin=2)
        np.testing.assert_allclose(d[:, 0], times)
        np.testing.assert_allclose(d[:, 1:], knet, atol=1e-4)

    def test_reference_layout_roundtrip(self, tmp_path):
        times = np.array([0.0, 900.0, 1800.0])
        knet = np.arange(9, dtype=float).reshape(3, 3) * 1.25
        p = hm.write_timedepsw(tmp_path / "sw.ref", times, knet,
                               layout="reference")
        lines = p.read_text().splitlines()
        t_row = np.array([float(x) for x in lines[1].split()])
        np.testing.assert_allclose(t_row, times)
        block = np.array([[float(x) for x in ln.split()]
                          for ln in lines[2:]])
        np.testing.assert_allclose(block, knet.T, atol=1e-4)

    def test_longwave_series_and_writer(self, tmp_path):
        # constant 320 W/m2 sky longwave: accumulated is linear
        interval = 900
        offsets = np.arange(0, 6 * 3600 + 1, interval)
        accum = 320.0 * offsets.astype(float)
        times, lwsky = hm.harmonie_longwave_series(
            offsets, accum, runtime=4 * 3600.0, ntimedeplw=9)
        np.testing.assert_allclose(lwsky, 320.0, rtol=1e-12)
        assert times[0] == 0.0 and times[-1] == 4 * 3600.0
        p = hm.write_timedeplw(tmp_path / "timedeplw.inp.901", times, lwsky)
        d = np.loadtxt(p, skiprows=1, ndmin=2)
        np.testing.assert_allclose(d[:, 1], 320.0, atol=1e-5)
