"""Measured-weather shortwave pathway (udprep isolar=3 equivalent,
tools/python/udprep/udprep_radiation.py:726/1003)."""
from datetime import datetime

import numpy as np
import pytest

from udales_jax.prep.prep import make_box_stl
from udales_jax.prep.stl import read_stl
from udales_jax.prep.weather import (generate_timedepsw_weather,
                                     read_weather_table,
                                     shortwave_from_weather,
                                     weather_day_series, weather_single_shot)


@pytest.fixture(scope="module")
def weather_file(tmp_path_factory):
    """A synthetic day of hourly records, reference column layout."""
    p = tmp_path_factory.mktemp("wx") / "weather.txt"
    rows = ["date TIME SOLAR SOLAR_1 HELIOM DIFSOLAR"]
    for h in range(24):
        # daylight 6..18h: zenith dips to 30 deg at noon, beam up to 800
        if 6 <= h <= 18:
            zen = 30.0 + 60.0 * abs(h - 12) / 6.0
            I = 800.0 * max(np.cos(np.radians(zen)), 0.0)
            dsky = 120.0
        else:
            zen, I, dsky = 120.0, 0.0, 0.0
        rows.append(f"300911 {h*3600} {zen:.1f} {180.0 - 15.0*(h-12):.1f} "
                    f"{I:.1f} {dsky:.1f}")
    p.write_text("\n".join(rows) + "\n")
    return p


@pytest.fixture(scope="module")
def geom(tmp_path_factory):
    p = tmp_path_factory.mktemp("wxgeom") / "box.stl"
    make_box_stl(p, 4, 8, 4, 8, 6, 12.0, 12.0)
    return read_stl(p)


def test_read_table(weather_file):
    w = read_weather_table(weather_file)
    assert set(w) == {"date", "TIME", "SOLAR", "SOLAR_1", "HELIOM",
                      "DIFSOLAR"}
    assert len(w["TIME"]) == 24


def test_single_shot_and_alignment(weather_file):
    st = weather_single_shot(weather_file, datetime(2011, 9, 30, 12))
    assert st["zenith"] == pytest.approx(30.0)
    assert st["I"] == pytest.approx(800.0 * np.cos(np.radians(30.0)), rel=1e-3)
    with pytest.raises(ValueError):
        weather_single_shot(weather_file, datetime(2012, 1, 1, 12))
    # day series rolled so index 0 == start hour (udprep_radiation.py:738)
    t, series, interps = weather_day_series(weather_file,
                                            datetime(2011, 9, 30, 9))
    assert series["zenith"][0] == pytest.approx(30.0 + 60.0 * 3 / 6)
    # interpolator reproduces the node values
    assert float(interps["I"](0.0)) == pytest.approx(series["I"][0], rel=1e-6)


def test_shortwave_physics(weather_file, geom):
    tris, normals = geom
    noon = weather_single_shot(weather_file, datetime(2011, 9, 30, 12))
    night = weather_single_shot(weather_file, datetime(2011, 9, 30, 2))
    day = shortwave_from_weather(tris, normals, noon)
    dark = shortwave_from_weather(tris, normals, night)
    assert day["sdir"].max() > 100.0          # roof sees the beam
    assert np.all(dark["sdir"] == 0.0)        # sun below horizon
    # roof (normal +z) must receive ~ I*cos(zenith)
    up = np.array([t for t, n in zip(day["sdir"], normals) if n[2] > 0.9])
    want = noon["I"] * np.cos(np.radians(noon["zenith"]))
    assert up.max() == pytest.approx(want, rel=0.05)


def test_timedepsw_series(weather_file, geom, tmp_path):
    tris, normals = geom
    t, table = generate_timedepsw_weather(
        tris, normals, weather_file, datetime(2011, 9, 30, 10),
        runtime=4 * 3600.0, dtSP=3600.0, outpath=tmp_path, expnr="901")
    assert table.shape == (5, len(tris))
    assert np.isfinite(table).all() and (table >= 0).all()
    assert table.max() > 100.0
    out = np.loadtxt(tmp_path / "timedepsw.inp.901", skiprows=1)
    np.testing.assert_allclose(out[:, 0], t)
    np.testing.assert_allclose(out[:, 1:], table, atol=5e-3)
