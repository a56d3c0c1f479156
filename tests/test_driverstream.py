"""Chunked streaming driver replay (lchunkread, moddriver.f90:933):
the rolling device window must reproduce the full-series interpolation
exactly while holding only `chunkread_size` planes in device memory."""
import types
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np
import pytest

JT, KT = 12, 10


@dataclass
class _FakeState:
    timee: float
    drv: Any = None

    def replace(self, **kw):
        return replace(self, **kw)


@pytest.fixture(scope="module")
def series_dir(tmp_path_factory):
    """Synthesize a 300-record precursor series, much larger than the
    window (the verdict scenario: driverstore >> chunkread_size)."""
    from udales_jax.io.driverfiles import write_driver_files
    out = tmp_path_factory.mktemp("drvstream")
    nt = 300
    rng = np.random.default_rng(7)
    t = np.cumsum(0.2 + 0.05 * rng.random(nt))
    jj, kk = np.meshgrid(np.arange(JT), np.arange(KT), indexing="ij")
    base = np.sin(jj / 3.0) + np.cos(kk / 2.0)
    mk = lambda nz: (base[None, :, :KT if nz == KT else KT]
                     * np.cos(t)[:, None, None]
                     + 0.1 * rng.standard_normal((nt, JT, nz)))
    planes = dict(u=1.5 + mk(KT), v=0.1 * mk(KT),
                  w=np.concatenate([np.zeros((nt, JT, 1)),
                                    0.05 * mk(KT)], axis=2),
                  thl=290.0 + mk(KT))
    write_driver_files(out, "777", t, planes, JT, KT, nprocy=2)
    return out, t, planes


def test_windowed_read_matches_full(series_dir):
    from udales_jax.io.driverfiles import read_driver_files
    out, t, planes = series_dir
    full = read_driver_files(out, 777, JT, KT)
    win = read_driver_files(out, 777, JT, KT, start=120, driverstore=40)
    np.testing.assert_array_equal(win["t"], full["t"][120:160])
    for k in ("u", "v", "w", "thl"):
        np.testing.assert_array_equal(win[k], full[k][120:160])


def test_stream_matches_full_series_replay(series_dir):
    """Sweep simulated time through the whole 300-record series with a
    32-record window: every interpolated plane must equal the full-series
    Inlet interpolation bit-for-bit, and the device window must never hold
    more than `chunk` records."""
    import jax.numpy as jnp
    from udales_jax.io.driverfiles import read_driver_files
    from udales_jax.io.driverstream import DriverStream
    from udales_jax.ops.openbc import (BC_DRIVER, Inlet,
                                       driver_window_planes)
    out, t, _ = series_dir
    d = read_driver_files(out, 777, JT, KT)
    j = lambda k: jnp.asarray(d[k], jnp.float64)
    inlet = Inlet(mode=BC_DRIVER, t=j("t"), u=j("u"), v=j("v"), w=j("w"),
                  thl=j("thl"))
    stream = DriverStream(out, 777, JT, KT, jnp.float64, chunk=32)
    state = _FakeState(timee=0.0)
    refills = 0
    last_drv = None
    for timee in np.linspace(d["t"][0], d["t"][-1] + 1.0, 97):
        state = _FakeState(timee=float(timee), drv=state.drv)
        state = stream.ensure(state)
        if state.drv is not last_drv:
            refills += 1
            last_drv = state.drv
        assert state.drv.u.shape == (32, JT, KT)   # bounded device window
        got = driver_window_planes(state.drv, jnp.float64(timee))
        want = inlet.planes(jnp.float64(timee), JT, KT)
        for k in ("u", "v", "w", "thl"):
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
    assert refills >= 8   # the sweep crossed many windows


def test_stream_clamps_past_series_end(series_dir):
    import jax.numpy as jnp
    from udales_jax.io.driverstream import DriverStream
    from udales_jax.ops.openbc import driver_window_planes
    out, t, planes = series_dir
    stream = DriverStream(out, 777, JT, KT, jnp.float64, chunk=32)
    state = stream.ensure(_FakeState(timee=float(t[-1]) + 100.0))
    got = driver_window_planes(state.drv, jnp.float64(float(t[-1]) + 100.0))
    np.testing.assert_allclose(np.asarray(got["u"]), planes["u"][-1],
                               atol=1e-12)
