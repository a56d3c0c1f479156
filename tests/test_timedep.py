"""Direct unit oracles for the timedep interpolators.

The reference interpolates piecewise-linearly between the series nodes and
holds the running value once timee passes the last node
(modtimedep.f90:319-425: timedepsurf :319, timedepnudge :357, timedeplw
:~400).  timedepsw already has its own roundtrip (test_solar.py); these
cover the other three branches."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from udales_jax.config import Config
from udales_jax.timedep import Timedep, _lerp_series


def _cfg(**flags):
    cfg = Config()
    return dataclasses.replace(cfg,
                               physics=dataclasses.replace(cfg.physics,
                                                           **flags))


def test_lerp_series_oracle():
    t = jnp.asarray([0.0, 10.0, 30.0])
    v = jnp.asarray([1.0, 3.0, -1.0])
    # exact nodes
    assert float(_lerp_series(t, v, 0.0)) == 1.0
    assert float(_lerp_series(t, v, 10.0)) == 3.0
    # interior: the reference's fac formula (modtimedep.f90:340)
    assert float(_lerp_series(t, v, 5.0)) == pytest.approx(2.0)
    assert float(_lerp_series(t, v, 25.0)) == pytest.approx(-1.0 * 0.75
                                                            + 3.0 * 0.25)
    # clamp before start and hold after end
    assert float(_lerp_series(t, v, -5.0)) == 1.0
    assert float(_lerp_series(t, v, 99.0)) == -1.0


def test_timedepsurf(tmp_path):
    rows = np.array([
        # t  bctfxm bctfxp bctfym bctfyp bctfz  (modtimedep.f90:121)
        [0.0, 0.1, 0.2, 0.3, 0.4, 0.5],
        [100.0, 1.1, 1.2, 1.3, 1.4, 1.5],
        [200.0, -0.1, -0.2, -0.3, -0.4, -0.5],
    ])
    p = tmp_path / "timedepsurf.inp.901"
    np.savetxt(p, rows, header="surface fluxes\nt xm xp ym yp z")
    td = Timedep.load(tmp_path, "901", _cfg(ltimedepsurf=True), nz=4)
    assert td is not None
    # halfway through the first interval
    vals = td.surf_fluxes(jnp.asarray(50.0))
    np.testing.assert_allclose(np.asarray(vals),
                               0.5 * (rows[0, 1:] + rows[1, 1:]), rtol=1e-6)
    # at a node, and held after the end
    np.testing.assert_allclose(np.asarray(td.surf_fluxes(jnp.asarray(200.0))),
                               rows[2, 1:], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(td.surf_fluxes(jnp.asarray(999.0))),
                               rows[2, 1:], rtol=1e-6)


def test_timedepnudge(tmp_path):
    nz = 3
    z = np.array([0.5, 1.5, 2.5])
    times = [0.0, 60.0]
    profs = {0.0: np.array([[290.0, 0.0, 1.0, 0.0],
                            [291.0, 0.0, 2.0, 0.0],
                            [292.0, 0.0, 3.0, 0.0]]),
             60.0: np.array([[300.0, 0.01, 2.0, 1.0],
                             [301.0, 0.01, 4.0, 1.0],
                             [302.0, 0.01, 6.0, 1.0]])}
    lines = ["# nudge profiles"]
    for t in times:
        lines.append(f"# {t}")
        for k in range(nz):
            lines.append(f"{z[k]} " + " ".join(map(str, profs[t][k])))
    (tmp_path / "timedepnudge.inp.901").write_text("\n".join(lines) + "\n")
    td = Timedep.load(tmp_path, "901", _cfg(ltimedepnudge=True), nz=nz)
    assert td is not None
    got = td.nudge_profiles(jnp.asarray(30.0))
    for i, name in enumerate(("thl", "qt", "u", "v")):
        want = 0.5 * (profs[0.0][:, i] + profs[60.0][:, i])
        np.testing.assert_allclose(np.asarray(got[name]), want, rtol=1e-6,
                                   err_msg=name)
    # hold after end
    got = td.nudge_profiles(jnp.asarray(1e4))
    np.testing.assert_allclose(np.asarray(got["thl"]), profs[60.0][:, 0],
                               rtol=1e-6)


def test_timedeplw(tmp_path):
    rows = np.array([[0.0, 350.0], [3600.0, 420.0], [7200.0, 300.0]])
    np.savetxt(tmp_path / "timedeplw.inp.901", rows, header="t skyLW")
    td = Timedep.load(tmp_path, "901", _cfg(ltimedeplw=True), nz=4)
    assert td is not None
    assert float(td.sky_lw(jnp.asarray(1800.0))) == pytest.approx(385.0)
    assert float(td.sky_lw(jnp.asarray(3600.0))) == pytest.approx(420.0)
    assert float(td.sky_lw(jnp.asarray(1e6))) == pytest.approx(300.0)


def test_disabled_flags_ignore_files(tmp_path):
    """Series files present but switches off -> not loaded (the reference
    reads only enabled blocks, modtimedep.f90:79-150)."""
    rows = np.array([[0.0, 350.0], [3600.0, 420.0]])
    np.savetxt(tmp_path / "timedeplw.inp.901", rows, header="t skyLW")
    assert Timedep.load(tmp_path, "901", _cfg(), nz=4) is None
