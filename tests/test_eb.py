"""Facet energy-balance tests: loader vs reference example 201, physical
behaviour of the batched conduction solve, and radiative equilibrium."""
from pathlib import Path

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from udales_jax.config import Config, EnergyBalanceConfig, const
from udales_jax.ibm.eb import FacetEB, qsat_fn

CASE = Path("/root/reference/examples/201")


def synthetic_eb(nfcts=8, skyLW=300.0, netsw=None, dtEB=2.0):
    cfg = Config(eb=EnergyBalanceConfig(lEB=True, dtEB=dtEB, skyLW=skyLW,
                                        bldT=295.0, flrT=295.0))
    facets = np.ones(nfcts, np.int64)          # walls (inner T = bldT)
    facnorm = np.tile([0.0, 0.0, 1.0], (nfcts, 1))
    faca = np.ones(nfcts)
    facem = np.full(nfcts, 0.85)
    facd = np.tile([0.1, 0.2, 0.2], (nfcts, 1))
    faccp = np.tile([1.875e6] * 3, (nfcts, 1))
    faclam = np.tile([0.75, 0.75, 0.75, 0.75], (nfcts, 1))
    faclGR = np.zeros(nfcts, bool)
    vf = np.zeros((nfcts, nfcts))              # no facet-facet exchange
    svf = np.ones(nfcts)
    netsw = netsw if netsw is not None else np.zeros(nfcts)
    Tfac = np.full(nfcts, 295.0)
    return FacetEB(cfg, facets, facnorm, faca, facem, facd, faccp, faclam,
                   faclGR, vf, None, svf, netsw, Tfac, dtype=np.float64)


class TestSynthetic:
    def test_equilibrium_is_steady(self):
        """At radiative equilibrium (LWin = emitted, no other fluxes and a
        matching interior temperature) T must stay put."""
        T0 = 295.0
        skyLW = const.boltz * T0 ** 4  # incoming exactly balances emission
        eb = synthetic_eb(skyLW=skyLW)
        # emissivity scales both absorption and emission; balance holds
        fs = eb.initial_state()
        fs2 = eb.update(fs, jnp.asarray(2.0))
        np.testing.assert_allclose(np.asarray(fs2.T), np.asarray(fs.T),
                                   atol=0.05)

    def test_heating_cooling_signs(self):
        """More incoming radiation -> surface warms; less -> cools."""
        T0 = 295.0
        base = const.boltz * T0 ** 4
        warm = synthetic_eb(skyLW=base + 200.0)
        cool = synthetic_eb(skyLW=base - 200.0)
        t = jnp.asarray(2.0)
        Tw = np.asarray(warm.update(warm.initial_state(), t).T)
        Tc = np.asarray(cool.update(cool.initial_state(), t).T)
        assert Tw[:, 0].min() > T0 + 0.002
        assert Tc[:, 0].max() < T0 - 0.002

    def test_sensible_flux_cools_surface(self):
        T0 = 295.0
        eb = synthetic_eb(skyLW=const.boltz * T0 ** 4)
        fs = eb.initial_state()
        # positive hfi = heat INTO air accumulated over 2 s
        fs = dataclasses.replace(fs, hfi=fs.hfi - 100.0 * 2.0
                                 / const.rhoa / const.cp * np.asarray(eb.faca))
        fs2 = eb.update(fs, jnp.asarray(2.0))
        assert np.asarray(fs2.T)[:, 0].max() < T0 - 0.001

    def test_fire_quantization(self):
        eb = synthetic_eb(dtEB=2.0)
        fs = eb.initial_state()
        assert float(fs.tnextEB) == 2.0
        fs2 = eb.maybe_update(fs, jnp.asarray(1.0))   # too early: no-op
        assert float(jnp.abs(fs2.T - fs.T).max()) == 0.0
        fs3 = eb.maybe_update(fs, jnp.asarray(2.013))
        assert float(fs3.tnextEB) == 4.0  # NINT(2.013+2) (modEB.f90:535)


@pytest.mark.skipif(not CASE.exists(), reason="reference absent")
class TestLoad201:
    def test_load(self):
        from udales_jax.config import load_namoptions
        from udales_jax.grid import Grid
        from udales_jax.ibm.ibm import IBM
        cfg = load_namoptions(CASE / "namoptions.201")
        assert cfg.eb.lEB and cfg.eb.dtEB == 2.0
        d = cfg.domain
        grid = Grid.from_prof_inp(CASE / "prof.inp.201", d.itot, d.jtot,
                                  d.ktot, d.xlen, d.ylen)
        ibm = IBM.load(CASE, "201", cfg, grid)
        eb = FacetEB.load(CASE, "201", cfg, ibm)
        assert eb.nfcts == 994
        assert eb.vf.shape == (994, 994)
        # view-factor row sums + sky view <= 1 (enclosure property)
        tot = np.asarray(eb.vf).sum(axis=1) + np.asarray(eb.svf)
        assert tot.max() < 1.001 and tot.min() > 0.999  # enclosure
        fs = eb.initial_state()
        assert np.isfinite(np.asarray(fs.T)).all()
        fs2 = eb.update(fs, jnp.asarray(2.0))
        T2 = np.asarray(fs2.T)
        assert np.isfinite(T2).all()
        # facets with SEB modelled move but stay physical
        mm = np.asarray(eb.model_mask)
        assert (np.abs(T2[mm] - np.asarray(fs.T)[mm]) < 30).all()


def test_layer_initial_temperatures():
    """lfacTlyrs: a (nfcts, nfaclyrs) Tfacinit initializes each layer
    directly (initfac.f90:301-318) instead of the linear interior ramp."""
    nfcts = 4
    Tlyr = 290.0 + np.arange(nfcts * 3, dtype=float).reshape(nfcts, 3)
    cfg = Config(eb=EnergyBalanceConfig(lEB=True, bldT=285.0, flrT=284.0))
    facets = np.ones(nfcts, np.int64)
    eb = FacetEB(cfg, facets, np.tile([0.0, 0.0, 1.0], (nfcts, 1)),
                 np.ones(nfcts), np.full(nfcts, 0.85),
                 np.tile([0.1, 0.2, 0.2], (nfcts, 1)),
                 np.tile([1.875e6] * 3, (nfcts, 1)),
                 np.tile([0.75] * 4, (nfcts, 1)), np.zeros(nfcts, bool),
                 np.zeros((nfcts, nfcts)), None, np.ones(nfcts),
                 np.zeros(nfcts), Tlyr, dtype=np.float64)
    T0 = np.asarray(eb.T0)
    np.testing.assert_allclose(T0[:, :3], Tlyr)
    np.testing.assert_allclose(T0[:, 3], 285.0)   # inner face = bldT
