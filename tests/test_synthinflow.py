"""Synthetic-inflow tests: target Reynolds stresses, time correlation, and
solver ingestion."""
import numpy as np
import jax

from udales_jax.prep.syntheticinflow import generate_synthetic_inflow
from udales_jax.ops.openbc import load_driver_inlet


def test_stress_targets(tmp_path):
    ny, nz = 24, 16
    dzf = np.ones(nz) * 0.5
    u_mean = 1.0 + 0.1 * np.arange(nz)
    uu = np.full(nz, 0.04)
    ww = np.full(nz, 0.02)
    uw = np.full(nz, -0.01)
    path = tmp_path / "driverdata.900.npz"
    generate_synthetic_inflow(path, ny, nz, 0.5, dzf, t_end=60.0, dt=0.25,
                              u_mean=u_mean, uu=uu, vv=uu, ww=ww, uw=uw,
                              Ly=1.0, Lz=1.0, Tscale=1.5, seed=3)
    with np.load(path) as f:
        U = f["u"]
        W = f["w"][:, :, :nz]
        t = f["t"]
    assert len(t) == 241
    up = U - U.mean(axis=0)
    wp = W - W.mean(axis=0)
    uu_m = (up ** 2).mean()
    uw_m = (up * wp).mean()
    assert abs(uu_m - 0.04) / 0.04 < 0.35, uu_m
    assert uw_m < -0.003, uw_m   # correct sign + magnitude of shear stress
    # mean profile preserved
    np.testing.assert_allclose(U.mean(axis=(0, 1)), u_mean, atol=0.05)
    # time correlation: consecutive planes correlated, distant ones not
    c1 = np.corrcoef(up[0].ravel(), up[1].ravel())[0, 1]
    c40 = np.corrcoef(up[0].ravel(), up[80].ravel())[0, 1]
    assert c1 > 0.5
    assert abs(c40) < 0.3


def test_solver_ingestion(tmp_path):
    """Generated planes drive an open-x run."""
    import dataclasses
    import jax.numpy as jnp
    from tests.test_openbc import make_open_model, open_state
    from udales_jax.config import BC_DRIVER
    ny, nz = 12, 8
    generate_synthetic_inflow(
        tmp_path / "driverdata.900.npz", ny, nz, 1.0, np.ones(nz),
        t_end=2.0, dt=0.1, u_mean=np.full(nz, 1.0),
        uu=np.full(nz, 0.01), vv=np.full(nz, 0.01), ww=np.full(nz, 0.005),
        uw=np.full(nz, -0.002), Tscale=0.5,
        thl_mean=np.full(nz, 288.0), qt_mean=np.zeros(nz))
    model = make_open_model()
    model.cfg = dataclasses.replace(
        model.cfg, bc=dataclasses.replace(model.cfg.bc, BCxm=BC_DRIVER,
                                          BCxT=BC_DRIVER, BCxq=BC_DRIVER,
                                          BCxs=BC_DRIVER))
    model.inlet = load_driver_inlet(tmp_path / "driverdata.900.npz",
                                    np.float64)
    s = open_state(model, amp=0.0)
    step = jax.jit(model.step)
    for _ in range(4):
        s = step(s)
    assert np.isfinite(np.asarray(s.c.u)).all()
    # inlet carries turbulent fluctuations
    assert float(jnp.std(s.c.u[0])) > 1e-4


def test_temperature_scalar_planes(tmp_path):
    """Temperature/moisture/scalar fluctuation planes: prescribed variance
    and w'th' flux reproduced (modSyntheticInflow.f90 temperature
    pathway), and the Fortran ?driver_* set is emitted alongside."""
    ny, nz = 24, 16
    dzf = np.ones(nz) * 0.5
    u_mean = np.full(nz, 1.0)
    ww = np.full(nz, 0.04)
    tt = np.full(nz, 0.09)
    wth = np.full(nz, -0.03)
    thl_mean = 290.0 + 0.1 * np.arange(nz)
    sv_mean = np.stack([np.full(nz, 5.0)])
    ss = np.stack([np.full(nz, 0.25)])
    fdir = tmp_path / "fortran"
    path = tmp_path / "driverdata.901.npz"
    generate_synthetic_inflow(
        path, ny, nz, 0.5, dzf, t_end=120.0, dt=0.25,
        u_mean=u_mean, uu=np.full(nz, 0.04), vv=np.full(nz, 0.04),
        ww=ww, uw=np.zeros(nz), Ly=1.0, Lz=1.0, Tscale=1.5,
        thl_mean=thl_mean, tt=tt, wth=wth,
        sv_mean=sv_mean, ss=ss,
        fortran_dir=fdir, expnr="901", seed=7)
    with np.load(path) as f:
        TH = f["thl"]
        W = f["w"][:, :, :nz]
        SV = f["sv"]
    thp = TH - TH.mean(axis=0)
    wp = W - W.mean(axis=0)
    # variance within 40% of target, flux right sign and order
    assert abs((thp ** 2).mean() / tt.mean() - 1.0) < 0.4
    flux = (thp * wp).mean()
    assert flux < 0 and abs(flux / wth.mean() - 1.0) < 0.5
    svp = SV[:, 0] - SV[:, 0].mean(axis=0)
    assert abs((svp ** 2).mean() / ss.mean() - 1.0) < 0.4
    assert np.allclose(TH.mean(axis=(0, 1)), thl_mean, atol=0.2)
    # Fortran set readable through the reference-format reader
    from udales_jax.io.driverfiles import read_driver_files
    d = read_driver_files(fdir, 901, ny, nz, nsv=1)
    assert d["u"].shape[0] == len(d["t"])
    np.testing.assert_allclose(d["thl"][0], TH[0], atol=1e-6)
    np.testing.assert_allclose(d["sv"][0, 0], SV[0, 0], atol=1e-6)
