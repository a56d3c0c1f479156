"""Sharding-invariance for the HARD cases: IBM wall functions, facet EB,
open boundaries, and the rescale-recycle inlet generator — the states with
hand-written partition specs in parallel/mesh.py that the flat periodic
test (test_sharding.py) never exercises.

Oracle: one (or several) full RK3 step(s) on a single device must equal
the same step on a 2x2 device mesh to 1e-9 in f64 — the analogue of the
reference's processor-boundary tests
(tests/integration/processor_boundaries/test_processor_boundaries.py:28-120)
run on the decompositions {1x1, 2x2}.
"""
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest

from udales_jax.parallel.mesh import make_mesh, shard_state
from udales_jax.prep.prep import PrepConfig, prepare_case
from udales_jax.prep.prep import make_box_stl


NAM_TEMPLATE = """
&RUN
iexpnr = 901
runtime = 1.
ladaptive = .true.
dtmax = 0.1
/
&DOMAIN
itot = 16
jtot = 16
ktot = 16
xlen = 16.
ylen = 16.
/
&PHYSICS
ltempeq = .true.
lbuoyancy = .true.
/
&WALLS
{walls}
iwalltemp = 2
/
&BC
thls = 290.
z0 = 0.05
z0h = 0.00035
{bc_extra}
/
{extra}
"""


def _stage_cube_case(tmp, bc_extra="", extra="", with_radiation=True):
    stl = tmp / "geom.stl"
    make_box_stl(stl, 6, 10, 6, 10, 4, 16.0, 16.0)
    cfg = PrepConfig(itot=16, jtot=16, ktot=16, xlen=16.0, ylen=16.0,
                     zsize=16.0, expnr="901", u0=1.0, dpdx=1e-4,
                     with_radiation=with_radiation, vf_subdiv=1)
    counts = prepare_case(stl, tmp, cfg)
    walls = "\n".join(
        [f"nfcts = {counts['nfcts']}"]
        + [f"nsolpts_{w} = {counts[f'nsolpts_{w}']}" for w in "uvwc"]
        + [f"nbndpts_{w} = {counts[f'nbndpts_{w}']}" for w in "uvwc"]
        + [f"nfctsecs_{w} = {counts[f'nfctsecs_{w}']}" for w in "uvwc"])
    (tmp / "namoptions.901").write_text(
        NAM_TEMPLATE.format(walls=walls, bc_extra=bc_extra, extra=extra))
    return tmp


def _load(case_dir):
    from udales_jax.run import load_case
    return load_case(case_dir, "901", dtype="float64")


def _compare_states(ref, out, leaves=("u", "v", "w", "thl", "e12"),
                    atol=1e-9, label=""):
    for name in leaves:
        a = np.asarray(getattr(ref.c, name))
        b = np.asarray(getattr(out.c, name))
        np.testing.assert_allclose(b, a, atol=atol, rtol=atol,
                                   err_msg=f"{label}:{name}")


def _run_pair(model_fn, nsteps=2, state_fn=None, extra_check=None):
    """Run nsteps on 1 device and on a 2x2 mesh; compare all field
    leaves."""
    model = model_fn()
    state = (state_fn or (lambda m: m.cold_start(seed=1)))(model)
    step = jax.jit(model.step)
    ref = state
    for _ in range(nsteps):
        ref = step(ref)

    mesh = make_mesh(2, 2)
    smodel = model_fn()
    smodel.mesh = mesh
    smodel.pois.mesh = mesh
    sstate = shard_state(state, mesh)
    sstep = jax.jit(smodel.step)
    out = sstate
    for _ in range(nsteps):
        out = sstep(out)
    _compare_states(ref, out)
    if extra_check is not None:
        extra_check(ref, out)
    return ref, out


@pytest.fixture(scope="module")
def cube_case(tmp_path_factory):
    return _stage_cube_case(tmp_path_factory.mktemp("cube"))


class TestIBMSharding:
    def test_ibm_wallfun_invariance(self, cube_case):
        """IBM: dense-slot wall functions, masks, ibmnorm, diff
        corrections under a 2x2 mesh."""
        _run_pair(lambda: _load(cube_case))

    def test_ibm_facet_fluxes_invariance(self, cube_case):
        """Facet-flux accumulators (State.facstats is populated when
        lwritefac; here the per-step tau diagnostics) must also match."""
        ref, out = _run_pair(lambda: _load(cube_case), nsteps=3)
        np.testing.assert_allclose(np.asarray(out.pres),
                                   np.asarray(ref.pres), atol=1e-9)

    def test_ibm_tail_invariance(self, cube_case, monkeypatch):
        """The K-cap sparse tail (gather + scatter wall functions for
        deep-slot sections, ibm/ibm.py) under a mesh: forcing KCAP=1
        routes every beyond-first-slot section through the tail."""
        monkeypatch.setenv("UDALES_IBM_KCAP", "1")
        def build():
            m = _load(cube_case)
            assert any(dn is not None and "_tail" in dn
                       for dn in m.ibm.dense.values())
            return m
        _run_pair(build)


class TestEBSharding:
    def test_facet_eb_invariance(self, tmp_path):
        """Facet energy balance (radiosity + conduction + dense surface
        stacks) under a mesh: State.fac leaves must match exactly."""
        case = _stage_cube_case(
            tmp_path,
            extra="""
&ENERGYBALANCE
lEB = .true.
lvfsparse = .true.
dtEB = 0.2
skyLW = 350.
nfaclyrs = 3
/
""")
        def check_fac(ref, out):
            assert ref.fac is not None and out.fac is not None
            np.testing.assert_allclose(np.asarray(out.fac.T),
                                       np.asarray(ref.fac.T), atol=1e-9)
            np.testing.assert_allclose(np.asarray(out.fac.hfi),
                                       np.asarray(ref.fac.hfi), atol=1e-8)
        _run_pair(lambda: _load(case), nsteps=3, extra_check=check_fac)


class TestOpenBCSharding:
    def test_open_x_profile_invariance(self, tmp_path):
        """Open x (profile inlet + convective outlet): the bx plane state
        (P(None,'y',...) specs) must stay shard-invariant."""
        case = _stage_cube_case(tmp_path, bc_extra="BCxm = 2\nBCxs = 2")
        def check_bx(ref, out):
            for name in ("u", "v", "w", "thl", "e12"):
                a = np.asarray(getattr(ref.c.bx, name))
                b = np.asarray(getattr(out.c.bx, name))
                np.testing.assert_allclose(b, a, atol=1e-9,
                                           err_msg=f"bx:{name}")
        _run_pair(lambda: _load(case), nsteps=2, extra_check=check_bx)


class TestInletGenSharding:
    def test_inletgen_state_invariance(self):
        """Rescale-recycle generator (State.ig: y-z planes P('y',None),
        Utav P('x',None)) under a mesh — programmatic model build, f64
        (the pattern of test_inletgen._build_model)."""
        import jax.numpy as jnp
        from udales_jax.config import (BCConfig, Config, DomainConfig,
                                       DriverConfig, PhysicsConfig,
                                       RunConfig, const)
        from udales_jax.grid import Grid
        from udales_jax.ops import inletgen as ig
        from udales_jax.ops.openbc import BC_RECYCLE, Inlet, init_xplanes
        from udales_jax.run import Model
        from udales_jax.state import (initial_state, profile_fields,
                                      randomize)

        n, nz = 16, 16

        def build():
            cfg = Config(
                domain=DomainConfig(itot=n, jtot=n, ktot=nz, xlen=float(n),
                                    ylen=float(n)),
                run=RunConfig(ladaptive=False, dtmax=0.02,
                              lrandomize=False),
                physics=PhysicsConfig(ltempeq=True, inletav=5.0),
                bc=BCConfig(Uinf=2.0, thls=288.0, thl_top=290.0, z0=0.03,
                            z0h=0.003),
                driver=DriverConfig(iinletgen=1, iplane=n - 4,
                                    di=float(nz) / 2, dti=float(nz) / 2),
                dtype="float64")
            grid = Grid.uniform(n, n, nz, float(n), float(n), float(nz),
                                dtype=np.float64)
            model = Model(cfg, grid)
            j = lambda a: jnp.asarray(a, np.float64)
            zf = np.asarray(grid.zf)
            uprof = 2.0 * np.minimum(zf / (0.8 * zf[-1]), 1.0) ** 0.25
            thlprof = 288.0 + 2.0 * zf / zf[-1]
            model.inlet = Inlet(
                mode=BC_RECYCLE, uprof=j(uprof), vprof=j(np.zeros(nz)),
                thlprof=j(thlprof), qtprof=j(np.zeros(nz)),
                e12prof=j(np.full(nz, const.e12min)),
                svprof=jnp.zeros((0, nz), np.float64), irecy=n - 4)
            model.igparams = ig.InletGenParams(cfg, grid)
            return model, uprof, thlprof

        model, uprof, thlprof = build()
        grid = model.grid
        f = profile_fields(grid, uprof, np.zeros(nz), thlprof,
                           np.zeros(nz), np.full(nz, const.e12min))
        f = randomize(f, jax.random.PRNGKey(5), 0.05, nz)
        f = dataclasses.replace(f, bx=init_xplanes(f, grid))
        state = initial_state(grid, f, dt0=0.02)
        state = state.replace(ig=ig.init_inletgen(model.cfg, grid, f,
                                                  model.igparams))

        ref = state
        step = jax.jit(model.step)
        for _ in range(2):
            ref = step(ref)

        mesh = make_mesh(2, 2)
        smodel, _, _ = build()
        smodel.mesh = mesh
        smodel.pois.mesh = mesh
        sstate = shard_state(state, mesh)
        sstep = jax.jit(smodel.step)
        out = sstate
        for _ in range(2):
            out = sstep(out)
        _compare_states(ref, out, atol=1e-9)
        assert ref.ig is not None and out.ig is not None
        for name in ("u0", "v0", "w0", "t0", "Utav"):
            a = np.asarray(getattr(ref.ig, name))
            b = np.asarray(getattr(out.ig, name))
            np.testing.assert_allclose(b, a, atol=1e-9,
                                       err_msg=f"ig:{name}")
