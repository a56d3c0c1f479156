"""Generated cases, built from parameters alone (nothing is downloaded).

- `flat_model` / `flat_state`: the periodic neutral ABL over a rough floor.
- `write_urban_case`: the urban canopy the benchmark and the chip smoke
  test step — a 4x4 aligned cube array (lambda_p = 0.25, H = n/4 m),
  heated facets (iwalltemp=2), Vreman SGS.
- `write_ibm_case` / `write_driven_case`: one box building, and a
  precursor series replayed through the chunked driver window into an
  open-x inlet (the three cases of the multi-device dry run).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def flat_model(itot, jtot, ktot, dtype="float32", ladaptive=True):
    import jax.numpy as jnp
    from .config import (BCConfig, Config, DomainConfig, RunConfig,
                         WallsConfig)
    from .grid import Grid
    from .run import Model
    cfg = Config(
        domain=DomainConfig(itot=itot, jtot=jtot, ktot=ktot,
                            xlen=float(itot), ylen=float(jtot)),
        run=RunConfig(ladaptive=ladaptive, dtmax=0.5),
        walls=WallsConfig(lbottom=True),
        bc=BCConfig(z0=0.03, z0h=0.003, thls=288.0),
        dtype=dtype,
    )
    np_dt = np.float32 if dtype == "float32" else np.float64
    grid = Grid.uniform(itot, jtot, ktot, float(itot), float(jtot),
                        float(ktot), dtype=np_dt)
    model = Model(cfg, grid)
    model.dpdxl = jnp.full(ktot, -1e-4, np_dt)
    return model


def flat_state(model, seed=43, amp=0.05):
    import jax
    from .state import initial_state, profile_fields, randomize
    nz = model.grid.ktot
    f = profile_fields(model.grid, np.full(nz, 1.0), np.zeros(nz),
                       np.full(nz, 288.0), np.zeros(nz), np.full(nz, 5e-5))
    f = randomize(f, jax.random.PRNGKey(seed), amp, nz // 2)
    return initial_state(model.grid, f, dt0=0.1)


def walls_namelist(counts: dict) -> str:
    """The &WALLS count lines for the counts `prepare_case` returns."""
    return "\n".join(
        [f"nfcts = {counts['nfcts']}"]
        + [f"nsolpts_{w} = {counts[f'nsolpts_{w}']}" for w in "uvwc"]
        + [f"nbndpts_{w} = {counts[f'nbndpts_{w}']}" for w in "uvwc"]
        + [f"nfctsecs_{w} = {counts[f'nfctsecs_{w}']}" for w in "uvwc"])


def write_urban_case(case: str | Path, n: int, run_extra: str = "",
                     sections: str = "", with_radiation: bool = False):
    """Prep-generate the n^3 urban case (experiment 900) into `case`:
    canonical aligned-array generator (udgeom create_cubes 'AC'), 4x4
    cubes, lambda_p = 0.25, H = n/4.  `run_extra` adds lines to &RUN;
    `sections` appends whole namelist groups (&OUTPUT, &ENERGYBALANCE)."""
    from .prep.prep import PrepConfig, prepare_case
    from .prep.udgeom import create_cubes
    case = Path(case)
    case.mkdir(parents=True, exist_ok=True)
    pitch = n / 4.0
    create_cubes(float(n), float(n), pitch / 2, pitch / 2, pitch,
                 pitch / 2, pitch / 2, "AC",
                 edgelength=pitch / 2).save(case / "geom.stl")
    counts = prepare_case(case / "geom.stl", case, PrepConfig(
        itot=n, jtot=n, ktot=n, xlen=float(n), ylen=float(n),
        zsize=float(n), expnr="900", u0=1.5, thl0=290.0, facT0=295.0,
        with_radiation=with_radiation))
    (case / "namoptions.900").write_text(f"""&RUN
iexpnr = 900
ladaptive = .true.
dtmax = 0.5
libm = .true.
{run_extra}
/
&DOMAIN
itot = {n}
jtot = {n}
ktot = {n}
xlen = {n}.
ylen = {n}.
/
&PHYSICS
ltempeq = .true.
lbuoyancy = .true.
luvolflowr = .true.
uflowrate = 1.5
/
&WALLS
{walls_namelist(counts)}
iwalltemp = 2
/
&BC
thls = 295.
thl_top = 285.
BCtopT = 2
z0 = 0.05
z0h = 0.00035
/
&NAMSUBGRID
lvreman = .true.
/
{sections}
""")
    return case


def write_ibm_case(case: str | Path, n: int):
    """One box building on an n^3 grid (experiment 902): dense-slot wall
    functions, masks and facet sections."""
    from .prep.prep import PrepConfig, make_box_stl, prepare_case
    case = Path(case)
    case.mkdir(parents=True, exist_ok=True)
    make_box_stl(case / "geom.stl", n // 4, n // 2, n // 4, n // 2, n // 4,
                 float(n), float(n))
    counts = prepare_case(case / "geom.stl", case, PrepConfig(
        itot=n, jtot=n, ktot=n, xlen=float(n), ylen=float(n),
        zsize=float(n), expnr="902", u0=1.0, dpdx=1e-4,
        with_radiation=False))
    (case / "namoptions.902").write_text(f"""
&RUN
iexpnr = 902
ladaptive = .true.
dtmax = 0.1
/
&DOMAIN
itot = {n}
jtot = {n}
ktot = {n}
xlen = {n}.
ylen = {n}.
/
&PHYSICS
ltempeq = .true.
lbuoyancy = .true.
/
&WALLS
{walls_namelist(counts)}
iwalltemp = 2
/
&BC
thls = 290.
z0 = 0.05
z0h = 0.00035
/
""")
    return case


def write_driven_case(case: str | Path, n: int, nt: int = 24):
    """A precursor series of `nt` y-z planes (written in the reference's
    ?driver_* format) replayed through the lchunkread window into a
    BCxm=3 driver inlet + convective outlet, n^3 (experiment 903)."""
    from .io.driverfiles import write_driver_files
    case = Path(case)
    case.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(5)
    t = np.arange(nt) * 0.05
    base = 1.0 + 0.1 * np.sin(np.arange(n) / 3.0)
    mk = lambda a: (a + 0.01 * rng.standard_normal((nt, n, n))
                    ).astype(np.float64)
    planes = dict(u=mk(base[None, :, None]), v=mk(0.0),
                  w=np.concatenate([np.zeros((nt, n, 1)), mk(0.0)], axis=2),
                  thl=mk(288.0))
    write_driver_files(case, "903", t, planes, n, n)
    zc = (np.arange(n) + 0.5) * 1.0
    prof = np.column_stack([zc, np.full(n, 288.0), np.zeros(n),
                            np.full(n, 1.0), np.zeros(n), np.full(n, 5e-5)])
    with open(case / "prof.inp.903", "w") as f:
        f.write("# profiles\n# z thl qt u v tke\n")
        np.savetxt(f, prof, fmt="%14.6e")
    ls = np.column_stack([zc] + [np.zeros(n)] * 9)
    with open(case / "lscale.inp.903", "w") as f:
        f.write("# lscale\n"
                "# z uq vq pqx pqy wfls dqtdxls dqtdyls dqtdtls dthl\n")
        np.savetxt(f, ls, fmt="%14.6e")
    (case / "namoptions.903").write_text(f"""
&RUN
iexpnr = 903
ladaptive = .true.
dtmax = 0.05
runtime = 1.0
/
&DOMAIN
itot = {n}
jtot = {n}
ktot = {n}
xlen = {n}.
ylen = {n}.
/
&BC
BCxm = 3
/
&DRIVER
idriver = 2
driverjobnr = 903
tdriverstart = 0.
lchunkread = .true.
chunkread_size = 8
/
""")
    return case
