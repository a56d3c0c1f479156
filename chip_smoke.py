"""Run the urban LES main path once on a GPU and check what comes out.

    python chip_smoke.py           # one card: every phase below but --four
    python chip_smoke.py --four    # four cards: only the sharded path

Phases, in one process (a second JAX process could not get the card's
memory):

  device    the GPU check (never carries on on the CPU); prints the card
  case      the 256^3 urban case (4x4 aligned cube array, lambda_p = 0.25,
            heated facets iwalltemp=2, Vreman SGS), generated with freshly
            compiled native prep libraries
  main run  udales_jax.sim.main on that case: >= 50 steps with a field
            dump, xy-time statistics and a restart; then the compile time,
            steady ms/step and memory of a Model.run scan
  numerics  the Poisson solve (uniform and stretched z, both matmul
            precisions), the post-projection divergence, one facet
            energy-balance update and the three diffusion sweeps, each
            against the same code in float64 on the CPU backend
  --four    the flat, IBM and driven-stream cases on a 2x2 mesh of four
            cards against the same case on one card, after 2 steps

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
A failed check raises, so the script then exits non-zero without it.
Cases and run outputs go to .chip_smoke/ beside this script.
"""
import argparse
import dataclasses
import json
import os
import shutil
import sys
import time
import types
from pathlib import Path

# the float64 references run on JAX's CPU backend in this same process
_plat = os.environ.get("JAX_PLATFORMS", "")
if _plat and "cpu" not in _plat.split(","):
    os.environ["JAX_PLATFORMS"] = _plat + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from udales_jax.device import (card_name_and_power_limit, describe,  # noqa: E402
                               enable_compile_cache, require_gpu)

OUT = Path(__file__).resolve().parent / ".chip_smoke"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
POISSON_RTOL = 1e-5            # relative L2 vs float64: f32 rounding over
                               # O(N) transform sums; TF32 / 1-pass bf16
                               # miss it by orders of magnitude
DIV_TOL = 1e-6                 # max |div u| [1/s], f32 level (~3e-7)
EB_TOL = 1e-4                  # facet temperature [K] after one update
DIFF_RTOL = 1e-5               # diffusion sweep, max err / max |ref|
FOUR_ULPS = 64                 # 4-card vs 1-card after 2 steps, u/v/w in
                               # float32 spacings at max|u|, thl at max|thl|
                               # (3.05e-5 K at 290 K): the same f32 sums in
                               # another order. A wrong halo is off by the
                               # steps' change, thousands of spacings


def log(msg):
    print(msg, flush=True)


def check(name, err, tol, precision):
    ok = bool(np.isfinite(err) and err <= tol)
    log(f"  {name}: err {err!r} tol {tol!r} precision {precision} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: {err!r} > {tol!r}")


def best_ms(fn, *args, reps=5):
    """Best of `reps` host-clock timings of fn(*args), warmed up."""
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def reference_context():
    """float64 on the CPU backend: the plain reference for every check."""
    from contextlib import ExitStack
    stack = ExitStack()
    stack.enter_context(jax.enable_x64(True))
    stack.enter_context(jax.default_device(jax.devices("cpu")[0]))
    return stack


# -- device ------------------------------------------------------------------

def phase_device():
    devs = require_gpu()
    import jaxlib
    log(f"device: {devs[0].device_kind} x{len(devs)}; jax {jax.__version__}"
        f" jaxlib {jaxlib.__version__}")
    log(f"card: {card_name_and_power_limit()}")
    return devs


# -- case --------------------------------------------------------------------

def phase_case(out: Path, n: int, runtime: float) -> Path:
    """Fresh native prep libraries, then the n^3 urban case with a field
    dump, xy-time statistics and one restart inside `runtime`."""
    from udales_jax.cases import write_urban_case
    from udales_jax.prep import native
    t0 = time.perf_counter()
    native.rebuild()
    t_native = time.perf_counter() - t0
    case = out / f"urban{n}"
    shutil.rmtree(case, ignore_errors=True)
    t0 = time.perf_counter()
    write_urban_case(
        case, n, run_extra=f"trestart = {0.6 * runtime}",
        sections=f"""&OUTPUT
lfielddump = .true.
tfielddump = {0.5 * runtime}
fieldvars = 'u0,v0,w0,th'
lxytdump = .true.
tsample = {0.1 * runtime}
tstatsdump = {0.5 * runtime}
/""")
    log(f"case: urban {n}^3 prepared in {time.perf_counter() - t0:.1f} s "
        f"(native libraries built in {t_native:.1f} s)")
    return case


# -- main run ------------------------------------------------------------------

def phase_main_run(case: Path, rundir: Path, runtime: float,
                   min_steps: int, scan_steps: int):
    """The CLI entry in this process, its outputs, then one compiled
    Model.run scan for compile time, ms/step and memory."""
    from scipy.io import netcdf_file
    from udales_jax import sim
    from udales_jax.run import load_case
    shutil.rmtree(rundir, ignore_errors=True)
    t0 = time.perf_counter()
    final = sim.main([str(case), "--outdir", str(rundir),
                      "--runtime", str(runtime)])
    wall = time.perf_counter() - t0
    nsteps = len(np.loadtxt(rundir / "monitor.900.txt", ndmin=2))
    log(f"main run: {nsteps} steps to t={float(final.timee)!r} s in "
        f"{wall:.1f} s wall (compile included)")
    if nsteps < min_steps:
        raise AssertionError(f"only {nsteps} steps (< {min_steps})")
    restarts = sorted(rundir.glob("initd*.900.npz"))
    for p in [rundir / "fielddump.900.nc", rundir / "xytdump.900.nc",
              *restarts[:1]]:
        if not p.exists():
            raise AssertionError(f"missing output {p.name}")
    if not restarts:
        raise AssertionError("no restart written")
    with netcdf_file(str(rundir / "fielddump.900.nc"), "r",
                     mmap=False) as f:
        for name in ("u", "v", "w", "thl"):
            if not np.isfinite(f.variables[name][:]).all():
                raise AssertionError(f"fielddump {name} not finite")
    with np.load(restarts[-1]) as f:
        if not np.isfinite(f["c/u"]).all():
            raise AssertionError("restart c/u not finite")
    for name in ("u", "v", "w", "thl"):
        a = np.asarray(getattr(final.c, name))
        if not np.isfinite(a).all():
            raise AssertionError(f"final {name} not finite")
    umax = float(np.abs(np.asarray(final.c.u)).max())
    log(f"  outputs ok: fielddump, xytdump, {len(restarts)} restart(s); "
        f"umax {umax!r} m/s (bound 20)")
    if umax > 20.0:
        raise AssertionError(f"umax {umax} unbounded")

    model = load_case(case, "900")
    t0 = time.perf_counter()
    lowered, args = model.run_jit(scan_steps).lower(final)
    compiled = lowered.compile()
    log(f"  scan of {scan_steps} steps: compile {time.perf_counter() - t0:.1f}"
        f" s")
    mem = compiled.memory_analysis()
    if mem is not None:
        log("  memory_analysis: " + ", ".join(
            f"{k} {getattr(mem, k)}" for k in
            ("argument_size_in_bytes", "output_size_in_bytes",
             "temp_size_in_bytes", "generated_code_size_in_bytes")))
    ms = best_ms(compiled, *args, reps=3) / scan_steps
    stats = jax.devices()[0].memory_stats() or {}
    n3 = model.grid.itot * model.grid.jtot * model.grid.ktot
    log(f"  steady {ms!r} ms/step ({n3 / ms * 1e3!r} grid points/s); "
        f"peak_bytes_in_use {stats.get('peak_bytes_in_use', 'n/a')}")
    return model, final


# -- numerics --------------------------------------------------------------------

def _poisson_grids(n, dtype, stretched):
    from udales_jax.config import Config, DomainConfig
    from udales_jax.grid import Grid
    from udales_jax.prep.zgrid import zgrid_centers
    cfg = Config(domain=DomainConfig(itot=n, jtot=n, ktot=n, xlen=float(n),
                                     ylen=float(n)))
    zf = zgrid_centers(n, float(n), lzstretch=stretched)
    return cfg, Grid(n, n, n, float(n), float(n), zf, dtype=dtype)


def phase_poisson(n: int):
    """Both z paths (uniform: the diagonal DCT-z path; stretched: the
    associative-scan tridiagonal solve) at both matmul precisions, each
    error the worse of two random right-hand sides; the platform table's
    choice must meet the tolerance."""
    from udales_jax.ops import poisson
    from udales_jax.run import HoistedJit
    chosen = os.environ.get("UDALES_POIS_PREC") or \
        poisson._PRECISION_BY_PLATFORM[jax.default_backend()]
    rhss = [np.random.default_rng(seed).standard_normal((n, n, n))
            for seed in (0, 1)]
    # both solves close over their per-wavenumber recurrence coefficients:
    # HoistedJit passes them in, where a plain jit folds them and the
    # scan's partial products into the program (84 MB of constants at
    # 128^3 in float64, stretched z)
    for stretched in (False, True):
        with reference_context():
            cfg, g64 = _poisson_grids(n, np.float64, stretched)
            solve64 = HoistedJit(poisson.PoissonSolver(g64, cfg).solve)
            refs = [np.asarray(solve64(jnp.asarray(r))) for r in rhss]
        cfg, g32 = _poisson_grids(n, np.float32, stretched)
        solver = poisson.PoissonSolver(g32, cfg)
        path = "tridiagonal scan" if stretched else "diagonal DCT-z"
        assert solver.diag_z != stretched
        xs = [jnp.asarray(r, jnp.float32) for r in rhss]
        saved = os.environ.get("UDALES_POIS_PREC")
        try:
            for prec in ("highest", "x3"):
                os.environ["UDALES_POIS_PREC"] = prec
                solve = HoistedJit(solver.solve)
                ms = best_ms(solve, xs[0])
                err = max(
                    float(np.linalg.norm(np.asarray(solve(x), np.float64)
                                         - ref) / np.linalg.norm(ref))
                    for x, ref in zip(xs, refs))
                name = f"poisson {n}^3 {path} [{ms!r} ms/solve]"
                if prec == chosen:
                    check(name, err, POISSON_RTOL, prec)
                else:
                    log(f"  {name}: err {err!r} tol {POISSON_RTOL!r} "
                        f"precision {prec} (not the platform's choice)")
        finally:
            if saved is None:
                os.environ.pop("UDALES_POIS_PREC", None)
            else:
                os.environ["UDALES_POIS_PREC"] = saved


def phase_divergence(model, state):
    """max |div u| over fluid cells of the post-projection state, taken in
    float64 from the float32 fields."""
    g = model.grid
    u, v, w = (np.asarray(getattr(state.c, k), np.float64)
               for k in ("u", "v", "w"))
    gu = np.concatenate([u, u[:1]], axis=0)
    gv = np.concatenate([v, v[:, :1]], axis=1)
    div = ((gu[1:] - gu[:-1]) * g.dxi + (gv[:, 1:] - gv[:, :-1]) * g.dyi
           + (w[:, :, 1:] - w[:, :, :-1]) / g.dzf[None, None, :])
    fluid = np.asarray(model.ibm.masks.c) > 0.5
    check(f"max|div| urban {g.itot}^3", float(np.abs(div[fluid]).max()),
          DIV_TOL, "float32 state, float64 divergence")


def phase_eb(out: Path, n: int):
    """One facet energy-balance update with the dense view-factor product
    on an n^3 urban case prepared with radiation."""
    from udales_jax.cases import write_urban_case
    from udales_jax.ibm.eb import FacetEB
    from udales_jax.run import load_case
    case = write_urban_case(out / f"urban{n}_eb", n, with_radiation=True,
                            sections="""&ENERGYBALANCE
lEB = .true.
lvfsparse = .true.
dtEB = 10.
skyLW = 350.
/""")
    model = load_case(case, "900")
    eb32 = model.eb
    nf = eb32.nfcts
    i, j, val = eb32.vf_sparse
    vf = np.zeros((nf, nf))
    vf[i, j] = val
    rng = np.random.default_rng(1)
    faca = np.asarray(eb32.faca, np.float64)
    dtEB = model.cfg.eb.dtEB
    fluxes = dict(hfi=0.05 * rng.uniform(-1, 1, nf) * faca * dtEB,
                  efi=np.zeros(nf))

    def run(eb, dtype):
        eb.vf = jnp.asarray(vf, dtype)
        fs = dataclasses.replace(
            eb.initial_state(), dense=None,
            **{k: jnp.asarray(v, dtype) for k, v in fluxes.items()})
        return np.asarray(jax.jit(eb.update)(fs, jnp.asarray(dtEB, dtype)).T)

    T32 = run(eb32, jnp.float32)
    with reference_context():
        ibm_host = types.SimpleNamespace(
            nfcts=nf, facnorm=np.asarray(model.ibm.facnorm),
            faca=np.asarray(model.ibm.faca))
        eb64 = FacetEB.load(case, "900", model.cfg, ibm_host,
                            dtype=np.float64)
        eb64.ibm = None     # no dense surface stacks in the reference
        T64 = run(eb64, jnp.float64)
    check(f"facet EB update, {nf} facets, urban {n}^3",
          float(np.abs(T32 - T64).max()), EB_TOL, "highest")


def phase_diffusion(n: int):
    """The three momentum-diffusion sweeps (plain XLA) at n^3: time and
    effective bytes/s, and the error against float64."""
    from udales_jax.grid import Grid
    from udales_jax.ops import subgrid as sgs
    rng = np.random.default_rng(2)
    m = n + 2
    host = dict(u=rng.standard_normal((m, m, m)),
                v=rng.standard_normal((m, m, m)),
                w=rng.standard_normal((m, m, n + 1)),
                ekm=rng.uniform(0.5, 1.5, (m, m, m)))

    def sweep(k, dtype):
        grid = Grid.uniform(n, n, n, float(n), float(n), float(n),
                            dtype=dtype)
        fn = getattr(sgs, f"diff_{k}")
        return jax.jit(lambda a: fn(types.SimpleNamespace(**a), grid))

    g = {k: jnp.asarray(a, jnp.float32) for k, a in host.items()}
    with reference_context():
        g64 = {k: jnp.asarray(a) for k, a in host.items()}
        refs = {k: np.asarray(sweep(k, np.float64)(g64)) for k in "uvw"}
    read = 4 * sum(a.size for a in host.values())
    for k in "uvw":
        fn = sweep(k, np.float32)
        ms = best_ms(fn, g)
        out = np.asarray(fn(g), np.float64)
        nbytes = read + 4 * out.size
        log(f"  diff_{k} {n}^3: {ms!r} ms, {nbytes / ms / 1e9!r} TB/s "
            f"effective ({nbytes / ms / 1e9 / (HBM_BYTES_PER_S / 1e12)!r} "
            f"of {HBM_BYTES_PER_S / 1e12} TB/s)")
        err = float(np.abs(out - refs[k]).max() / np.abs(refs[k]).max())
        check(f"diff_{k} {n}^3", err, DIFF_RTOL, "float32 elementwise")


# -- --four --------------------------------------------------------------------

def phase_four(out: Path, n: int, nsteps: int = 2):
    """Flat, IBM and driven-stream cases on a 2x2 mesh against one card."""
    from udales_jax.cases import (flat_model, flat_state, write_driven_case,
                                  write_ibm_case)
    from udales_jax.parallel.mesh import make_mesh, shard_state
    from udales_jax.run import load_case
    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 devices, found "
                           f"{len(jax.devices())}")
    mesh = make_mesh(2, 2)
    ibm_case = write_ibm_case(out / f"four_ibm{n}", n)
    drv_case = write_driven_case(out / f"four_drv{n}", n)
    cases = {
        "flat": (lambda: flat_model(n, n, n), flat_state),
        "ibm": (lambda: load_case(ibm_case, "902"),
                lambda m: m.cold_start(seed=1)),
        "driven": (lambda: load_case(drv_case, "903"),
                   lambda m: m.driver_stream.ensure(m.cold_start(seed=2))),
    }
    def advance(model, step, state):
        for _ in range(nsteps):
            if model.driver_stream is not None:
                state = model.driver_stream.ensure(state)
            state = step(state)
        return jax.block_until_ready(state)

    fields = ("u", "v", "w", "thl")
    for name, (build, init) in cases.items():
        results = []
        for sharded in (False, True):
            model = build()
            state0 = init(model)
            if sharded:
                model.mesh = model.pois.mesh = mesh
                state0 = shard_state(state0, mesh)
            step = model.step_jit()
            t0 = time.perf_counter()
            state = advance(model, step, state0)
            t1 = time.perf_counter()
            advance(model, step, state)
            log(f"  {name} {n}^3 {'2x2 mesh' if sharded else '1 device'}:"
                f" {nsteps} steps in {t1 - t0:.1f} s (compile included), "
                f"then {1e3 * (time.perf_counter() - t1) / nsteps!r} "
                f"ms/step (host clock, {nsteps} steps)")
            results.append(state)
        ref, got = results
        if len(got.c.u.sharding.device_set) != 4:
            raise AssertionError(f"{name}: the 2x2-mesh result is not "
                                 f"spread over 4 devices")
        # velocities in float32 spacings at the flow speed max|u|, thl at
        # max|thl|, beside how far the 2 steps moved each in the same unit
        x0 = {k: np.asarray(getattr(state0.c, k)) for k in fields}
        a = {k: np.asarray(getattr(ref.c, k)) for k in fields}
        ulp = {k: float(np.spacing(np.float32(
            np.abs(a["thl" if k == "thl" else "u"]).max()))) for k in fields}
        diff = {k: float(np.abs(np.asarray(getattr(got.c, k)) - a[k]).max())
                / ulp[k] for k in fields}
        moved = {k: float(np.abs(a[k] - x0[k]).max()) / ulp[k]
                 for k in fields}
        log(f"  {name} difference in float32 spacings: {diff}; "
            f"change over the {nsteps} steps: {moved}")
        check(f"{name} {n}^3 4-device vs 1-device (u, v, w, thl)",
              max(diff.values()), FOUR_ULPS, "float32, in spacings")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four cards")
    args = ap.parse_args(argv)
    devs = phase_device()
    OUT.mkdir(exist_ok=True)
    log(f"compile cache: {enable_compile_cache()}")
    if args.four:
        phase_four(OUT, 128)
    else:
        runtime = 30.0    # dt <= dtmax = 0.5 s, so >= 60 steps
        case = phase_case(OUT, 256, runtime)
        model, final = phase_main_run(case, OUT / "run", runtime,
                                      min_steps=50, scan_steps=20)
        log("numerics (float32 on the card vs float64 on the CPU backend):")
        phase_divergence(model, final)
        phase_poisson(256)
        phase_eb(OUT, 128)
        phase_diffusion(256)
    print(json.dumps({"ok": True, "device": describe(devs)}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
