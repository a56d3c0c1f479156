"""Benchmark harness: grid-points/s per GPU for full RK3 steps incl. Poisson.

Prints the device (platform, kind, count, card name and power limit), then
ONE JSON line {"metric":..., "value":..., "unit":..., "vs_baseline":...}
whose `value` is the URBAN case (IBM building array + wall functions +
heated facets — the framework's reason to exist); the flat 128^3 and 256^3
numbers ride along as `flat_128` / `flat_256` keys, and, where the
reference example tree is present, the 949 production precursor
(256x128x128 real-city STL) as `prec_949` and a driven full-size 950
replay segment (DriverStream + BCxm=3 inlet) as `replay_950`
(synthesizes full-size driver planes into .bench_cache on first use; set
UDALES_BENCH_NO_950=1 to skip it).  A failing case fails the run.

The run needs a GPU.  Baseline note (BASELINE.md): the Fortran/MPI
reference publishes no numbers and cannot be built in this environment (no
gfortran/MPI), so `vs_baseline` is computed against an ESTIMATE — 2.0M
grid-points/s/core, the published DALES-class single-core throughput for a
64^3 RK3 step on recent x86 (derivation in BASELINE.md "Estimate"
section).  The JSON line labels this explicitly via the `baseline` key.  A
second, *measured* comparator — this same solver jitted on the host CPU —
is the only CPU route: `UDALES_BENCH_CPU=1 python bench.py`, reported
under its own `_cpu_host` metric name.
"""
import json
import os
import time
from pathlib import Path

import numpy as np

# Estimated Fortran/MPI single-core throughput (NOT measured here — see
# BASELINE.md).  vs_baseline is therefore "vs-estimate".
FORTRAN_BASELINE_PTS_PER_S = 2.0e6

CACHE = Path(__file__).parent / ".bench_cache"


def _time_run(model, state, nsteps):
    """Best-of-3 of a lax.scan over nsteps (one dispatch for all steps,
    so the host-side dispatch cost does not enter the per-step time)."""
    import jax
    run = model.run_jit(nsteps)
    state = jax.block_until_ready(run(state))   # compile + warmup
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        state = jax.block_until_ready(run(state))
        best = min(best, time.perf_counter() - t0)
    n = model.grid.itot * model.grid.jtot * model.grid.ktot
    return n * nsteps / best


def measure_flat(n, nsteps):
    from udales_jax.cases import flat_model, flat_state
    model = flat_model(n, n, n)
    return _time_run(model, flat_state(model), nsteps)


def _stage_urban(n):
    """Prep-generate (once, cached) the n^3 urban case
    (udales_jax.cases.write_urban_case)."""
    case = CACHE / f"urban{n}v2"
    if not (case / "namoptions.900").exists():
        from udales_jax.cases import write_urban_case
        write_urban_case(case, n)
    return case


def measure_urban(n=128, nsteps=10):
    from udales_jax.run import load_case
    case = _stage_urban(n)
    model = load_case(case, "900", dtype="float32")
    state = model.cold_start(seed=43)
    return _time_run(model, state, nsteps), model


REF_EXAMPLES = Path("/root/reference/examples")


def measure_949(nsteps=30):
    """Production-scale comparator: the shipped 949 precursor
    (256x128x128, real-city STL, nfcts=22881), loaded from its committed
    inputs (examples/949/namoptions.949)."""
    from udales_jax.run import load_case
    model = load_case(REF_EXAMPLES / "949", "949", dtype="float32")
    state = model.cold_start(seed=43)
    return _time_run(model, state, nsteps)


def _stage_950_replay():
    """Copy examples/950 into the cache and synthesize full-size driver
    planes (the reference ships only tdriver times): a log-profile inlet
    plus deterministic perturbations, 120 records at dtdriver=1 s, written
    through the reference ?driver_* binary format (moddriver.f90
    writedriverfile:515)."""
    import shutil
    from udales_jax.io.driverfiles import write_driver_files
    case = CACHE / "replay950v2"
    nam = case / "namoptions.950"
    if nam.exists():
        return case
    case.mkdir(parents=True, exist_ok=True)
    src = REF_EXAMPLES / "950"
    for p in src.iterdir():
        if p.is_file():
            shutil.copy(p, case / p.name)
    jt = kt = 128
    nt = 120
    t = np.arange(nt, dtype=np.float64)
    rng = np.random.default_rng(7)
    z = (np.arange(kt) + 0.5) * (128.0 / kt)
    uprof = 0.4 / 0.41 * np.log(np.maximum(z, 0.06) / 0.05)
    base = np.broadcast_to(uprof[None, None, :], (nt, jt, kt))
    planes = {
        "u": (base + 0.05 * rng.standard_normal((nt, jt, kt))
              ).astype(np.float64),
        "v": 0.05 * rng.standard_normal((nt, jt, kt)),
        "w": 0.02 * rng.standard_normal((nt, jt, kt)),
        "thl": np.full((nt, jt, kt), 290.0),
        "e12": np.full((nt, jt, kt), 0.05),
    }
    write_driver_files(case, "950", t, planes, jt, kt)
    import re
    text = nam.read_text()
    for key, val in (("driverjobnr", "950"), ("driverstore", "24"),
                     ("lfielddump", ".false."), ("ltdump", ".false."),
                     ("lxytdump", ".false.")):
        text = re.sub(rf"^({key}\s*=\s*)\S+", rf"\g<1>{val}", text,
                      flags=re.M)
    text = text.replace("&DRIVER", "&DRIVER\nlchunkread = .true.\n"
                        "chunkread_size = 16", 1)
    nam.write_text(text)
    return case


def measure_950_replay(nsteps=20):
    """Driven full-size replay segment: DriverStream (lchunkread) window
    + BCxm=3 driver inlet + convective outflow."""
    import jax
    from udales_jax.run import load_case
    case = _stage_950_replay()
    model = load_case(case, "950", dtype="float32")
    assert model.driver_stream is not None
    state = model.cold_start(seed=43)
    state = model.driver_stream.ensure(state)
    run = model.run_jit(nsteps)
    state = jax.block_until_ready(run(state))
    best = float("inf")
    for _ in range(3):
        state = model.driver_stream.ensure(state)
        t0 = time.perf_counter()
        jax.block_until_ready(run(state))
        best = min(best, time.perf_counter() - t0)
    g = model.grid
    return g.itot * g.jtot * g.ktot * nsteps / best


def main():
    if os.environ.get("UDALES_BENCH_CPU"):
        # measured host-CPU comparator (same solver, XLA CPU backend)
        os.environ["JAX_PLATFORMS"] = "cpu"
        pts = measure_flat(n=64, nsteps=10)
        print(json.dumps({
            "metric": "rk3_step_grid_points_per_s_cpu_host",
            "value": round(pts, 1), "unit": "points/s",
            "baseline": "measured:this-solver-on-host-cpu-64^3",
        }))
        return
    from udales_jax.device import (card_name_and_power_limit, describe,
                                   enable_compile_cache, require_gpu)
    device = describe(require_gpu())
    print(f"device: {device}; card: {card_name_and_power_limit()}",
          flush=True)
    enable_compile_cache()
    urban, model = measure_urban(128, 50)
    out = {
        "metric": "rk3_step_urban_ibm_grid_points_per_s_per_gpu",
        "value": round(urban, 1),
        "unit": "points/s",
        "vs_baseline": round(urban / FORTRAN_BASELINE_PTS_PER_S, 2),
        "case": f"128^3, 4x4 building array lp=0.25, nfcts="
                f"{model.cfg.walls.nfcts}, wall fns + heated facets",
        "baseline": "estimate:fortran-mpi-2.0e6-pts/s/core (BASELINE.md; "
                    "reference unbuildable here — no gfortran/MPI)",
        "device": device,
        "flat_128": round(measure_flat(128, 50), 1),
        "flat_256": round(measure_flat(256, 20), 1),
    }
    if REF_EXAMPLES.exists():
        out["prec_949"] = round(measure_949(), 1)
        if not os.environ.get("UDALES_BENCH_NO_950"):
            out["replay_950"] = round(measure_950_replay(), 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
