"""CLI: regenerate a case's preprocessed inputs from its own namoptions.

    python -m udales_jax.prep <case_dir> [--expnr N] [--out DIR]
    python -m udales_jax.prep <case_dir> --harmonie-ssrd ssrd.txt \
        [--harmonie-strd strd.txt]

Equivalent of the reference's udprep entry point (tools/python/udprep):
parses the &INPS group from the case's namoptions and runs the full IBM /
radiation / vegetation / scalar preprocessing chain.  With
--harmonie-ssrd, additionally generates timedepsw.inp (and with
--harmonie-strd, timedeplw.inp) from accumulated HARMONIE surface
radiation tables (`offset_seconds accumulated_J_m2` rows; the GRIB->table
conversion is host-side tooling, prep/harmonie.py)."""
from __future__ import annotations

import argparse
from pathlib import Path


def _harmonie(args, case_dir: Path, outdir: Path, expnr: str):
    from datetime import datetime

    import numpy as np

    from ..config import parse_namelists
    from . import harmonie as hm
    from .stl import read_stl

    nml = parse_namelists((case_dir / f"namoptions.{expnr}").read_text())
    eb = {**nml.get("ENERGYBALANCE", {}), **nml.get("INPS", {})}
    run = nml.get("RUN", {})
    start = datetime(int(eb.get("year", 2023)), int(eb.get("month", 6)),
                     int(eb.get("day", 21)), int(eb.get("hour", 12)),
                     int(eb.get("minute", 0)), int(eb.get("second", 0)))
    lat = float(eb.get("latitude", 52.0))
    lon = float(eb.get("longitude", 0.0))
    tz = float(eb.get("timezone", 0.0))
    xaz = float(eb.get("xazimuth", 90.0))
    runtime = float(run.get("runtime", 3600.0))
    dtsp = float(eb.get("dtsp", eb.get("dtSP", 600.0)))

    off, acc = hm.read_accumulated_table(args.harmonie_ssrd)
    stl = eb.get("stl_file")
    tris = normals = None
    if stl and (case_dir / str(stl)).exists():
        tris, normals = read_stl(case_dir / str(stl))
    if tris is not None and len(tris):
        times, sdir, knet, atmos = hm.generate_timedepsw_from_harmonie(
            tris, normals, off, acc, start, runtime, dtsp, lat, lon, tz,
            xaz, outpath=outdir, expnr=expnr)
        print(f"timedepsw.inp.{expnr}: {len(times)} samples x "
              f"{knet.shape[1]} facets, GHI max {atmos.ghi.max():.1f} W/m2")
    else:
        atmos = hm.harmonie_shortwave_atmosphere(
            off, acc, start, runtime, dtsp, lat, lon, tz, xaz)
        hm.write_weather_table(outdir / f"weather.harmonie.{expnr}", atmos,
                               start)
        print(f"weather.harmonie.{expnr}: {atmos.times.size} samples "
              f"(no STL geometry; facet mapping skipped)")
    if args.harmonie_strd:
        off, acc = hm.read_accumulated_table(args.harmonie_strd)
        ntlw = int(eb.get("ntimedeplw", max(2, int(runtime // 3600) + 1)))
        t, lw = hm.harmonie_longwave_series(off, acc, runtime, ntlw)
        hm.write_timedeplw(outdir / f"timedeplw.inp.{expnr}", t, lw)
        print(f"timedeplw.inp.{expnr}: LWsky "
              f"{np.min(lw):.1f}..{np.max(lw):.1f} W/m2")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="udales_jax.prep", description=__doc__)
    ap.add_argument("case_dir", help="case directory with namoptions.<expnr>")
    ap.add_argument("--expnr", default=None, help="experiment number "
                    "(default: from the first namoptions.* found)")
    ap.add_argument("--out", default=None, help="output directory "
                    "(default: the case directory itself)")
    ap.add_argument("--harmonie-ssrd", default=None, metavar="TABLE",
                    help="accumulated HARMONIE ssrd table -> timedepsw.inp")
    ap.add_argument("--harmonie-strd", default=None, metavar="TABLE",
                    help="accumulated HARMONIE strd table -> timedeplw.inp")
    ap.add_argument("--skip-inps", action="store_true",
                    help="only run the HARMONIE coupling, not the &INPS "
                    "chain")
    args = ap.parse_args(argv)
    case_dir = Path(args.case_dir)
    if not args.skip_inps:
        from .inps import prepare_from_case
        counts = prepare_from_case(args.case_dir, outdir=args.out,
                                   expnr=args.expnr)
        print("&WALLS " + " ".join(f"{k}={v}" for k, v in counts.items()))
    if args.harmonie_ssrd:
        expnr = args.expnr
        if expnr is None:
            cands = sorted(case_dir.glob("namoptions.*"))
            if not cands:
                raise SystemExit("no namoptions.* found and no --expnr")
            expnr = cands[0].suffix.lstrip(".")
        outdir = Path(args.out) if args.out else case_dir
        _harmonie(args, case_dir, outdir, expnr)


if __name__ == "__main__":
    main()
