"""Checkpoint/restore.

Native checkpoints are numpy ``.npz`` archives holding the full prognostic
pytree + timee/dt under path-like keys (``c/u``, ``m/thl``, ``pres``,
``fac/T``, ...) — the analogue of the reference's per-rank unformatted
``initd<ntrun>_<px>_<py>.<exp>`` files (src/modsave.f90:37-131), but merged
and portable.

`read_fortran_restart` ingests the reference's own restart files for
warmstart parity runs (record layout at modsave.f90:80-100: sequential
unformatted with 4-byte little-endian markers, real(8) data, per-rank
subdomains with 1-cell halos).
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


# ---------------------------------------------------------------------------
# Native checkpoints
# ---------------------------------------------------------------------------

_FAC_LEAVES = ("T", "Tdash", "hfi", "efi", "wsoil", "hurel", "qsat", "f",
               "tnextEB", "tEB_last")


def save_npz(path: str | Path, arrays: dict):
    """Write `arrays` to exactly `path` (np.savez would append .npz to a
    name without it)."""
    with open(path, "wb") as fh:
        np.savez(fh, **{k: np.asarray(v) for k, v in arrays.items()})


def save_checkpoint(path: str | Path, state, ntrun: int = 0,
                    extra: dict | None = None):
    """Write a native checkpoint; `extra` adds more named arrays (the
    statistics accumulators of sim.Simulation._write_restart)."""
    arrays = {"timee": float(state.timee), "dt": float(state.dt),
              "ntrun": ntrun, "pres": state.pres}
    for grp, fields in (("m", state.m), ("c", state.c)):
        for name in ("u", "v", "w", "thl", "qt", "e12", "sv"):
            arrays[f"{grp}/{name}"] = getattr(fields, name)
    # facet-EB state (the reference restarts facet temperatures via a
    # re-written Tfacinit_layers.inp, initfac.f90:301-310; here the
    # whole FacetState rides in the checkpoint)
    if state.fac is not None:
        for name in _FAC_LEAVES:
            arrays[f"fac/{name}"] = getattr(state.fac, name)
    arrays.update(extra or {})
    save_npz(path, arrays)


def load_checkpoint(path: str | Path, grid, dtype=None, model=None):
    """Rebuild a State from a native checkpoint.  Pass `model` to restore
    the facet-EB state (its derived dense surface stacks are rebuilt from
    the model's IBM)."""
    import jax.numpy as jnp
    from ..state import Fields, State
    with np.load(path) as f:
        def fields(grp):
            return Fields(**{name: jnp.asarray(f[f"{grp}/{name}"])
                             for name in ("u", "v", "w", "thl", "qt",
                                          "e12", "sv")})
        fac = None
        if "fac/T" in f and model is not None and model.eb is not None:
            from ..ibm.eb import FacetState
            leaves = {name: jnp.asarray(f[f"fac/{name}"])
                      for name in _FAC_LEAVES}
            dense = None
            if model.eb is not None and getattr(model.eb, "ibm", None):
                dense = model.eb.ibm.rebuild_dense_surf(
                    leaves["T"][:, 0], leaves["qsat"], leaves["hurel"],
                    leaves["f"])
            fac = FacetState(dense=dense, **leaves)
        st = State(m=fields("m"), c=fields("c"),
                   pres=jnp.asarray(f["pres"]),
                   dt=jnp.asarray(f["dt"]),
                   timee=jnp.asarray(f["timee"]),
                   fac=fac)
    if model is not None:
        st = model.attach_params(st)
        if model.cfg.walls.lwritefac and model.ibm is not None:
            from ..state import zero_facstats
            st = st.replace(facstats=zero_facstats(model.ibm.nfcts,
                                                   grid.dtype))
    return st


# ---------------------------------------------------------------------------
# Reference Fortran restart write (modsave.f90:83-131 record layout)
# ---------------------------------------------------------------------------

def _write_record(fh, payload: bytes):
    fh.write(struct.pack("<i", len(payload)))
    fh.write(payload)
    fh.write(struct.pack("<i", len(payload)))


def write_fortran_restart(case_dir: str | Path, fields: dict, timee: float,
                          dt: float, expnr: str, itot: int, jtot: int,
                          ktot: int, nprocx: int = 1, nprocy: int = 1,
                          ntrun: int = 0, sv=None):
    """Write per-rank ``initd<ntrun>_<px>_<py>.<exp>`` (+ ``inits*`` when
    scalars are present) in the reference's sequential-unformatted layout
    (modsave.f90:83-131): records mindist, wall(5), then
    u0,v0,w0,pres0,thl0,e120,ekm,qt0,ql0,ql0h on (imax+2, jmax+2, ktot+1)
    subdomains with 1-cell periodic halos, then (timee, dt).

    `fields` maps those ten names to global (itot, jtot, ktot[+1]) arrays;
    missing entries are written as zeros.  mindist/wall (wall-distance
    search caches, modfields.f90) are written as zeros — this solver
    recomputes wall geometry from the IBM inputs on startup and its ingest
    skips these records (read_fortran_restart above)."""
    case_dir = Path(case_dir)
    imax, jmax = itot // nprocx, jtot // nprocy
    ih = jh = kh = 1
    names = ["u", "v", "w", "pres", "thl", "e12", "ekm", "qt", "ql", "qlh"]

    def halo_block(glob, px, py):
        """(imax+2, jmax+2, ktot+1) little-endian f8, Fortran order."""
        g = np.zeros((itot, jtot, ktot + kh))
        g[:, :, :min(glob.shape[2], ktot + kh)] = \
            np.asarray(glob, np.float64)[:, :, :ktot + kh]
        gi = np.take(g, np.arange(px * imax - ih, (px + 1) * imax + ih),
                     axis=0, mode="wrap")
        return np.take(gi, np.arange(py * jmax - jh, (py + 1) * jmax + jh),
                       axis=1, mode="wrap")

    zero_int = np.zeros((imax, jmax, ktot))
    for px in range(nprocx):
        for py in range(nprocy):
            name = f"initd{ntrun:08d}_{px:03d}_{py:03d}.{expnr}"
            with open(case_dir / name, "wb") as fh:
                _write_record(fh, zero_int.tobytes(order="F"))       # mindist
                _write_record(fh, np.zeros(
                    (imax, jmax, ktot, 5)).tobytes(order="F"))       # wall
                for n in names:
                    glob = fields.get(n)
                    if glob is None:
                        glob = np.zeros((itot, jtot, ktot))
                    _write_record(fh, halo_block(glob, px, py)
                                  .tobytes(order="F"))
                _write_record(fh, struct.pack("<2d", timee, dt))
            if sv is not None and len(sv):
                sname = f"inits{ntrun:08d}_{px:03d}_{py:03d}.{expnr}"
                blocks = np.stack([halo_block(s, px, py) for s in sv],
                                  axis=-1)
                with open(case_dir / sname, "wb") as fh:
                    _write_record(fh, blocks.tobytes(order="F"))
                    _write_record(fh, struct.pack("<d", timee))


# ---------------------------------------------------------------------------
# Reference Fortran restart ingest
# ---------------------------------------------------------------------------

def _read_records(path: Path):
    """Yield raw payloads of a little-endian sequential unformatted file."""
    data = Path(path).read_bytes()
    off = 0
    while off < len(data):
        (n,) = struct.unpack_from("<i", data, off)
        off += 4
        yield data[off: off + n]
        off += n
        (n2,) = struct.unpack_from("<i", data, off)
        assert n2 == n, "corrupt record marker"
        off += 4


def read_fortran_restart(case_dir: str | Path, startfile: str, expnr: str,
                         itot: int, jtot: int, ktot: int,
                         nprocx: int, nprocy: int, nsv: int = 0):
    """Read the reference's per-rank initd/inits files and assemble global
    fields (interiors only; halos dropped).

    startfile pattern: ``initd<ntrun>_xxx_xxx.<exp>`` — xxx placeholders are
    replaced per rank (modstartup.f90:2156+). Returns dict of (itot,jtot,
    ktot[+1]) float64 arrays + timee, dt."""
    case_dir = Path(case_dir)
    imax, jmax = itot // nprocx, jtot // nprocy
    ih = jh = kh = 1
    shape = (imax + 2 * ih, jmax + 2 * jh, ktot + kh)  # (i,j,k) fortran order
    names = ["u", "v", "w", "pres", "thl", "e12", "ekm", "qt", "ql", "qlh"]
    out = {n: np.zeros((itot, jtot, ktot + kh)) for n in names}
    out_sv = np.zeros((nsv, itot, jtot, ktot + kh)) if nsv else None
    timee = dt = 0.0

    for px in range(nprocx):
        for py in range(nprocy):
            fname = startfile.replace("xxx", f"{px:03d}", 1)
            fname = fname.replace("xxx", f"{py:03d}", 1)
            path = case_dir / fname
            recs = list(_read_records(path))
            # records: mindist, wall(5), then the 10 fields, then (timee, dt)
            fld_recs = recs[2:12]
            for name, payload in zip(names, fld_recs):
                a = np.frombuffer(payload, "<f8").reshape(shape, order="F")
                interior = a[ih:-ih, jh:-jh, :]
                out[name][px * imax:(px + 1) * imax,
                          py * jmax:(py + 1) * jmax, :] = interior
            timee, dt = struct.unpack("<2d", recs[12])
            if nsv:
                spath = case_dir / fname.replace("initd", "inits")
                if spath.exists():
                    srecs = list(_read_records(spath))
                    a = np.frombuffer(srecs[0], "<f8").reshape(
                        shape + (nsv,), order="F")
                    out_sv[:, px * imax:(px + 1) * imax,
                           py * jmax:(py + 1) * jmax, :] = \
                        a[ih:-ih, jh:-jh, :, :].transpose(3, 0, 1, 2)
    return out, out_sv, timee, dt


def warmstart_state(case_dir, startfile, expnr, cfg, grid, dtype=None):
    """Build a State from reference restart files (lwarmstart path,
    modstartup.f90:2156)."""
    import jax.numpy as jnp
    from ..state import Fields, State
    d = cfg.domain
    out, out_sv, timee, dt = read_fortran_restart(
        case_dir, startfile, expnr, d.itot, d.jtot, d.ktot,
        cfg.run.nprocx, cfg.run.nprocy, cfg.scalars.nsv)
    fdt = grid.dtype
    nz = d.ktot
    to = lambda a: jnp.asarray(a[..., :nz], fdt)
    # w: faces 0..nz (restart array holds kb..ke+kh = faces 0..nz)
    w = jnp.asarray(out["w"], fdt)
    f = Fields(u=to(out["u"]), v=to(out["v"]), w=w,
               thl=to(out["thl"]), qt=to(out["qt"]), e12=to(out["e12"]),
               sv=(jnp.asarray(out_sv[..., :nz], fdt) if out_sv is not None
                   else jnp.zeros((0, d.itot, d.jtot, nz), fdt)))
    return State(m=f, c=f, pres=to(out["pres"]),
                 dt=jnp.asarray(dt, fdt), timee=jnp.asarray(timee, fdt))
