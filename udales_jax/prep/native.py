"""ctypes bindings for the native (C++) preprocessing kernels.

Builds native/ibmprep.cpp on first use (g++ -O3, cached next to the source)
and exposes `grid_solid_mask` / `cut_sections`.  The numpy implementations
in prep/geom.py / prep/ibmprep.py remain the reference semantics; the
native path is validated against them in tests/test_prep_native.py."""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "native" / "ibmprep.cpp"
_SO = _SRC.with_name("libibmprep.so")
_lib = None


def _compile(src: Path, so: Path):
    """g++ -O3 `src` into `so` (OpenMP when the compiler has it).  The
    library is written under a temporary name and renamed into place, so a
    process that already loaded the old one keeps a whole file."""
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    flags = ["g++", "-O3", "-shared", "-fPIC"]
    try:
        try:
            subprocess.run(flags + ["-fopenmp", "-o", str(tmp), str(src)],
                           check=True, capture_output=True)
        except subprocess.CalledProcessError:
            subprocess.run(flags + ["-o", str(tmp), str(src)],
                           check=True, capture_output=True)
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)


def rebuild():
    """Compile both native libraries from native/*.cpp now, whatever
    copies exist on disk."""
    global _lib, _rad_lib
    _compile(_SRC, _SO)
    _compile(_RAD_SRC, _RAD_SO)
    _lib = _rad_lib = None


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    if (not _SO.exists()
            or _SO.stat().st_mtime < _SRC.stat().st_mtime):
        _compile(_SRC, _SO)
    lib = ctypes.CDLL(str(_SO))
    d = ctypes.POINTER(ctypes.c_double)
    l = ctypes.POINTER(ctypes.c_long)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.grid_solid_mask.restype = None
    lib.grid_solid_mask.argtypes = [
        d, d, ctypes.c_long, d, ctypes.c_long, d, ctypes.c_long,
        d, ctypes.c_long, ctypes.c_double, u8]
    lib.cut_sections.restype = ctypes.c_long
    lib.cut_sections.argtypes = [
        d, d, l, ctypes.c_long,
        d, d, ctypes.c_long, d, d, ctypes.c_long, d, d, ctypes.c_long,
        d, d, d, u8, ctypes.c_int, ctypes.c_double,
        ctypes.c_long, l, d, l, d]
    _lib = lib
    return lib


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _lp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_long))


def _up(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def grid_solid_mask(tris, normals, xs, ys, zs, tol=1e-7):
    lib = get_lib()
    tris = np.ascontiguousarray(tris, np.float64)
    normals = np.ascontiguousarray(normals, np.float64)
    xs = np.ascontiguousarray(xs, np.float64)
    ys = np.ascontiguousarray(ys, np.float64)
    zs = np.ascontiguousarray(zs, np.float64)
    out = np.zeros((len(xs), len(ys), len(zs)), np.uint8)
    lib.grid_solid_mask(_dp(tris), _dp(normals), len(tris),
                        _dp(xs), len(xs), _dp(ys), len(ys),
                        _dp(zs), len(zs), tol, _up(out))
    return out.astype(bool)


def cut_sections(tris, normals, facids, boxes, points, fluid,
                 skip_axis: int, area_tol=1e-9):
    """boxes: ((bxlo,bxhi),(bylo,byhi),(bzlo,bzhi)); points: (px,py,pz)."""
    lib = get_lib()
    tris = np.ascontiguousarray(tris, np.float64)
    normals = np.ascontiguousarray(normals, np.float64)
    facids = np.ascontiguousarray(facids, np.int64)
    (bxlo, bxhi), (bylo, byhi), (bzlo, bzhi) = [
        (np.ascontiguousarray(a, np.float64),
         np.ascontiguousarray(b, np.float64)) for a, b in boxes]
    px, py, pz = [np.ascontiguousarray(p, np.float64) for p in points]
    fl = np.ascontiguousarray(fluid.astype(np.uint8))
    cap = 4 * len(tris) + 64 * int(fl.size ** (2 / 3)) + 100000
    while True:
        of = np.zeros(cap, np.int64)
        oa = np.zeros(cap, np.float64)
        oi = np.zeros(3 * cap, np.int64)
        od = np.zeros(cap, np.float64)
        n = lib.cut_sections(
            _dp(tris), _dp(normals), _lp(facids), len(tris),
            _dp(bxlo), _dp(bxhi), len(bxlo),
            _dp(bylo), _dp(byhi), len(bylo),
            _dp(bzlo), _dp(bzhi), len(bzlo),
            _dp(px), _dp(py), _dp(pz), _up(fl), skip_axis, area_tol,
            cap, _lp(of), _dp(oa), _lp(oi), _dp(od))
        if n >= 0:
            break
        cap = max(2 * cap, -n + 1000)
    return (of[:n], oa[:n], oi[:3 * n].reshape(n, 3), od[:n])


# ---------------------------------------------------------------------------
# Radiation kernels (native/radiation.cpp): View3D + directShortwave.f90
# replacements, validated against prep/radiation.py in
# tests/test_prep_native.py
# ---------------------------------------------------------------------------

_RAD_SRC = Path(__file__).resolve().parents[2] / "native" / "radiation.cpp"
_RAD_SO = _RAD_SRC.with_name("libradiation.so")
_rad_lib = None


def get_radiation_lib():
    global _rad_lib
    if _rad_lib is not None:
        return _rad_lib
    if (not _RAD_SO.exists()
            or _RAD_SO.stat().st_mtime < _RAD_SRC.stat().st_mtime):
        _compile(_RAD_SRC, _RAD_SO)
    lib = ctypes.CDLL(str(_RAD_SO))
    d = ctypes.POINTER(ctypes.c_double)
    lib.view_factors.restype = None
    lib.view_factors.argtypes = [d, d, ctypes.c_long, ctypes.c_int,
                                 ctypes.c_int, d, d]
    lib.direct_shortwave.restype = None
    lib.direct_shortwave.argtypes = [d, d, ctypes.c_long, d,
                                     ctypes.c_double, ctypes.c_int, d]
    _rad_lib = lib
    return lib


def view_factors(tris, normals, subdiv: int = 1, occlusion: bool = True):
    """Native view-factor matrix + sky view factors; same contract as
    prep.radiation.view_factors but streaming (no (m,m) kernel in memory)
    and OpenMP-parallel over facets."""
    lib = get_radiation_lib()
    tris = np.ascontiguousarray(tris, np.float64)
    normals = np.ascontiguousarray(normals, np.float64)
    nf = len(tris)
    F = np.zeros((nf, nf), np.float64)
    svf = np.zeros(nf, np.float64)
    lib.view_factors(_dp(tris), _dp(normals), nf, int(subdiv),
                     int(bool(occlusion)), _dp(F), _dp(svf))
    return F, svf


def direct_shortwave(tris, normals, sun_dir, I_dir: float,
                     subdiv: int = 2):
    """Native facet-averaged direct solar irradiance with shading; same
    contract as prep.radiation.direct_shortwave."""
    lib = get_radiation_lib()
    tris = np.ascontiguousarray(tris, np.float64)
    normals = np.ascontiguousarray(normals, np.float64)
    sun = np.ascontiguousarray(sun_dir, np.float64)
    out = np.zeros(len(tris), np.float64)
    lib.direct_shortwave(_dp(tris), _dp(normals), len(tris), _dp(sun),
                         float(I_dir), int(subdiv), _dp(out))
    return out
