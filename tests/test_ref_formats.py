"""Reference Fortran binary formats: restart (initd/inits) and precursor
driver (?driver_*) files — writer/reader round trips plus ingest of the
REAL reference-produced fixtures committed in the reference tree
(examples/102/warmstart_files/inits*, examples/950/driver_files/tdriver*).
"""
from pathlib import Path

import numpy as np
import pytest

from udales_jax.io.driverfiles import read_driver_files, write_driver_files
from udales_jax.io.restart import (_read_records, read_fortran_restart,
                                   write_fortran_restart)

REF = Path("/root/reference")


class TestRestartRoundTrip:
    def test_write_read_2x2(self, tmp_path):
        rng = np.random.default_rng(3)
        it, jt, kt = 8, 12, 6
        names = ["u", "v", "w", "pres", "thl", "e12", "ekm", "qt", "ql",
                 "qlh"]
        fields = {n: rng.standard_normal((it, jt, kt + 1)) for n in names}
        sv = rng.standard_normal((2, it, jt, kt + 1))
        write_fortran_restart(tmp_path, fields, 123.5, 0.25, "901",
                              it, jt, kt, nprocx=2, nprocy=2, ntrun=7,
                              sv=sv)
        assert (tmp_path / "initd00000007_001_001.901").exists()
        out, out_sv, timee, dt = read_fortran_restart(
            tmp_path, "initd00000007_xxx_xxx.901", "901", it, jt, kt,
            2, 2, nsv=2)
        assert timee == 123.5 and dt == 0.25
        for n in names:
            np.testing.assert_allclose(out[n], fields[n], atol=0, rtol=0)
        np.testing.assert_allclose(out_sv, sv, atol=0, rtol=0)

    def test_committed_102_inits_parse(self):
        """The real reference-produced scalar restarts of example 102 parse
        with the record reader: (34,34,65) f8 interior+halo blocks and the
        trailing timee record (modsave.f90:119-127)."""
        wdir = REF / "examples/102/warmstart_files"
        if not wdir.exists():
            pytest.skip("reference tree not mounted")
        import struct
        for px in range(2):
            for py in range(2):
                f = wdir / f"inits00000267_{px:03d}_{py:03d}.102"
                recs = list(_read_records(f))
                assert len(recs) == 2
                a = np.frombuffer(recs[0], "<f8").reshape((34, 34, 65, 1),
                                                          order="F")
                assert np.isfinite(a).all()
                assert a.max() < 1e3 and a.min() > -1e3
                (timee,) = struct.unpack("<d", recs[1])
                assert 90.0 < timee < 110.0   # ntrun 267, trestart 10


class TestDriverFiles:
    def test_round_trip_nprocy2(self, tmp_path):
        rng = np.random.default_rng(5)
        jt, kt, nt, nsv = 8, 6, 5, 2
        times = 100.0 + np.arange(nt) * 1.0
        planes = {
            "u": rng.standard_normal((nt, jt, kt)),
            "v": rng.standard_normal((nt, jt, kt)),
            "w": rng.standard_normal((nt, jt, kt + 1)),
            "thl": rng.standard_normal((nt, jt, kt)),
            "qt": rng.standard_normal((nt, jt, kt)),
            "sv": rng.standard_normal((nt, nsv, jt, kt)),
        }
        write_driver_files(tmp_path, "949", times, planes, jt, kt,
                           nprocy=2, tdriverstart=100.0)
        for pref in ("u", "v", "w", "h", "q", "s"):
            assert (tmp_path / f"{pref}driver_000.949").exists()
            assert (tmp_path / f"{pref}driver_001.949").exists()
        d = read_driver_files(tmp_path, 949, jt, kt, nsv=nsv, lmoist=True)
        np.testing.assert_allclose(d["t"], times - 100.0)
        for k in ("u", "v", "w", "thl", "qt", "sv"):
            np.testing.assert_allclose(d[k], planes[k], atol=0, rtol=0,
                                       err_msg=k)

    def test_record_layout_matches_fortran_direct_access(self, tmp_path):
        """The u-file must be raw consecutive (jmax+2)x(ktot+2) f8 planes,
        j fastest (moddriver.f90:750 implied-do read order) — verified
        byte-for-byte against a hand-built record."""
        jt, kt = 4, 3
        u = np.arange(jt * kt, dtype=float).reshape(1, jt, kt)
        write_driver_files(tmp_path, "900", [0.0], {"u": u}, jt, kt)
        raw = np.frombuffer((tmp_path / "udriver_000.900").read_bytes(),
                            "<f8")
        assert len(raw) == (jt + 2) * (kt + 2)
        plane = raw.reshape((kt + 2, jt + 2)).T   # j fastest
        # interior block with periodic j halos and clamped k ghosts
        np.testing.assert_allclose(plane[1:-1, 1:-1], u[0])
        np.testing.assert_allclose(plane[0, 1:-1], u[0, -1])   # j ghost
        np.testing.assert_allclose(plane[1:-1, 0], u[0, :, 0])  # k ghost

    def test_committed_949_tdriver(self):
        """The committed tdriver_000.949 (the only reference-produced
        driver fixture) reads as 101 monotone f8 timestamps spaced
        ~dtdriver=1 s (namoptions.949)."""
        ddir = REF / "examples/950/driver_files"
        if not ddir.exists():
            pytest.skip("reference tree not mounted")
        t = np.frombuffer((ddir / "tdriver_000.949").read_bytes(), "<f8")
        assert len(t) == 101    # driverstore = 101
        assert (np.diff(t) > 0).all()
        assert 0.5 < np.median(np.diff(t)) < 1.5
        assert t[0] < 2.0       # relative to tdriverstart
