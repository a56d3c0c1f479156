"""Statistics variable-name completeness vs the reference ncinfo tables.

Parses the variable names straight out of modstatsdump.f90's ncinfo calls
for each output family and asserts that the files our writers produce
contain a SUPERSET of those names (the reference defines its full fixed
tables regardless of nsv, writing zeros for unused slots — we mirror
that).  Families checked are the ones the flagship cases enable:
102 -> lxytdump; 201 -> ltdump + lxytdump; plus lydump/lytdump/lxydump.
"""
import re
from pathlib import Path

import jax
import numpy as np
import pytest

from udales_jax.io.stats import TDump, XYDump, XYTDump, YDump, YTDump

REF_SRC = Path("/root/reference/src/modstatsdump.f90")

pytestmark = pytest.mark.skipif(not REF_SRC.exists(),
                                reason="reference absent")


def ref_names(table: str) -> set:
    """Extract variable names of one ncinfo table (e.g. 'ncstatxyt')."""
    pat = re.compile(rf"call ncinfo\({table}\(\s*\d+,:\),'([^']+)'")
    names = set()
    for line in REF_SRC.read_text().splitlines():
        line = line.strip()
        if line.startswith("!"):
            continue          # commented-out entries are not written
        m = pat.search(line)
        if m:
            names.add(m.group(1))
    return names


def make_model():
    import sys
    sys.path.insert(0, str(Path(__file__).parent))
    from test_core import make_model as mm
    return mm()


def written_names(writer_obj):
    return set(writer_obj.writer.variables)


@pytest.fixture(scope="module")
def model_state():
    import sys
    sys.path.insert(0, str(Path(__file__).parent))
    from test_core import init_state, make_model
    model = make_model()
    state = init_state(model)
    state = jax.jit(model.step)(state)
    return model, state


class TestVariableSupersets:
    def _check(self, dump, table, tmp_path, model_state, sample=True,
               masked=True):
        model, state = model_state
        names = ref_names(table)
        assert names, f"no names parsed for {table}"
        # force a sample+write so the variable set is exercised end-to-end
        if sample:
            dump.tnext_sample = 0.0
            if masked:
                dump.maybe_sample(state, None)
            else:
                dump.maybe_sample(state)
            assert float(np.asarray(
                dump.acc["n"] if isinstance(dump.acc, dict)
                else dump.acc.n)) >= 1
        have = set(dump.writer._vars)
        missing = names - have
        assert not missing, f"{table}: missing {sorted(missing)}"

    def test_xytdump(self, tmp_path, model_state):
        model, state = model_state
        d = XYTDump(model.cfg, model.grid, tmp_path, model=model)
        self._check(d, "ncstatxyt", tmp_path, model_state)
        d.write(1.0)
        d.close()

    def test_tdump(self, tmp_path, model_state):
        model, state = model_state
        d = TDump(model.cfg, model.grid, tmp_path, nsv=0, model=model)
        self._check(d, "ncstatt", tmp_path, model_state, masked=False)
        d.write(1.0)
        d.close()

    def test_ytdump(self, tmp_path, model_state):
        model, state = model_state
        d = YTDump(model.cfg, model.grid, tmp_path, nsv=0, model=model)
        self._check(d, "ncstatyt", tmp_path, model_state)
        d.write(1.0)
        d.close()

    def test_ydump(self, tmp_path, model_state):
        model, state = model_state
        d = YDump(model.cfg, model.grid, tmp_path, nsv=0, model=model)
        names = ref_names("ncstaty")
        d.tnext = 0.0
        d.maybe_dump(state, None)
        have = set(d.writer._vars)
        missing = names - have
        assert not missing, f"ncstaty: missing {sorted(missing)}"
        d.close()

    def test_xydump(self, tmp_path, model_state):
        model, state = model_state
        d = XYDump(model.cfg, model.grid, tmp_path, model=model)
        names = ref_names("ncstatxy")
        d.tnext = 0.0
        d.maybe_dump(state, None)
        have = set(d.writer._vars)
        missing = names - have
        assert not missing, f"ncstatxy: missing {sorted(missing)}"
        d.close()

    def test_tkedump(self, tmp_path, model_state):
        """ltkedump now carries the reference's ncstattke names
        (modstatsdump.f90:396-404) alongside the descriptive ones."""
        from udales_jax.io.stats import TKEDump
        model, state = model_state
        d = TKEDump(model.cfg, model.grid, tmp_path, model=model)
        d.tnext_sample = 0.0
        d.maybe_sample(state)
        have = set(d.writer._vars)
        missing = ref_names("ncstattke") - have
        assert not missing, f"ncstattke: missing {sorted(missing)}"
        d.write(1.0)
        d.close()
        # alias pairs must be numerically identical; the budget terms
        # finite
        from scipy.io import netcdf_file
        f = netcdf_file(d.writer.path, "r", mmap=False)
        data = {k: np.asarray(v[:]) for k, v in f.variables.items()}
        for a, b in (("p_b", "buoy"), ("t_p", "ptrans"), ("t_t", "ttrans"),
                     ("p_t", "shear")):
            np.testing.assert_array_equal(data[a], data[b])
        for k in ("adv", "t_sgs", "t_v", "d_sgs"):
            assert np.isfinite(data[k]).all(), k

    def test_slices(self, tmp_path, model_state):
        """k/i/j slice families must carry the reference names
        (ncinfo tables at modstatsdump.f90:424-484)."""
        import dataclasses
        from udales_jax.io.stats import SliceDump
        model, state = model_state
        cfg = dataclasses.replace(
            model.cfg, output=dataclasses.replace(
                model.cfg.output, lkslicedump=True, lislicedump=True,
                ljslicedump=True))
        d = SliceDump(cfg, model.grid, tmp_path, nsv=0)
        d.tnext = 0.0
        d.maybe_dump(state)
        for w, table in ((d.writers["k"], "ncstatkslice"),
                         (d.writers["i"], "ncstatislice"),
                         (d.writers["j"], "ncstatjslice")):
            missing = ref_names(table) - set(w._vars)
            assert not missing, (table, sorted(missing))
        d.close()

    def test_written_values_finite(self, tmp_path, model_state):
        """The new flux/variance variables must hold finite values after a
        sampled write (read back through scipy NetCDF)."""
        from scipy.io import netcdf_file
        model, state = model_state
        d = XYTDump(model.cfg, model.grid, tmp_path, model=model)
        d.tnext_sample = 0.0
        d.maybe_sample(state, None)
        assert float(np.asarray(d.acc.n)) >= 1
        d.write(2.0)
        d.close()
        exp = f"{model.cfg.run.iexpnr:03d}"
        with netcdf_file(str(Path(tmp_path) / f"xytdump.{exp}.nc"), "r",
                         mmap=False) as f:
            for name, var in f.variables.items():
                a = np.array(var[:])
                assert np.isfinite(a).all(), name


class TestFacetFileNames:
    """fac/facT/facEB variable names vs the reference ncinfo tables
    (modibm.f90:230-237, modEB.f90:303-314)."""

    def _names(self, src, table):
        pat = re.compile(rf"call ncinfo\({table}\(\s*\d+,:\),'([^']+)'")
        out = set()
        for line in Path(src).read_text().splitlines():
            line = line.strip()
            if line.startswith("!"):
                continue
            m = pat.search(line)
            if m:
                out.add(m.group(1))
        return out

    def test_names_in_sim_writers(self):
        sim_src = (Path(__file__).parents[1]
                   / "udales_jax/sim.py").read_text()
        for src, table in (("/root/reference/src/modibm.f90", "ncstatfac"),
                           ("/root/reference/src/modEB.f90", "ncstatT"),
                           ("/root/reference/src/modEB.f90", "ncstatEB")):
            names = self._names(src, table)
            assert names
            for n in names:
                assert f'"{n}"' in sim_src, (table, n)
