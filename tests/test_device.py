"""The device-facing parts of the main path that run on the CPU: the
persistent compile cache, the Poisson matmul precision table, the CLI's
restart cycle without HDF5, and chip_smoke.py's phases and option."""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from udales_jax import device
from udales_jax.ops import poisson

REPO = Path(__file__).resolve().parents[1]


# -- compile cache -------------------------------------------------------------

def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: the code sets no directory of its own
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = device.enable_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


# -- Poisson precision -----------------------------------------------------------

@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_poisson_precision_table(monkeypatch, platform):
    monkeypatch.delenv("UDALES_POIS_PREC", raising=False)
    want = {"highest": jax.lax.Precision.HIGHEST,
            "x3": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3}[
        poisson._PRECISION_BY_PLATFORM[platform]]
    assert poisson._poisson_precision(platform) == want
    if platform == "cpu":   # float64 oracle runs stay bit-stable
        assert want == jax.lax.Precision.HIGHEST


def test_poisson_precision_unknown_platform_raises(monkeypatch):
    monkeypatch.delenv("UDALES_POIS_PREC", raising=False)
    with pytest.raises(ValueError, match="rocm"):
        poisson._poisson_precision("rocm")
    monkeypatch.setenv("UDALES_POIS_PREC", "bf16")
    with pytest.raises(ValueError, match="bf16"):
        poisson._poisson_precision("cpu")


def _dot_precisions(jaxpr):
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out.extend(_dot_precisions(sub))
    return out


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.complex64, jnp.float64])
def test_mm_precision_by_dtype(monkeypatch, dtype):
    """With the bf16x3 preset forced, real float32 transforms take it;
    complex and float64 matmuls stay at HIGHEST."""
    monkeypatch.setenv("UDALES_POIS_PREC", "x3")
    M = np.ones((4, 4), np.float32)
    x = jnp.ones((4, 3), dtype)
    precs = _dot_precisions(
        jax.make_jaxpr(lambda a: poisson._mm(a, M, 0))(x).jaxpr)
    assert precs
    if dtype == jnp.float32:
        assert all(p == jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
                   for p in precs), precs
    else:
        hi = jax.lax.Precision.HIGHEST
        assert all(p == (hi, hi) for p in precs), precs


# -- model arrays as program arguments ---------------------------------------

@pytest.mark.parametrize("min_bytes", [1, 1 << 40])
def test_hoisted_jit_matches_jit(min_bytes, monkeypatch):
    """HoistedJit gives jax.jit's result bit for bit, whether the model's
    arrays are passed in (threshold 1 byte) or all stay inline; it traces
    once per input structure."""
    from udales_jax import run as run_mod
    from udales_jax.cases import flat_model, flat_state
    from udales_jax.run import HoistedJit
    monkeypatch.setattr(run_mod, "_HOIST_MIN_BYTES", min_bytes)
    model = flat_model(8, 8, 8)
    state = flat_state(model)
    ref = jax.jit(lambda s: model.run(s, 2))(state)
    run = HoistedJit(lambda s: model.run(s, 2))
    got = run(run(state))
    got1 = run(state)
    for k in ("u", "v", "w", "thl"):
        np.testing.assert_array_equal(np.asarray(getattr(got1.c, k)),
                                      np.asarray(getattr(ref.c, k)))
    assert np.isfinite(np.asarray(got.c.u)).all()
    assert len(run._traced) == 1
    lowered, (hoisted, flat) = run.lower(state)
    assert len(flat) == len(jax.tree.leaves(state))
    assert (len(hoisted) > 0) == (min_bytes == 1)
    out = lowered.compile()(hoisted, flat)
    np.testing.assert_array_equal(np.asarray(out.c.u), np.asarray(ref.c.u))


def test_hoisted_jit_replicates_constants_on_the_mesh(monkeypatch):
    """With the state laid out over a 2x2 mesh, the hoisted arrays are
    replicated over that mesh (not left on one device to be copied on
    every call), and the step matches the one-device step."""
    from jax.sharding import PartitionSpec as P
    from udales_jax import run as run_mod
    from udales_jax.cases import flat_model, flat_state
    from udales_jax.parallel.mesh import make_mesh, shard_state
    monkeypatch.setattr(run_mod, "_HOIST_MIN_BYTES", 1)
    model = flat_model(8, 8, 8, dtype="float64")
    state = flat_state(model)
    ref = model.step_jit()(state)
    mesh = make_mesh(2, 2)
    model.mesh = model.pois.mesh = mesh
    step = model.step_jit()
    got = step(shard_state(state, mesh))
    (_, hoisted), = step._traced.values()
    assert hoisted
    for c in hoisted:
        assert c.sharding.mesh == mesh and c.sharding.spec == P()
    assert len(got.c.u.sharding.device_set) == 4
    for k in ("u", "v", "w", "thl"):
        np.testing.assert_allclose(np.asarray(getattr(got.c, k)),
                                   np.asarray(getattr(ref.c, k)),
                                   rtol=1e-12, atol=1e-12)


# -- CLI restart cycle without HDF5 ------------------------------------------

_NAM = """
&RUN
iexpnr = 905
runtime = 0.1
trestart = 0.05
ladaptive = .true.
dtmax = 0.02
{warm}
/
&DOMAIN
itot = 8
jtot = 8
ktot = 8
xlen = 8.
ylen = 8.
/
&OUTPUT
lxytdump = .true.
tsample = 0.02
tstatsdump = 0.08
/
"""


def _write_mini_case(case: Path, warm=""):
    case.mkdir(parents=True, exist_ok=True)
    (case / "namoptions.905").write_text(_NAM.format(warm=warm))
    (case / "prof.inp.905").write_text(
        "# prof\n# z thl qt u v e12\n" + "".join(
            f"{z + 0.5:8.3f} 288.0 0.0 1.0 0.0 5e-5\n" for z in range(8)))
    (case / "lscale.inp.905").write_text(
        "# lscale\n# z ug vg pgx pgy wfls dqtdx dqtdy dqtdt dthlrad\n"
        + "".join(f"{z + 0.5:8.3f} 0 0 0 0 0 0 0 0 0\n" for z in range(8)))
    return case


def test_cli_restart_resume_without_h5py(tmp_path, monkeypatch):
    """The CLI writes a restart, a warm start reloads it and resumes, all
    with HDF5 unimportable: checkpoints are numpy .npz."""
    from udales_jax import sim
    from udales_jax.io.restart import load_checkpoint
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    out = tmp_path / "out"
    first = sim.main([str(_write_mini_case(tmp_path / "a")),
                      "--outdir", str(out), "--dtype", "float64"])
    ck = sorted(out.glob("initd*.905.npz"))[-1]
    with np.load(ck) as f:
        assert {"c/u", "m/thl", "pres", "timee", "dt",
                "stats/xytdump/tnext_sample"} <= set(f.files)
        t_ck = float(f["timee"])
    saved = load_checkpoint(ck, None)
    assert float(saved.timee) == t_ck <= float(first.timee)

    warm = _write_mini_case(
        tmp_path / "b", warm=f"lwarmstart = .true.\nstartfile = '{ck.name}'")
    resumed = sim.main([str(warm), "--outdir", str(out), "--dtype",
                        "float64", "--runtime", "0.06"])
    assert float(resumed.timee) >= t_ck + 0.06 - 1e-9
    assert np.isfinite(np.asarray(resumed.c.u)).all()
    assert sys.modules["h5py"] is None


# -- chip_smoke.py -----------------------------------------------------------------

@pytest.fixture
def chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
        yield chip_smoke
    finally:
        sys.path.remove(str(REPO))


def test_chip_smoke_device_check_refuses_cpu(chip_smoke, capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("four", [True, False])
def test_chip_smoke_phase_selection(chip_smoke, monkeypatch, tmp_path,
                                    capsys, four):
    """--four runs the sharded phase and nothing else; the default run
    every other phase; the last line is the contract line either way."""
    calls = []
    fake = types.SimpleNamespace(platform="gpu", device_kind="H100")
    devs = [fake] * (4 if four else 1)
    monkeypatch.setattr(chip_smoke, "phase_device", lambda: devs)
    monkeypatch.setattr(chip_smoke, "enable_compile_cache", lambda: "-")
    monkeypatch.setattr(chip_smoke, "OUT", tmp_path)
    for name, ret in (("four", None), ("case", "case"),
                      ("main_run", ("model", "state")), ("divergence", None),
                      ("poisson", None), ("eb", None), ("diffusion", None)):
        monkeypatch.setattr(chip_smoke, f"phase_{name}",
                            lambda *a, _n=name, _r=ret, **k:
                            calls.append(_n) or _r)
    chip_smoke.main(["--four"] if four else [])
    if four:
        assert calls == ["four"]
    else:
        assert "four" not in calls and len(calls) == 6
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "H100", "count": len(devs)}}


def test_chip_smoke_main_run_phase_cpu(chip_smoke, tmp_path, monkeypatch):
    """The case and main-run phases at 16^3 on the CPU: CLI run with field
    dump, statistics and restart, then the compiled scan."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    case = chip_smoke.phase_case(tmp_path, 16, 30.0)
    model, final = chip_smoke.phase_main_run(case, tmp_path / "run", 30.0,
                                             min_steps=50, scan_steps=2)
    assert model.grid.shape == (16, 16, 16)
    chip_smoke.phase_divergence(model, final)


def test_chip_smoke_four_phase_cpu(chip_smoke, tmp_path, capsys):
    """The --four phase at 16^3 on four virtual CPU devices: each case on
    the 2x2 mesh within FOUR_ULPS of one device, far below how far the
    steps moved it."""
    chip_smoke.phase_four(tmp_path, 16)
    out = capsys.readouterr().out
    assert out.count("4-device vs 1-device") == 3
    assert "FAIL" not in out


@pytest.mark.gpu
def test_chip_smoke_numerics_on_gpu(gpu_device):
    """The numerics phases on the card at a small width, from one child
    process (this one stays on the CPU)."""
    code = ("import chip_smoke as c; c.phase_device(); c.phase_poisson(64);"
            " c.phase_diffusion(64)")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "JAX_ENABLE_X64")}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
