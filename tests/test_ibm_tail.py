"""K-cap sparse tail vs all-dense wall functions.

Real-city STL geometry can put 20+ planes in one cell (examples/950:
K=19..22 -> 8.6 GB of dense stacks).  Slots >= UDALES_IBM_KCAP are routed
to per-section tail vectors (one gather + one scatter per component);
forcing KCAP=1 here routes EVERY beyond-first-slot section through the
tail, which must reproduce the all-dense tendencies to round-off."""
import dataclasses

import jax
import numpy as np
import pytest


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    from udales_jax.prep.prep import (PrepConfig, make_box_array_stl,
                                      prepare_case)
    tmp = tmp_path_factory.mktemp("tailcase")
    n = 32
    make_box_array_stl(tmp / "geom.stl", 2, 2, 0.5, n / 2.0, float(n),
                       float(n))
    counts = prepare_case(tmp / "geom.stl", tmp, PrepConfig(
        itot=n, jtot=n, ktot=n, xlen=float(n), ylen=float(n),
        zsize=float(n), expnr="903", u0=1.0, thl0=290.0, facT0=295.0))
    walls = "\n".join(
        [f"nfcts = {counts['nfcts']}"]
        + [f"nsolpts_{w} = {counts[f'nsolpts_{w}']}" for w in "uvwc"]
        + [f"nbndpts_{w} = {counts[f'nbndpts_{w}']}" for w in "uvwc"]
        + [f"nfctsecs_{w} = {counts[f'nfctsecs_{w}']}" for w in "uvwc"])
    (tmp / "namoptions.903").write_text(f"""&RUN
iexpnr = 903
ladaptive = .true.
dtmax = 0.2
libm = .true.
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
{walls}
iwalltemp = 2
/
&BC
thls = 295.
z0 = 0.05
z0h = 0.00035
/
""")
    return tmp


def _steps(case, kcap, monkeypatch, n=3):
    from udales_jax.run import load_case
    monkeypatch.setenv("UDALES_IBM_KCAP", str(kcap))
    model = load_case(case, "903", dtype="float64")
    state = model.cold_start(seed=7)
    step = jax.jit(model.step)
    for _ in range(n):
        state = step(state)
    return model, state


def test_tail_matches_dense(case, monkeypatch):
    m_dense, s_dense = _steps(case, 99, monkeypatch)
    # all-dense reference must have K > 1 for the cap to bite
    K = max(dn["n0"].shape[0] for dn in m_dense.ibm.dense.values()
            if dn is not None)
    assert K >= 2
    m_tail, s_tail = _steps(case, 1, monkeypatch)
    ntail = sum(len(dn["_tail"]["idx"])
                for dn in m_tail.ibm.dense.values()
                if dn is not None and "_tail" in dn)
    assert ntail > 100          # the cap actually routed sections
    for name in ("u", "v", "w", "thl", "e12"):
        a = np.asarray(getattr(s_dense.c, name))
        b = np.asarray(getattr(s_tail.c, name))
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-11, err_msg=name)


def test_tail_facet_sums_match(case, monkeypatch):
    """hf_tot and per-facet sums must include the tail sections."""
    from udales_jax.run import load_case
    import jax.numpy as jnp
    res = {}
    for kcap in (99, 1):
        monkeypatch.setenv("UDALES_IBM_KCAP", str(kcap))
        model = load_case(case, "903", dtype="float64")
        state = model.cold_start(seed=7)
        state = jax.jit(model.step)(state)
        g_like = model  # compute wallfun sums via one more step's taud? use
        # direct call: build ghosts as substep does
        from udales_jax.ops.boundary import make_ghosts
        from udales_jax.ops import subgrid as sgs
        from udales_jax.run import _velocity_ghosts
        c = state.c
        gvel = _velocity_ghosts(c, model.cfg, model.grid)
        ekm, ekh, _ = sgs.closure(gvel, model.grid, model.cfg, e12=c.e12,
                                  dthvdz=jnp.zeros_like(c.thl), thl=c.thl,
                                  thvs=295.0)
        g = make_ghosts(c, ekm, ekh, model.cfg, model.grid)
        z = jnp.zeros_like
        out = model.ibm.wallfun(g, c, model.grid, model.cfg, z(c.u),
                                z(c.v), jnp.zeros_like(c.w), z(c.thl),
                                z(c.qt), c.sv * 0, None, None,
                                need_fac=True, ibmp=None)
        res[kcap] = (np.asarray(out[6]), float(out[8]))  # fachf, hf_tot
    # Totals are exact.  The per-facet split redistributes only among
    # coplanar same-cell facets here because this case is non-EB (merge
    # groups may span facet ids); under lEB — the only config where
    # need_fac fires — the merge key includes the facet id, making the
    # per-facet sums exact by construction.
    assert res[1][1] == pytest.approx(res[99][1], rel=1e-12)
    assert res[1][0].sum() == pytest.approx(res[99][0].sum(), rel=1e-12)
