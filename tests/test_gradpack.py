"""The shared-gradient (GradPack) closure/diffusion path must match the
standalone stencils.  The pack re-associates 4-term corner sums, so the
match is to f64 round-off, not bit-exact (see ops/subgrid.py docstring)."""
import types

import jax
import jax.numpy as jnp
import numpy as np

from udales_jax.grid import Grid
from udales_jax.ops import subgrid as sgs


def _random_ghosted(nx, ny, nz, seed=0, dtype=jnp.float64):
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    return types.SimpleNamespace(
        u=jax.random.normal(ks[0], (nx + 2, ny + 2, nz + 2), dtype),
        v=jax.random.normal(ks[1], (nx + 2, ny + 2, nz + 2), dtype),
        w=jax.random.normal(ks[2], (nx + 2, ny + 2, nz + 1), dtype),
        ekm=jax.random.uniform(ks[3], (nx + 2, ny + 2, nz + 2), dtype) + 0.5)


def _grid(nx, ny, nz, stretched=True):
    if not stretched:
        return Grid.uniform(nx, ny, nz, float(nx), float(ny), float(nz),
                            dtype=np.float64)
    # stretched z exercises every dzf/dzh weighting in the pack
    dz = 1.0 + 0.08 * np.arange(nz)
    zh = np.concatenate([[0.0], np.cumsum(dz)])
    zf = 0.5 * (zh[:-1] + zh[1:])
    return Grid(nx, ny, nz, float(nx), float(ny), zf, dtype=np.float64)


def test_fused_diffusion_matches_standalone():
    nx, ny, nz = 12, 10, 9
    grid = _grid(nx, ny, nz)
    g = _random_ghosted(nx, ny, nz)
    tu, tv, tw = sgs.fused_diffusion(g, grid)
    np.testing.assert_allclose(tu, sgs.diff_u(g, grid), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tv, sgs.diff_v(g, grid), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tw, sgs.diff_w(g, grid), rtol=0, atol=1e-12)


def test_gradients_pack_matches_direct():
    nx, ny, nz = 12, 10, 9
    grid = _grid(nx, ny, nz)
    g = _random_ghosted(nx, ny, nz, seed=1)
    pack = sgs.compute_gradpack(g, grid)
    direct = sgs._gradients(g, grid)
    packed = sgs._gradients_pack(pack, g, grid)
    for d, p in zip(direct, packed):
        np.testing.assert_allclose(p, d, rtol=0, atol=1e-12)


def test_strain2_pack_matches_direct():
    nx, ny, nz = 12, 10, 9
    grid = _grid(nx, ny, nz)
    g = _random_ghosted(nx, ny, nz, seed=2)
    pack = sgs.compute_gradpack(g, grid)
    np.testing.assert_allclose(sgs._strain2_pack(pack), sgs._strain2(g, grid),
                               rtol=0, atol=1e-11)


def test_closure_pack_matches_direct():
    from udales_jax.config import Config
    nx, ny, nz = 12, 10, 9
    grid = _grid(nx, ny, nz, stretched=False)
    g = _random_ghosted(nx, ny, nz, seed=3)
    cfg = Config()
    pack = sgs.compute_gradpack(g, grid)
    ekm0, ekh0 = sgs.vreman_closure(g, grid, cfg)
    ekm1, ekh1 = sgs.vreman_closure(g, grid, cfg, pack=pack)
    np.testing.assert_allclose(ekm1, ekm0, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ekh1, ekh0, rtol=0, atol=1e-12)
