"""Sharding-invariance tests: the distributed-correctness oracle.

Direct analogue of the reference's processor-boundary tests
(tests/integration/processor_boundaries/test_processor_boundaries.py, which
asserts 1x1 == 2x1 == 1x2 == 2x2 MPI decompositions to 1e-9): a step on a
single device must equal the same step on a 2-D device mesh.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from udales_jax.parallel.mesh import make_mesh, shard_state
from tests.test_core import make_cfg, make_model, init_state


@pytest.mark.parametrize("mesh_shape", [(2, 1), (1, 2), (2, 2), (4, 2)])
def test_step_sharding_invariance(mesh_shape):
    model = make_model()
    state = init_state(model)
    ref = jax.jit(model.step)(state)

    mesh = make_mesh(*mesh_shape)
    smodel = make_model()
    smodel.mesh = mesh
    smodel.pois.mesh = mesh
    sstate = shard_state(state, mesh)
    out = jax.jit(smodel.step)(sstate)

    for name in ("u", "v", "w", "thl", "e12"):
        a = np.asarray(getattr(ref.c, name))
        b = np.asarray(getattr(out.c, name))
        np.testing.assert_allclose(b, a, atol=1e-9, rtol=1e-9,
                                   err_msg=f"{name} mesh={mesh_shape}")
    np.testing.assert_allclose(np.asarray(out.pres), np.asarray(ref.pres),
                               atol=1e-9)


def test_multistep_sharding_invariance():
    model = make_model()
    state = init_state(model)
    ref = jax.jit(lambda s: model.run(s, 5))(state)
    mesh = make_mesh(2, 2)
    smodel = make_model()
    smodel.mesh = mesh
    smodel.pois.mesh = mesh
    out = jax.jit(lambda s: smodel.run(s, 5))(shard_state(state, mesh))
    np.testing.assert_allclose(np.asarray(out.c.u), np.asarray(ref.c.u),
                               atol=1e-8, rtol=1e-8)
    np.testing.assert_allclose(np.asarray(out.c.w), np.asarray(ref.c.w),
                               atol=1e-8, rtol=1e-8)


def test_multihost_helpers_single_process():
    """init_distributed is a no-op single-process; global_mesh factors the
    virtual 8-device pool into the expected 2-D mesh."""
    from udales_jax.parallel.multihost import global_mesh, init_distributed
    pid, n = init_distributed()
    assert pid == 0 and n >= 1
    mesh = global_mesh()
    import jax
    assert mesh.devices.size == len(jax.devices())
    assert mesh.axis_names == ("x", "y")
    m2 = global_mesh(4, 2)
    assert m2.devices.shape == (4, 2)
