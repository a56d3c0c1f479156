"""In-solver test runmodes (program.f90:239-275 / tests.f90 equivalents)."""
import dataclasses
from pathlib import Path

import pytest

CASE = Path("/root/reference/examples/101")

pytestmark = pytest.mark.skipif(not CASE.exists(), reason="reference absent")


@pytest.mark.parametrize("rm", [1003, 1004, 1005])
def test_runmode(rm):
    from udales_jax.run import load_case
    from udales_jax.sim import execute_runmode_actions
    m = load_case(CASE, "101")
    m.cfg = dataclasses.replace(
        m.cfg, run=dataclasses.replace(m.cfg.run, runmode=rm))
    assert execute_runmode_actions(m, CASE) == 0


def test_normal_runmode_returns_none():
    from udales_jax.run import load_case
    from udales_jax.sim import execute_runmode_actions
    m = load_case(CASE, "101")
    assert execute_runmode_actions(m, CASE) is None
