"""Block-axis sharding: sharded cycle must match the single-device cycle.

Exercises the analogue of the reference's MPI domain
decomposition (reference: src/mesh/load_balance.cpp, bvals_cc.cpp) on the
8-virtual-device CPU mesh configured in conftest.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build
from athenak_jax.parallel import (block_sharding, make_device_mesh,
                                  shard_state)

DECK = """
<job>
basename = shard_blast

<mesh>
nghost = 2
nx1 = 32
x1min = -1.0
x1max = 1.0
nx2 = 16
x2min = -0.5
x2max = 0.5
nx3 = 16
x3min = -0.5
x3max = 0.5

<meshblock>
nx1 = 8
nx2 = 8
nx3 = 8

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 1.0

<mhd>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hlld

<problem>
pgen_name = blast
inner_radius = 0.1
outer_radius = 0.25
prat = 100.0
b_amb = 0.1
"""


def _run_cycles(dmesh, ncyc=3):
    pin = ParameterInput.from_string(DECK)
    pin.set_value("mesh", "coalesce", "false")
    mesh, phys, pgen, driver, state = build(pin)
    driver.dmesh = dmesh
    state = driver.initialize(state)
    cycle = jax.jit(driver.make_cycle_fn())
    dt = jnp.asarray(driver.mesh.dt, dtype=state["u"].dtype)
    for _ in range(ncyc):
        state, dtnew, _ = cycle(state, dt)
    # compare in gid-ordered block layout: strip pool padding / pencil
    # lane packing (the single-device pool packs x1-adjacent blocks into
    # 128-lane pencils; outputs go through the same view)
    state = driver._unpadded(state)
    return jax.tree_util.tree_map(np.asarray, state), float(dtnew)


def test_sharded_cycle_matches_single_device():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    ref_state, ref_dt = _run_cycles(None)
    sh_state, sh_dt = _run_cycles(make_device_mesh(8))
    assert np.isclose(ref_dt, sh_dt, rtol=1e-12)
    for key in ("u", "w"):
        np.testing.assert_allclose(
            sh_state[key], ref_state[key], rtol=1e-12, atol=1e-14)
    for comp in ("x1f", "x2f", "x3f"):
        np.testing.assert_allclose(
            sh_state["bfc"][comp], ref_state["bfc"][comp],
            rtol=1e-12, atol=1e-14)


def test_state_sharding_layout():
    pin = ParameterInput.from_string(DECK)
    mesh, phys, pgen, driver, state = build(pin)
    dmesh = make_device_mesh(8)
    state = shard_state(state, dmesh)
    shard_shapes = [s.data.shape for s in state["u"].addressable_shards]
    assert len(shard_shapes) == 8
    assert all(s[0] == mesh.nmb_total // 8 for s in shard_shapes)
