"""Turbulence driving through the explicit shard_map (ppermute) cycle.

The driver's volume-weighted integrals (momentum removal + dedt
normalization) are the one piece of turbulence that is global: the
reference reduces them with MPI_Allreduce (reference:
src/srcterms/turb_driver.cpp:742); here they psum over the block axis
via comm.global_sum, while the OU PRNG key is replicated so every
device draws the same driving modes (reference broadcasts the same
amplitudes to all ranks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build
from athenak_jax.parallel import make_device_mesh

DECK = """
<job>
basename = turbshard

<mesh>
nghost = 2
nx1 = 16
x1min = -0.5
x1max = 0.5
nx2 = 16
x2min = -0.5
x2max = 0.5
nx3 = 16
x3min = -0.5
x3max = 0.5

<meshblock>
nx1 = 16
nx2 = 16
nx3 = 2

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 0.5

<hydro>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hllc

<turb_driving>
nlow = 1
nhigh = 2
dedt = 0.1
tcorr = 0.5
rseed = 7

<problem>
pgen_name = turb
"""


def _run(dmesh, ncyc=3):
    pin = ParameterInput.from_string(DECK)
    pin.set_value("mesh", "pencil_pack", "false")
    mesh, phys, pgen, driver, state = build(pin)
    driver.dmesh = dmesh
    state = driver.initialize(state)
    if dmesh is not None:
        from athenak_jax.parallel import shard_state
        state = shard_state(state, dmesh)
        fn = jax.jit(driver.make_shard_cycle_fn(state))
    else:
        fn = jax.jit(driver.make_cycle_fn())
    dt = jnp.asarray(driver.mesh.dt, dtype=state["u"].dtype)
    for _ in range(ncyc):
        state, dtnew, _ = fn(state, dt)
    state = driver._unpadded(state)
    return driver, jax.tree_util.tree_map(np.asarray, state), float(dtnew)


def test_turb_shard_cycle_matches():
    """Driven box: 8 devices match 1 device to f64 reassociation eps
    (the psum reduction order differs from the single jnp.sum)."""
    assert len(jax.devices()) >= 8
    _, ref, rdt = _run(None)
    _, sh, sdt = _run(make_device_mesh(8))
    assert np.isclose(rdt, sdt, rtol=1e-12)
    np.testing.assert_allclose(sh["u"], ref["u"], rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(sh["turb_force"], ref["turb_force"],
                               rtol=1e-10, atol=1e-13)
    # the OU key advanced identically (replicated) on every device
    np.testing.assert_array_equal(sh["turb_key"], ref["turb_key"])
    # driving actually injected energy (not a silent no-op under
    # shard_map)
    assert np.abs(sh["turb_force"]).max() > 0.0


def test_turb_shard_hlo_no_allgather():
    assert len(jax.devices()) >= 8
    pin = ParameterInput.from_string(DECK)
    pin.set_value("mesh", "pencil_pack", "false")
    mesh, phys, pgen, driver, state = build(pin)
    dmesh = make_device_mesh(8)
    driver.dmesh = dmesh
    state = driver.initialize(state)
    from athenak_jax.parallel import shard_state
    state = shard_state(state, dmesh)
    fn = driver.make_shard_cycle_fn(state)
    dt = jnp.asarray(driver.mesh.dt, dtype=state["u"].dtype)
    txt = jax.jit(fn).lower(state, dt).compile().as_text()
    assert "collective-permute" in txt
    # admissible all-reduces: dt pmin + the turbulence normalization
    # psums (reductions); no whole-axis gathers
    assert "all-gather" not in txt
    assert "all-to-all" not in txt
