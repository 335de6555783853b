"""Z4c through the explicit shard_map (ppermute) cycle.

The NR stack is exactly the workload multi-chip exists for in this code
family (BBH/BNS); the reference serves z4c ghost exchange with the same
rank-packed MPI path as hydro (reference: src/bvals/bvals_cc.cpp:42-289,
src/tasklist/numerical_relativity.cpp:165-181).  These tests assert the
Z4c cycle — Sommerfeld rows, KO dissipation, puncture-tracker ODE —
bit-matches the single-device cycle on 8 virtual devices and moves halos
with collective-permutes, not all-gathers.
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
basename = z4cshard

<mesh>
nghost = 2
nx1 = 16
x1min = -4.0
x1max = 4.0
ix1_bc = outflow
ox1_bc = outflow
nx2 = 16
x2min = -4.0
x2max = 4.0
ix2_bc = outflow
ox2_bc = outflow
nx3 = 32
x3min = -8.0
x3max = 8.0
ix3_bc = outflow
ox3_bc = outflow

<meshblock>
nx1 = 16
nx2 = 16
nx3 = 4

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.25
tlim = 1.0

<z4c>
diss = 0.5
damp_kappa1 = 0.02
nco = 1
co_0_radius = 1.0

<problem>
pgen_name = z4c_one_puncture
punc_ADM_mass = 1.0
"""


def _run(dmesh, ncyc=2):
    pin = ParameterInput.from_string(DECK)
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
    return driver, jax.tree_util.tree_map(np.asarray, state), float(dtnew)


@pytest.mark.slow
def test_z4c_shard_cycle_bit_matches():
    assert len(jax.devices()) >= 8
    _, ref, rdt = _run(None)
    _, sh, sdt = _run(make_device_mesh(8))
    assert np.isclose(rdt, sdt, rtol=1e-12)
    # XLA fuses the long Z4c RHS chains differently under shard_map, so
    # agreement is to f64 reassociation eps (same standard as
    # test_shard_comm.test_shard_cycle_amr_matches), not bit-exact
    np.testing.assert_allclose(sh["u"], ref["u"], rtol=5e-13, atol=1e-16)
    # tracker positions replicated + matching the 1-device ODE
    np.testing.assert_allclose(sh["co_pos"], ref["co_pos"],
                               rtol=5e-13, atol=1e-16)
    assert np.isfinite(ref["co_pos"]).all()


@pytest.mark.slow
def test_z4c_shard_cycle_hlo_no_allgather():
    assert len(jax.devices()) >= 8
    pin = ParameterInput.from_string(DECK)
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
    # the halo path must not fall back to whole-axis gathers; the only
    # admissible all-reduces are the dt pmin / counter psums / tracker
    # psum (reductions, not gathers)
    assert "all-gather" not in txt
    assert "all-to-all" not in txt
