"""DynGRMHD through the explicit shard_map (ppermute) cycle.

BNS/GR-torus workloads are the other half of the multi-chip NR story
(reference: the dyngr task list rides the same rank-packed bvals as
hydro, src/tasklist/numerical_relativity.cpp:165-181).  Asserts the
fully coupled TOV star (dyngr + Z4c + Tmunu) matches the single-device
cycle on 8 virtual devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build
from athenak_jax.parallel import make_device_mesh, shard_state

DECK = """
<job>
basename = dyngrshard

<mesh>
nghost = 2
nx1 = 24
x1min = -15.0
x1max = 15.0
nx2 = 24
x2min = -15.0
x2max = 15.0
nx3 = 24
x3min = -15.0
x3max = 15.0
ix1_bc = outflow
ox1_bc = outflow
ix2_bc = outflow
ox2_bc = outflow
ix3_bc = outflow
ox3_bc = outflow

<meshblock>
nx1 = 12
nx2 = 12
nx3 = 12

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.25
tlim = 100.0

<coord>
general_rel = true

<adm>

<z4c>
lapse_oplog = 2.0
lapse_harmonicf = 1.0
lapse_advect = 1.0
shift_ggamma = 0.75
shift_advect = 1.0
shift_eta = 2.0
diss = 0.5
nco = 1
co_0_radius = 2.0

<mhd>
eos = ideal
dyn_eos = ideal
dyn_error = reset_floor
gamma = 2.0
reconstruct = plm
rsolver = llf
dfloor = 1.0e-10
pfloor = 1.0e-12

<problem>
pgen_name = tov
rhoc = 1.28e-3
kappa = 100.0
gamma = 2.0
dr = 2.0e-3
"""


def _run(dmesh, ncyc=2):
    pin = ParameterInput.from_string(DECK)
    mesh, phys, pgen, driver, state = build(pin)
    driver.dmesh = dmesh
    state = driver.initialize(state)
    if dmesh is not None:
        state = shard_state(state, dmesh)
        fn = jax.jit(driver.make_shard_cycle_fn(state))
    else:
        fn = jax.jit(driver.make_cycle_fn())
    dt = jnp.asarray(driver.mesh.dt, dtype=state["u"].dtype)
    for _ in range(ncyc):
        state, dtnew, _ = fn(state, dt)
    return driver, jax.tree_util.tree_map(np.asarray, state), float(dtnew)


@pytest.mark.slow
def test_dyngr_shard_cycle_matches():
    assert len(jax.devices()) >= 8
    _, ref, rdt = _run(None)
    _, sh, sdt = _run(make_device_mesh(8))
    assert np.isclose(rdt, sdt, rtol=1e-12)
    for k in ("u", "w", "T", "z"):
        np.testing.assert_allclose(sh[k], ref[k], rtol=5e-13, atol=1e-16)
    for c in ("x1f", "x2f", "x3f"):
        np.testing.assert_allclose(sh["bfc"][c], ref["bfc"][c],
                                   rtol=5e-13, atol=1e-16)
    np.testing.assert_allclose(sh["co_pos"], ref["co_pos"],
                               rtol=5e-13, atol=1e-16)
