"""Ion-neutral two-fluid ImEx through the explicit shard_map cycle.

The reference serves the ImEx task list through the identical
rank-packed MPI bvals every other physics uses (reference:
src/ion-neutral/ion-neutral_tasks.cpp:95-295, src/bvals/bvals_cc.cpp:
42-289); here both fluids' halos ride the per-peer ppermute routes and
the stiff-residual history shards over the block axis.  Asserts the
8-virtual-device cycle matches single-device bit-near-exactly.
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
basename = inshard

<mesh>
nghost = 2
nx1 = 16
x1min = 0.0
x1max = 1.0
nx2 = 16
x2min = 0.0
x2max = 1.0
nx3 = 16
x3min = 0.0
x3max = 1.0

<meshblock>
nx1 = 8
nx2 = 8
nx3 = 8

<time>
evolution = dynamic
integrator = imex2
cfl_number = 0.3
tlim = 1.0

<hydro>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hllc

<mhd>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hlle

<ion-neutral>
drag_coeff = 4.0

<problem>
pgen_name = twofluid
d_i = 0.4
d_n = 1.2
p_i = 0.6
p_n = 0.6
vx_i = 0.1
vx_n = -0.1
amp = 0.05
b0 = 0.5
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


def test_imex_shard_cycle_matches():
    assert len(jax.devices()) >= 8
    _, ref, rdt = _run(None)
    _, sh, sdt = _run(make_device_mesh(8))
    assert np.isclose(rdt, sdt, rtol=1e-12)
    for k in ("u", "w", "ui", "wi", "ru"):
        np.testing.assert_allclose(sh[k], ref[k], rtol=5e-13, atol=1e-16,
                                   err_msg=k)
    for c in ("x1f", "x2f", "x3f"):
        np.testing.assert_allclose(sh["bfc"][c], ref["bfc"][c],
                                   rtol=5e-13, atol=1e-16)
