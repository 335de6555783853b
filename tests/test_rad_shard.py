"""Radiation through the explicit shard_map (ppermute) cycle.

The reference serves radiation ghost exchange with the same rank-packed
MPI path as hydro (reference: src/bvals/bvals_cc.cpp:42-289); the angle
axis stays on-device (one device holds all angles of its blocks, like a
rank holds all angles of its MeshBlocks).  These tests assert that

  * a Kerr beam (spatially varying per-block tetrad tables, excision,
    user BCs, angular fluxes) on 8 virtual devices matches 1 device,
  * the coupled radiation-hydro linear wave (implicit coupling with the
    norm_to_tet per-block tables) matches 1 device, and
  * the compiled HLO moves halos with collective-permutes, not
    all-gathers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build
from athenak_jax.parallel import make_device_mesh

from test_rad_gr import BEAM_DECK, RAD_LWAVE_DECK

# 8 meshblocks along x1 so every virtual device owns exactly one block
LWAVE_SHARD_DECK = RAD_LWAVE_DECK.replace(
    "nx1 = 32\nx1min", "nx1 = 64\nx1min")


def _run(deck, dmesh, ncyc=2):
    pin = ParameterInput.from_string(deck)
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
    if dmesh is not None and any(
            lf.shape[0] != mesh.nmb_total
            for lf in jax.tree_util.tree_leaves(state)):
        from athenak_jax.parallel.shard_comm import (shard_layout,
                                                     unpad_state)
        state = unpad_state(
            state, shard_layout(mesh, dmesh.devices.size))
    return driver, jax.tree_util.tree_map(np.asarray, state), float(dtnew)


def test_rad_beam_kerr_shard_bit_matches():
    """Kerr beam: per-block tetrads, excision mask, shard-safe zero BCs.

    Agreement to f64 reassociation eps (the shard_map program fuses
    reductions differently), same standard as test_z4c_shard."""
    assert len(jax.devices()) >= 8
    _, ref, rdt = _run(BEAM_DECK, None)
    _, sh, sdt = _run(BEAM_DECK, make_device_mesh(8))
    assert np.isclose(rdt, sdt, rtol=1e-12)
    np.testing.assert_allclose(sh["u"], ref["u"], rtol=5e-13, atol=1e-16)


@pytest.mark.slow
def test_rad_fluid_lwave_shard_bit_matches():
    """Coupled radiation-hydro: the implicit coupling (tet_quantities /
    norm_to_tet tables) under shard_map matches one device."""
    assert len(jax.devices()) >= 8
    _, ref, rdt = _run(LWAVE_SHARD_DECK, None)
    _, sh, sdt = _run(LWAVE_SHARD_DECK, make_device_mesh(8))
    assert np.isclose(rdt, sdt, rtol=1e-12)
    for k in ("u", "i0"):
        np.testing.assert_allclose(sh[k], ref[k], rtol=5e-13, atol=1e-16)


def test_rad_shard_hlo_no_allgather():
    assert len(jax.devices()) >= 8
    pin = ParameterInput.from_string(LWAVE_SHARD_DECK)
    mesh, phys, pgen, driver, state = build(pin)
    assert type(phys).__name__ == "RadiationFluid"
    dmesh = make_device_mesh(8)
    driver.dmesh = dmesh
    state = driver.initialize(state)
    from athenak_jax.parallel import shard_state
    state = shard_state(state, dmesh)
    fn = driver.make_shard_cycle_fn(state)
    dt = jnp.asarray(driver.mesh.dt, dtype=state["u"].dtype)
    txt = jax.jit(fn).lower(state, dt).compile().as_text()
    assert "collective-permute" in txt
    # admissible all-reduces: dt pmin + coupling counters (reductions);
    # the halo path must not fall back to whole-axis gathers
    assert "all-gather" not in txt
    assert "all-to-all" not in txt
