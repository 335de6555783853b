"""Explicit shard_map halo exchange: correctness + communication pattern.

The reference exchanges ghost zones with rank-packed point-to-point MPI
messages (reference: src/bvals/bvals_cc.cpp:42-255).  The JAX
equivalent is a shard_map cycle whose halo exchange ships only ng-thick
neighbor slabs via jax.lax.ppermute.  These tests assert:

  * bit-match vs the single-device cycle (like test_sharding.py, but
    through the explicit ppermute path),
  * the compiled HLO moves data with collective-permutes, NOT all-gathers,
  * non-divisible block counts run via block-pool padding (the reference
    load-balances any nmb >= nranks, src/mesh/load_balance.cpp:55-63).
"""

import jax
import jax.numpy as jnp
import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build
from athenak_jax.parallel import make_device_mesh

DECK = """
<job>
basename = shardcomm

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
ix1_bc = outflow
ox1_bc = outflow

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


def _run(deck, dmesh, ncyc=3):
    pin = ParameterInput.from_string(deck)
    # keep the block pool: the single-device reference must match the
    # sharded pool shape (coalescing is its own transform, test_coalesce)
    pin.set_value("mesh", "coalesce", "false")
    mesh, phys, pgen, driver, state = build(pin)
    driver.dmesh = dmesh
    state = driver.initialize(state)
    if dmesh is not None:
        fn = jax.jit(driver.make_shard_cycle_fn(state))
    else:
        fn = jax.jit(driver.make_cycle_fn())
    dt = jnp.asarray(driver.mesh.dt, dtype=state["u"].dtype)
    for _ in range(ncyc):
        state, dtnew, _ = fn(state, dt)
    return driver, jax.tree_util.tree_map(np.asarray, state), float(dtnew)


def test_shard_cycle_bit_matches_single_device():
    assert len(jax.devices()) >= 8
    _, ref, rdt = _run(DECK, None)
    _, sh, sdt = _run(DECK, make_device_mesh(8))
    assert np.isclose(rdt, sdt, rtol=1e-12)
    for k in ("u", "w"):
        np.testing.assert_array_equal(sh[k], ref[k])
    for c in ("x1f", "x2f", "x3f"):
        np.testing.assert_array_equal(sh["bfc"][c], ref["bfc"][c])


def test_shard_cycle_hlo_uses_collective_permute():
    """The halo must be point-to-point slabs (collective-permute), not a
    whole-axis all-gather — this pins the communication *volume*, which
    the bit-match test alone cannot see."""
    pin = ParameterInput.from_string(DECK)
    mesh, phys, pgen, driver, state = build(pin)
    driver.dmesh = make_device_mesh(8)
    state = driver.initialize(state)
    fn = jax.jit(driver.make_shard_cycle_fn(state))
    dt = jnp.asarray(driver.mesh.dt, dtype=state["u"].dtype)
    txt = fn.lower(state, dt).compile().as_text()
    assert txt.count("collective-permute") > 0
    assert "all-gather" not in txt


def test_nondivisible_block_count_pads():
    """6 blocks on 4 devices: block pool pads to 8, results unchanged."""
    deck = DECK.replace("nx1 = 32", "nx1 = 48") \
               .replace("nx2 = 16", "nx2 = 8") \
               .replace("nx3 = 16", "nx3 = 8")
    d1, ref, rdt = _run(deck, None)
    d2, sh, sdt = _run(deck, make_device_mesh(4))
    assert d1.mesh.nmb_total == 6 and d2._npad == 2
    assert np.isclose(rdt, sdt, rtol=1e-12)
    nmb = d1.mesh.nmb_total
    np.testing.assert_array_equal(sh["u"][:nmb], ref["u"])
    np.testing.assert_array_equal(sh["w"][:nmb], ref["w"])


def test_driver_execute_uses_shard_path():
    """driver.execute picks the shard_map cycle automatically and returns
    an unpadded state."""
    deck = DECK.replace("nx1 = 32", "nx1 = 48") \
               .replace("nx2 = 16", "nx2 = 8") \
               .replace("nx3 = 16", "nx3 = 8") \
               .replace("tlim = 1.0", "tlim = 0.02")
    pin = ParameterInput.from_string(deck)
    mesh, phys, pgen, driver, state = build(pin)
    driver.dmesh = make_device_mesh(4)
    state = driver.initialize(state)
    state = driver.execute(state)
    assert state["u"].shape[0] == mesh.nmb_total
    assert np.all(np.isfinite(np.asarray(state["u"])))


# ---------------------------------------------------------------------------
# mixed-level (SMR) and GR coverage: the route tables must handle
# fine/coarse donor maps (reference: bvals.hpp:61-101 index triples) and
# per-block metric/geometry tables (reference: coordinates.cpp)
# ---------------------------------------------------------------------------
SMR_DECK = """
<job>
basename = shard_smr

<mesh>
nghost = 2
nx1 = 32
x1min = -0.5
x1max = 0.5
nx2 = 32
x2min = -0.5
x2max = 0.5
nx3 = 32
x3min = -0.5
x3max = 0.5

<meshblock>
nx1 = 16
nx2 = 16
nx3 = 16

<mesh_refinement>
refinement = static

<refined_region1>
level = 1
x1min = -0.25
x1max = 0.25
x2min = -0.25
x2max = 0.25
x3min = -0.25
x3max = 0.25

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 1.0

<{phys}>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = {rsolver}

<problem>
pgen_name = blast
inner_radius = 0.1
outer_radius = 0.25
prat = 100.0
b_amb = 0.1
"""

GR_DECK = """
<job>
basename = shard_gr

<mesh>
nghost = 2
nx1 = 32
x1min = -8.0
x1max = 8.0
ix1_bc = outflow
ox1_bc = outflow
nx2 = 16
x2min = -4.0
x2max = 4.0
ix2_bc = outflow
ox2_bc = outflow
nx3 = 16
x3min = -4.0
x3max = 4.0
ix3_bc = outflow
ox3_bc = outflow

<meshblock>
nx1 = 8
nx2 = 8
nx3 = 8

<coord>
general_rel = true
a = 0.3
excise = true
dexcise = 1.0e-8
pexcise = 0.333e-12

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 1.0

<hydro>
eos = ideal
reconstruct = plm
rsolver = hlle
gamma = 1.3333333333333

<problem>
pgen_name = gr_bondi
k_adi = 1.0
r_crit = 8.0
"""


def _assert_state_match(sh, ref, nmb):
    np.testing.assert_array_equal(sh["u"][:nmb], ref["u"])
    np.testing.assert_array_equal(sh["w"][:nmb], ref["w"])
    if "bfc" in ref:
        for c in ("x1f", "x2f", "x3f"):
            np.testing.assert_array_equal(sh["bfc"][c][:nmb],
                                          ref["bfc"][c])


def test_shard_cycle_smr_hydro_bit_matches():
    """SMR: 15 blocks (8 coarse - 1 + 8 fine) across 5 devices; the
    mixed-level restriction/prolongation donors and flux correction run
    through the ppermute route tables."""
    deck = SMR_DECK.format(phys="hydro", rsolver="hllc")
    d1, ref, rdt = _run(deck, None)
    assert d1.phys.multilevel
    d2, sh, sdt = _run(deck, make_device_mesh(5))
    assert np.isclose(rdt, sdt, rtol=1e-12)
    _assert_state_match(sh, ref, d1.mesh.nmb_total)


def test_shard_cycle_smr_mhd_bit_matches():
    """SMR MHD: face-field mixed-level exchange + EMF corrections via
    the route tables (reference: flux_correction_fc.cpp)."""
    deck = SMR_DECK.format(phys="mhd", rsolver="hlld")
    d1, ref, rdt = _run(deck, None)
    d2, sh, sdt = _run(deck, make_device_mesh(5))
    assert np.isclose(rdt, sdt, rtol=1e-12)
    _assert_state_match(sh, ref, d1.mesh.nmb_total)


def test_shard_cycle_gr_matches():
    """GR hydro (Kerr-Schild, excision): per-block metric tables are
    localized per device (comm.local_blocks).

    Tolerance (not bit) match: tracing the cycle under shard_map changes
    XLA fusion/FMA decisions, and the GR c2p cancellation chains near
    the excision boundary amplify that ULP noise to ~1e-10/cycle (the
    same offsets appear with a 1-device shard_map, ruling out any
    routing difference).  A routing bug would produce O(field) errors."""
    d1, ref, rdt = _run(GR_DECK, None)
    assert d1.phys.is_gr
    d2, sh, sdt = _run(GR_DECK, make_device_mesh(8))
    assert np.isclose(rdt, sdt, rtol=1e-12)
    nmb = d1.mesh.nmb_total
    np.testing.assert_allclose(sh["u"][:nmb], ref["u"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(sh["w"][:nmb], ref["w"],
                               rtol=1e-6, atol=1e-7)


def test_shard_cycle_smr_hlo_no_allgather():
    """The mixed-level exchange must also move ng-slabs point-to-point:
    collective-permutes, no all-gathers (comm volume check)."""
    pin = ParameterInput.from_string(
        SMR_DECK.format(phys="mhd", rsolver="hlld"))
    mesh, phys, pgen, driver, state = build(pin)
    driver.dmesh = make_device_mesh(5)
    state = driver.initialize(state)
    fn = jax.jit(driver.make_shard_cycle_fn(state))
    dt = jnp.asarray(driver.mesh.dt, dtype=state["u"].dtype)
    txt = fn.lower(state, dt).compile().as_text()
    assert txt.count("collective-permute") > 0
    assert "all-gather" not in txt


# ---------------------------------------------------------------------
# Multi-device ADAPTIVE meshes: per-epoch redistribution (reference:
# RedistAndRefineMeshBlocks + LoadBalance over the AMR communicator,
# mesh_refinement.cpp:427-560, load_balance.cpp:38-90).
# ---------------------------------------------------------------------
AMR_DECK = """
<job>
basename = shardamr

<mesh>
nghost = 2
nx1 = 32
x1min = -0.5
x1max = 0.5
nx2 = 32
x2min = -0.5
x2max = 0.5
nx3 = 1
x3min = -0.5
x3max = 0.5

<meshblock>
nx1 = 8
nx2 = 8
nx3 = 1

<mesh_refinement>
refinement = adaptive
num_levels = 3
ncycle_check = 2
refinement_interval = 2
block_pool = false

<amr_criterion1>
method = min_max
variable = mhd_u_d
value_max = 1.5

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
nlim = 14
tlim = 0.5

<mhd>
eos = ideal
reconstruct = plm
rsolver = hlld
gamma = 1.6666666666666667

<problem>
pgen_name = blast
prat = 10.0
drat = 4.0
inner_radius = 0.02
outer_radius = 0.12
b_amb = 0.7071067811865476
"""


def _run_amr(ndev):
    pin = ParameterInput.from_string(AMR_DECK)
    mesh, phys, pgen, driver, state = build(pin)
    if ndev:
        driver.dmesh = make_device_mesh(ndev)
    state = driver.initialize(state)
    state = driver.execute(state)
    return driver, jax.tree_util.tree_map(
        np.asarray, driver._unpadded(state))


def test_shard_cycle_amr_matches():
    """Adaptive run on 8 devices matches single-device: the tree evolves
    identically (refine + derefine + redistribute epochs) under the
    ppermute cycle.  State match is to reassociation epsilon (~1e-29
    measured): the slot-permuted remap changes one summation order in
    restrict_cc; any routing bug would produce O(field) errors."""
    d1, ref = _run_amr(0)
    assert d1.pamr.nmb_created > 0, "tree must evolve during the test"
    assert d1.pamr.nmb_deleted > 0, "tree must also derefine"
    d2, sh = _run_amr(8)
    assert d2.pamr.nmb_created == d1.pamr.nmb_created
    assert d2.pamr.nmb_deleted == d1.pamr.nmb_deleted
    assert d2.mesh.nmb_total == d1.mesh.nmb_total
    # the shard layout was re-established after the tree updates
    assert d2._layout is not None
    assert d2._layout.nmb == d2.mesh.nmb_total
    for k in ("u", "w"):
        np.testing.assert_allclose(sh[k], ref[k], rtol=0, atol=1e-15)
    for c in ("x1f", "x2f", "x3f"):
        np.testing.assert_allclose(sh["bfc"][c], ref["bfc"][c],
                                   rtol=0, atol=1e-15)
