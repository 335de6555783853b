"""Z4c AMR criteria + on-device puncture trackers.

Covers the reference's <z4c_amr> strategies (src/z4c/z4c_amr.cpp):
chi-min and dchi-max block flags, tracker-following refinement with the
exact AABB-clamped distance test, and the radius_N minimum-level
shells — plus the device-state tracker integration (state["co_pos"],
z4c.post_cycle) that replaces the reference's host-side shift
interpolation (compact_object_tracker.cpp).
"""

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build

DECK = """
<job>
basename = z4camr

<mesh>
nghost = 4
nx1 = 16
x1min = -8.0
x1max = 8.0
ix1_bc = outflow
ox1_bc = outflow
nx2 = 16
x2min = -8.0
x2max = 8.0
ix2_bc = outflow
ox2_bc = outflow
nx3 = 16
x3min = -8.0
x3max = 8.0
ix3_bc = outflow
ox3_bc = outflow

<meshblock>
nx1 = 8
nx2 = 8
nx3 = 8

<mesh_refinement>
refinement = adaptive
num_levels = 2
refinement_interval = 1

<z4c_amr>
{z4c_amr}

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.25
tlim = 10.0
nlim = {nlim}

<z4c>
diss = 0.5
damp_kappa1 = 0.02
{z4c_extra}

<problem>
pgen_name = z4c_one_puncture
punc_ADM_mass = 1.0
"""


def _build(z4c_amr, z4c_extra="", nlim=0):
    pin = ParameterInput.from_string(
        DECK.format(z4c_amr=z4c_amr, z4c_extra=z4c_extra, nlim=nlim))
    return build(pin)


def test_device_interp_matches_host():
    """On-device multi-block trilinear interp == host interp_to_points."""
    import jax

    from athenak_jax.z4c.weyl import interp_to_points
    from athenak_jax.z4c.z4c_amr import device_interp

    mesh, phys, pgen, driver, state = _build("method = trivial")
    u = np.asarray(state["u"])
    rng = np.random.default_rng(7)
    pts = rng.uniform(-6.0, 6.0, size=(12, 3))
    got = np.asarray(jax.jit(
        lambda uu, pp: device_interp(mesh, uu, [0, 5], pp))(
            state["u"], np.asarray(pts)))
    for ci, c in enumerate((0, 5)):
        want = interp_to_points(mesh, u[:, c], pts)
        np.testing.assert_allclose(got[:, ci], want, rtol=1e-10,
                                   atol=1e-12)


def test_chi_min_flags():
    """chi method: only puncture-containing blocks flag +1; far blocks
    with min chi > 1.25*thresh flag -1 (z4c_amr.cpp:133-176)."""
    mesh, phys, pgen, driver, state = _build(
        "method = chi\nchi_min = 0.2")
    pamr = driver.pamr
    assert pamr.z4c_amr is not None and pamr.z4c_amr.method == "chi"
    pamr.ncyc_since_ref[:] = 99     # lift the interval veto
    flags = pamr.check_flags(state, mesh, phys)
    # puncture at origin: the 8 root blocks all touch the origin corner,
    # where chi -> 0 < 0.2
    assert (flags == 1).all()

    # a larger threshold cannot mark more blocks derefinable than total
    pamr.z4c_amr.chi_thresh = 1e-6
    pamr._flag_fn = None
    flags = pamr.check_flags(state, mesh, phys)
    # root blocks may not derefine below level 0 (veto)
    assert (flags == 0).all()


def test_dchi_max_flags():
    """dchi method flags the steep-gradient (puncture) blocks."""
    mesh, phys, pgen, driver, state = _build(
        "method = dchi\ndchi_max = 0.05")
    pamr = driver.pamr
    pamr.ncyc_since_ref[:] = 99
    flags = pamr.check_flags(state, mesh, phys)
    assert (flags == 1).any()


def test_tracker_refines_around_moving_co():
    """tracker method: refinement exactly covers the AABB-clamped
    distance test around state["co_pos"] (z4c_amr.cpp:72-131)."""
    mesh, phys, pgen, driver, state = _build(
        "method = tracker",
        z4c_extra="nco = 1\nco_0_x = 3.0\nco_0_y = 3.0\nco_0_z = 3.0\n"
                  "co_0_radius = 1.0\nco_0_reflevel = 1")
    assert phys.nco == 1
    assert "co_pos" in state
    pamr = driver.pamr
    pamr.ncyc_since_ref[:] = 99
    flags = pamr.check_flags(state, mesh, phys)
    sz = mesh.mb_size
    inside = ((sz["x1min"] <= 3.0) & (sz["x1max"] >= 3.0)
              & (sz["x2min"] <= 3.0) & (sz["x2max"] >= 3.0)
              & (sz["x3min"] <= 3.0) & (sz["x3max"] >= 3.0))
    assert (flags[inside] == 1).all()
    # blocks further than the radius from the tracker want derefinement,
    # vetoed to 0 at root level
    assert (flags[~inside] == 0).all()

    # move the tracker on device: far blocks stop being flagged
    import jax.numpy as jnp
    state2 = dict(state, co_pos=jnp.asarray([[-5.0, -5.0, -5.0]],
                                            state["u"].dtype))
    flags2 = pamr.check_flags(state2, mesh, phys)
    hit2 = ((sz["x1min"] <= -5.0) & (sz["x1max"] >= -5.0)
            & (sz["x2min"] <= -5.0) & (sz["x2max"] >= -5.0)
            & (sz["x3min"] <= -5.0) & (sz["x3max"] >= -5.0))
    assert (flags2[hit2] == 1).all()
    assert (flags2[inside & ~hit2] == 0).all()


def test_radius_shells_enforce_min_level():
    """radius_N_rad shells (RefineRadii, z4c_amr.cpp:228-275) force a
    minimum level inside the shell even with method=trivial."""
    mesh, phys, pgen, driver, state = _build(
        "method = trivial\nradius_0_rad = 4.0\nradius_0_reflevel = 1")
    pamr = driver.pamr
    pamr.ncyc_since_ref[:] = 99
    flags = pamr.check_flags(state, mesh, phys)
    # every root block has its origin corner at r=0 < 4 -> refine
    assert (flags == 1).all()


@pytest.mark.slow
def test_tracker_amr_evolves_and_follows():
    """End-to-end: adaptive z4c run with tracker criterion evolves, the
    tree refines around the puncture, and the on-device tracker state
    stays finite and near the (static) puncture."""
    mesh, phys, pgen, driver, state = _build(
        "method = tracker",
        z4c_extra="nco = 1\nco_0_radius = 2.0\nco_0_reflevel = 1",
        nlim=3)
    state = driver.initialize(state)
    state = driver.execute(state)
    mesh = driver.mesh
    assert mesh.mb_lev.max() == 1
    # the refined region covers the tracker: some level-1 block
    # contains the origin (children of a refined root block span the
    # whole parent, so far-corner children are expected)
    sz = mesh.mb_size
    fine = mesh.mb_lev == 1
    at_origin = ((sz["x1min"] <= 0.0) & (sz["x1max"] >= 0.0)
                 & (sz["x2min"] <= 0.0) & (sz["x2max"] >= 0.0)
                 & (sz["x3min"] <= 0.0) & (sz["x3max"] >= 0.0))
    assert (fine & at_origin).any()
    # tracker survived the rebuild in device state
    assert "co_pos" in state
    pos = np.asarray(state["co_pos"])
    assert np.isfinite(pos).all() and np.abs(pos).max() < 1.0
