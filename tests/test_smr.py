"""Static mesh refinement: tree construction, mixed-level ghost fill,
and conservative flux correction.

Test strategy mirrors the reference SMR regressions (reference:
tst/scripts checks on refined meshes): exactness of the linear-in-x
ghost reconstruction (cell-average restriction and min-mod prolongation
are both exact for linear data), round-off mass/energy conservation
across refinement boundaries, and a smooth advection problem crossing
the refined patch.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build


def _deck(nx1=32, nx2=32, nx3=1, mb=8, extra="", prob="advection",
          probextra=""):
    mb3 = f"nx3 = {mb}" if nx3 > 1 else ""
    x3blk = "x3min = -0.5\nx3max = 0.5" if nx3 == 1 else \
        "x3min = -1.0\nx3max = 1.0"
    return f"""
<job>
basename = smr

<mesh>
nghost = 2
nx1 = {nx1}
x1min = -1.0
x1max = 1.0
nx2 = {nx2}
x2min = -1.0
x2max = 1.0
nx3 = {nx3}
{x3blk}

<meshblock>
nx1 = {mb}
nx2 = {mb}
{mb3}

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
tlim = 2.0

<hydro>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hllc

<problem>
pgen_name = {prob}
{probextra}
{extra}
"""


def test_tree_construction_2d():
    pin = ParameterInput.from_string(_deck())
    mesh, phys, pgen, driver, state = build(pin)
    # 4x4 root blocks, central 2x2 refined: 12 + 16 = 28 leaves
    assert mesh.nmb_total == 28
    assert mesh.multilevel
    assert np.bincount(mesh.mb_lev).tolist() == [12, 16]
    # fine blocks have half the cell size
    d0 = mesh.mb_size["dx1"][mesh.mb_lev == 0]
    d1 = mesh.mb_size["dx1"][mesh.mb_lev == 1]
    assert np.allclose(d1, d0[0] / 2)
    # leaf areas tile the domain exactly
    area = ((mesh.mb_size["x1max"] - mesh.mb_size["x1min"])
            * (mesh.mb_size["x2max"] - mesh.mb_size["x2min"]))
    assert np.isclose(area.sum(), 4.0)


def test_adaptive_accepted_with_criteria():
    """refinement=adaptive now builds (amr.py); it requires at least one
    <amr_criterion> block like the reference."""
    deck = _deck().replace("refinement = static", "refinement = adaptive")
    pin = ParameterInput.from_string(deck)
    with pytest.raises(ValueError, match="amr_criterion"):
        build(pin)
    deck2 = deck + ("\n<amr_criterion1>\nmethod = min_max\n"
                    "variable = hydro_u_d\nvalue_max = 1.5\n")
    pin2 = ParameterInput.from_string(deck2)
    mesh, phys, pgen, driver, state = build(pin2)
    assert driver.pamr is not None


def _linear_fill_errors(nx3, mb):
    """Fill ghosts of a globally linear field; restriction and min-mod
    prolongation reproduce linear data exactly, so every face-ghost cell
    (transverse-interior part of each slab) must match analytically."""
    pin = ParameterInput.from_string(_deck(nx3=nx3, mb=mb))
    mesh, phys, pgen, driver, state = build(pin)
    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total

    def f(x, y, z):
        return 0.3 + 1.7 * x - 0.9 * y + (0.4 * z if nx3 > 1 else 0.0)

    u = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    for gid in range(nmb):
        x1, x2, x3 = mesh.cell_centers(gid)
        u[gid, :] = f(x1[None, None, :], x2[None, :, None],
                      x3[:, None, None] if nx3 > 1 else 0.0)
    filled = np.asarray(phys.bvals.fill_ghosts(jnp.asarray(u)))

    ng = mbi.ng
    errs = []
    for gid in range(nmb):
        x1, x2, x3 = mesh.cell_centers(gid)
        exact = np.broadcast_to(
            f(x1[None, None, :], x2[None, :, None],
              x3[:, None, None] if nx3 > 1 else 0.0),
            (mbi.ncells3, mbi.ncells2, mbi.ncells1))
        it = slice(mbi.is_, mbi.ie + 1)
        jt = slice(mbi.js, mbi.je + 1)
        kt = slice(mbi.ks, mbi.ke + 1) if nx3 > 1 else slice(None)
        # face slabs (transverse-interior portions), skipping faces on the
        # periodic domain boundary where the linear field wraps
        lev = mesh.mb_lev[gid]
        lloc = mesh.lloc_eachmb[gid]
        nb = [4 << lev, 4 << lev, (4 << lev) if nx3 > 1 else 1]
        slabs = [
            ("x1", 0, (kt, jt, slice(0, ng)), (kt, jt, slice(-ng, None))),
            ("x2", 1, (kt, slice(0, ng), it), (kt, slice(-ng, None), it)),
        ]
        if nx3 > 1:
            slabs.append(("x3", 2, (slice(0, ng), jt, it),
                          (slice(-ng, None), jt, it)))
        for _name, ax, slm, slp in slabs:
            if lloc[ax] > 0:
                errs.append(np.abs(filled[(gid, 0) + slm]
                                   - exact[slm]).max())
            if lloc[ax] < nb[ax] - 1:
                errs.append(np.abs(filled[(gid, 0) + slp]
                                   - exact[slp]).max())
    return max(errs)


def test_linear_ghost_exactness_2d():
    assert _linear_fill_errors(nx3=1, mb=8) < 1e-12


def test_linear_ghost_exactness_3d():
    assert _linear_fill_errors(nx3=32, mb=8) < 1e-12


def _total(mesh, u):
    """Volume-weighted conserved totals (per-block dV on SMR meshes)."""
    mbi = mesh.mb_indcs
    act = u[:, :, :, mbi.js:mbi.je + 1, mbi.is_:mbi.ie + 1] \
        if mbi.nx3 == 1 else \
        u[:, :, mbi.ks:mbi.ke + 1, mbi.js:mbi.je + 1, mbi.is_:mbi.ie + 1]
    dv = mesh.mb_size["dx1"] * mesh.mb_size["dx2"]
    if mbi.nx3 > 1:
        dv = dv * mesh.mb_size["dx3"]
    return (np.asarray(act).sum(axis=(2, 3, 4)) * dv[:, None]).sum(axis=0)


def test_conservation_across_levels():
    """A blast wave crossing refinement boundaries conserves mass and
    energy to round-off thanks to the flux correction."""
    pin = ParameterInput.from_string(_deck(
        prob="blast",
        probextra="inner_radius = 0.15\nouter_radius = 0.3\nprat = 20.0",
        extra="").replace("tlim = 2.0", "tlim = 0.2"))
    mesh, phys, pgen, driver, state = build(pin)
    state = driver.initialize(state)
    tot0 = _total(mesh, state["u"])
    state = driver.execute(state)
    tot1 = _total(mesh, state["u"])
    assert mesh.ncycle > 10
    # mass and total energy exactly conserved (periodic box)
    assert abs(tot1[0] - tot0[0]) < 1e-12 * abs(tot0[0])
    assert abs(tot1[4] - tot0[4]) < 1e-12 * abs(tot0[4])
    assert not np.isnan(np.asarray(state["u"])).any()


def test_advection_through_refined_patch():
    """A smooth over-density advected through the refined patch returns
    close to the IC after one period, with no artifacts at the level
    boundaries (amplitude preserved to a few percent with PLM)."""
    pin = ParameterInput.from_string(_deck(
        prob="advection",
        probextra="flow_dir = 1\niproblem = 2\nvelocity = 1.0\namp = 0.5"))
    mesh, phys, pgen, driver, state = build(pin)
    state = driver.initialize(state)
    d0 = np.asarray(state["u"][:, 0]).copy()
    tot0 = _total(mesh, state["u"])
    state = driver.execute(state)  # tlim = 2.0 = one period
    d1 = np.asarray(state["u"][:, 0])
    tot1 = _total(mesh, state["u"])
    mbi = mesh.mb_indcs
    sl = (slice(None), 0, slice(mbi.js, mbi.je + 1),
          slice(mbi.is_, mbi.ie + 1))
    err = np.abs(d1[:, 0][sl[0], sl[2], sl[3]]
                 - d0[:, 0][sl[0], sl[2], sl[3]]).mean()
    assert abs(tot1[0] - tot0[0]) < 1e-12 * abs(tot0[0])
    assert err < 0.05
    assert not np.isnan(d1).any()


def test_gr_bondi_smr_stationary():
    """GR hydro on SMR: the Bondi solution stays stationary with a
    refined patch around the hole (reference flagship SMR use case,
    reference: inputs/grmhd/gr_fm_torus_sane_8_4.athinput)."""
    deck = """
<job>
basename = gr_bondi_smr

<mesh>
nghost = 2
nx1 = 32
x1min = -10.0
x1max = 10.0
ix1_bc = user
ox1_bc = user
nx2 = 32
x2min = -10.0
x2max = 10.0
ix2_bc = user
ox2_bc = user
nx3 = 32
x3min = -10.0
x3max = 10.0
ix3_bc = user
ox3_bc = user

<meshblock>
nx1 = 16
nx2 = 16
nx3 = 16

<mesh_refinement>
refinement = static

<refined_region1>
level = 1
x1min = -5.0
x1max = 5.0
x2min = -5.0
x2max = 5.0
x3min = -5.0
x3max = 5.0

<coord>
general_rel = true
a = 0.0
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
    import os
    from athenak_jax.main import run
    pin = ParameterInput.from_string(deck)
    mesh, phys, driver, state = run(pin)
    assert mesh.multilevel and mesh.nmb_total > 8
    fname = "gr_bondi_smr-errs.dat"
    assert os.path.exists(fname)
    data = np.loadtxt(fname)
    os.remove(fname)
    rms_l1 = float(np.atleast_2d(data)[-1, 4])
    assert rms_l1 < 5.0e-3, f"Bondi(SMR) deviated: RMS-L1 = {rms_l1}"
    assert np.isfinite(np.asarray(state["w"])).all()


def test_prolong_primitives_consistency():
    """<mesh_refinement>/prolong_primitives=true: mixed-level ghosts are
    prolonged in primitives, and u's ghost cells equal p2c(w) exactly
    (reference: prolong_prims.cpp Cons/PrimToConsFineBndry).  The
    interior solution stays close to the default-path run."""
    extra = "\nprolong_primitives = true"
    deck = _deck(prob="blast",
                 probextra="inner_radius = 0.1\nouter_radius = 0.25\n"
                           "prat = 10.0")
    deck_pp = deck.replace("refinement = static",
                           "refinement = static" + extra)
    pin = ParameterInput.from_string(deck_pp)
    pin.modify_from_cmdline(["time/nlim=8"])
    mesh, phys, pgen, driver, state = build(pin)
    assert phys.bvals.prolong_prims
    state = driver.initialize(state)
    state = driver.execute(state)
    u = np.asarray(state["u"])
    w = np.asarray(state["w"])
    assert np.isfinite(u).all() and np.isfinite(w).all()
    assert w[:, 0].min() > 0.0
    # ghost-cell consistency: u == p2c(w) everywhere in the ghosts
    import jax
    u2 = np.asarray(jax.jit(phys.prim_to_cons)(state["w"]))
    mask = np.asarray(phys.bvals._ghost_mask())[0, 0]
    np.testing.assert_allclose(
        np.broadcast_to(mask, u.shape) * u,
        np.broadcast_to(mask, u.shape) * u2, rtol=1e-12, atol=1e-12)

    # default path for comparison: solutions agree to truncation level
    pin2 = ParameterInput.from_string(deck)
    pin2.modify_from_cmdline(["time/nlim=8"])
    mesh2, phys2, pgen2, driver2, state2 = build(pin2)
    assert not phys2.bvals.prolong_prims
    state2 = driver2.initialize(state2)
    state2 = driver2.execute(state2)
    mbi = mesh.mb_indcs
    act = (slice(None), slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    du = np.abs(u[act] - np.asarray(state2["u"])[act])
    assert du.max() < 0.05 * np.abs(np.asarray(state2["u"])[act]).max()
