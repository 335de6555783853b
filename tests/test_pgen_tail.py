"""Canonical problem-generator tail: shock_cloud, slotted_cyl,
z4c kerr_schild, z4c gauge wave (AWA).

Reference decks: inputs/hydro/slotted_cyl.athinput, shock_cloud
(src/pgen/fluids/shock_cloud.cpp), inputs/z4c/awa decks,
src/pgen/z4c/kerr_schild.cpp.
"""

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.indices import IDN
from athenak_jax.main import build, run

SHOCK_CLOUD = """
<job>
basename = cloud

<mesh>
nghost = 2
nx1 = 40
x1min = -3.0
x1max = 7.0
ix1_bc = inflow
ox1_bc = outflow
nx2 = 16
x2min = -2.0
x2max = 2.0
ix2_bc = periodic
ox2_bc = periodic
nx3 = 1
x3min = -0.5
x3max = 0.5

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 1.2

<hydro>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hllc

<problem>
pgen_name = shock_cloud
Mach = 10.0
drat = 10.0
"""

SLOTTED_CYL = """
<job>
basename = slot

<mesh>
nghost = 2
nx1 = 64
x1min = 0.0
x1max = 1.0
nx2 = 64
x2min = 0.0
x2max = 1.0
nx3 = 1
x3min = -0.5
x3max = 0.5

<time>
evolution = kinematic
integrator = rk2
cfl_number = 0.4
tlim = 0.2

<hydro>
eos = isothermal
iso_sound_speed = 1.0
reconstruct = plm
rsolver = advect
nscalars = 1

<problem>
pgen_name = slotted_cyl
"""

Z4C_DECK = """
<job>
basename = {name}

<mesh>
nghost = {ng}
nx1 = {nx}
x1min = {xmin}
x1max = {xmax}
ix1_bc = {bc}
ox1_bc = {bc}
nx2 = {nx}
x2min = {xmin}
x2max = {xmax}
ix2_bc = {bc}
ox2_bc = {bc}
nx3 = {nx}
x3min = {xmin}
x3max = {xmax}
ix3_bc = {bc}
ox3_bc = {bc}

<time>
evolution = dynamic
integrator = rk3
cfl_number = 0.25
tlim = 10.0
nlim = {nlim}

<z4c>
diss = 0.5
damp_kappa1 = 0.02
{z4c_extra}

<problem>
pgen_name = {pgen}
{prob}
"""


def test_shock_cloud_runs():
    """Mach-10 shock sweeps into the overdense cloud; the inflow BC
    keeps feeding the post-shock state (reference pgen shock_cloud.cpp
    + Rankine-Hugoniot left state)."""
    pin = ParameterInput.from_string(SHOCK_CLOUD)
    mesh, phys, driver, state = run(pin)
    w = np.asarray(state["w"])
    assert np.isfinite(w).all()
    mbi = mesh.mb_indcs
    act = (slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    d = w[:, IDN][act]
    # cloud compression begins: density above both the post-shock (3.88
    # at M=10, gamma=5/3) and initial cloud (10) values somewhere
    assert d.max() > 10.5
    # inflow ghost state survives: post-shock density on the left edge
    gm = 5.0 / 3.0
    dl = (gm + 1.0) / (gm - 1.0 + 2.0 / 100.0)
    assert np.allclose(d[0, 0, :, 0], dl, rtol=1e-3)


def test_slotted_cylinder_advection():
    """Rigid rotation preserves total scalar mass exactly and keeps the
    profile in [0,1]+overshoot bounds (Zalesak's disk)."""
    pin = ParameterInput.from_string(SLOTTED_CYL)
    mesh, phys, driver, state = run(pin)
    u = np.asarray(state["u"])
    assert np.isfinite(u).all()
    mbi = mesh.mb_indcs
    act = (slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    s = u[:, phys.nhydro][act]
    pin0 = ParameterInput.from_string(SLOTTED_CYL)
    mesh0, phys0, pgen0, driver0, st0 = build(pin0)
    s0 = np.asarray(st0["u"])[:, phys0.nhydro][act]
    # conservative remap: total scalar mass preserved to round-off
    assert np.isclose(s.sum(), s0.sum(), rtol=1e-12)
    # bounded profile (PLM limiter keeps over/undershoots small)
    assert s.min() > -0.05 and s.max() < 1.05
    # the disk is still there (PLM at 64^2, 1/5 rotation: measured 0.93)
    assert s.max() > 0.8


@pytest.mark.slow
def test_kerr_schild_constraints_and_evolution():
    """Kerr-Schild data: ADM constraints converge away from the hole,
    and the Z4c evolution with pre-collapsed lapse stays finite."""
    deck = Z4C_DECK.format(
        name="ks", ng=4, nx=32, xmin=-8.0, xmax=8.0, bc="outflow",
        nlim=0, z4c_extra="", pgen="z4c_kerr_schild",
        prob="punc_spin = 0.6")
    pin = ParameterInput.from_string(deck)
    mesh, phys, pgen, driver, state = build(pin)
    u = np.asarray(state["u"])
    assert np.isfinite(u).all()
    H, M2 = phys.adm_constraints(state["u"])
    H = np.asarray(H)
    mbi = mesh.mb_indcs
    # far field (r > 4): pure truncation error of the analytic data
    r2 = None
    Hs = []
    for gid in range(mesh.nmb_total):
        x1, x2, x3 = mesh.cell_centers(gid)
        X1 = x1[None, None, mbi.is_:mbi.ie + 1]
        X2 = x2[None, mbi.js:mbi.je + 1, None]
        X3 = x3[mbi.ks:mbi.ke + 1, None, None]
        far = np.sqrt(X1**2 + X2**2 + X3**2) > 4.0
        Hs.append(H[gid][mbi.ks:mbi.ke + 1, mbi.js:mbi.je + 1,
                         mbi.is_:mbi.ie + 1][far])
    Hfar = np.concatenate(Hs)
    assert np.sqrt(np.mean(Hfar ** 2)) < 5e-4
    # short evolution stays finite with physical lapse
    deck2 = deck.replace("nlim = 0", "nlim = 3")
    pin2 = ParameterInput.from_string(deck2)
    mesh2, phys2, driver2, st2 = run(pin2)
    z = np.asarray(st2["u"])
    assert np.isfinite(z).all()
    from athenak_jax.z4c.z4c import I_ALPHA
    assert z[:, I_ALPHA].min() > 0.0


@pytest.mark.slow
def test_gauge_wave_constraints():
    """AWA gauge wave: exact initial data (constraints at round-off /
    truncation), stable short evolution with the harmonic lapse."""
    deck = Z4C_DECK.format(
        name="gw", ng=4, nx=32, xmin=-0.5, xmax=0.5, bc="periodic",
        nlim=0,
        z4c_extra="lapse_oplog = 0.0\nlapse_harmonicf = 1.0\n"
                  "lapse_harmonic = 1.0\nlapse_advect = 1.0\n"
                  "shift_Gamma = 0.0\nshift_eta = 0.0",
        pgen="z4c_gauge_wave", prob="amp = 0.01")
    pin = ParameterInput.from_string(deck)
    mesh, phys, pgen, driver, state = build(pin)
    state = phys.init_ghosts(state)   # Gamma-seed ghosts need the fill
    H, M2 = phys.adm_constraints(state["u"])
    H = np.asarray(H)
    mbi = mesh.mb_indcs
    act = (slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    # 6th-order truncation of an amp=1e-2 sinusoid at 32^3 (measured
    # 4.2e-7; the conformal-Ricci index fix is what makes this exact)
    assert np.abs(H[act]).max() < 1e-6
    deck2 = deck.replace("nlim = 0", "nlim = 10")
    mesh2, phys2, driver2, st2 = run(ParameterInput.from_string(deck2))
    z = np.asarray(st2["u"])
    assert np.isfinite(z).all()
    H2, _ = phys2.adm_constraints(st2["u"])
    assert np.abs(np.asarray(H2)[act]).max() < 1e-5


def test_current_sheet_runs():
    """Double Harris sheet (reference: current_sheet.cpp): div(B)-free
    tanh field reversals, short MHD evolution stays finite."""
    deck = """
<job>
basename = cs

<mesh>
nghost = 2
nx1 = 32
x1min = -6.0
x1max = 6.0
nx2 = 16
x2min = -3.0
x2max = 3.0
nx3 = 1
x3min = -0.5
x3max = 0.5

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 0.5

<mhd>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hlld

<problem>
pgen_name = current_sheet
epsv = 0.01
epsb = 0.01
"""
    pin = ParameterInput.from_string(deck)
    mesh, phys, driver, state = run(pin)
    assert np.isfinite(np.asarray(state["w"])).all()


@pytest.mark.slow
def test_robust_stability():
    """AWA robust stability: 1e-10 noise on flat space stays at the
    noise level over several crossing times (z4c_stability.cpp)."""
    deck = Z4C_DECK.format(
        name="stab", ng=2, nx=16, xmin=-0.5, xmax=0.5, bc="periodic",
        nlim=50, z4c_extra="", pgen="z4c_stability", prob="rho = 1.0")
    pin = ParameterInput.from_string(deck)
    mesh, phys, driver, state = run(pin)
    u = np.asarray(state["u"])
    assert np.isfinite(u).all()
    from athenak_jax.z4c.z4c import I_GXX, I_ALPHA
    # metric stays within ~100x the seeded 1e-10 noise of Minkowski
    assert np.abs(u[:, I_GXX] - 1.0).max() < 1e-7
    assert np.abs(u[:, I_ALPHA] - 1.0).max() < 1e-7
