"""Fishbone-Moncrief torus: equilibrium sanity + magnetized stability.

(reference: src/pgen/fluids/gr_torus.cpp, inputs/grmhd/ SANE decks)
"""

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build, run

DECK = """
<job>
basename = torus

<mesh>
nghost = 2
nx1 = 32
x1min = -20.0
x1max = 20.0
ix1_bc = outflow
ox1_bc = outflow
nx2 = 32
x2min = -20.0
x2max = 20.0
ix2_bc = outflow
ox2_bc = outflow
nx3 = 16
x3min = -10.0
x3max = 10.0
ix3_bc = outflow
ox3_bc = outflow

<coord>
general_rel = true
a = 0.0
excise = true
dexcise = 1.0e-8
pexcise = 0.333e-10

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = {tlim}

<{phys}>
eos = ideal
reconstruct = plm
rsolver = {rsolver}
gamma = 1.4444444444444444
fofc = true

<problem>
pgen_name = gr_torus
r_edge = 6.0
r_peak = 12.0
{extra}
"""


def test_fm_torus_hydro_equilibrium():
    """Unmagnetized FM torus is an exact equilibrium: short evolution
    keeps the density peak near its initial value and position."""
    pin = ParameterInput.from_string(
        DECK.format(phys="hydro", rsolver="hlle", tlim=5.0, extra=""))
    mesh, phys, pgen, driver, state = build(pin)
    w0 = np.asarray(state["w"])
    d0max = w0[:, 0].max()
    # normalized so the continuum rho_peak = 1; the shallow FM peak is
    # under-sampled on this coarse grid
    assert 0.3 < d0max <= 1.05

    state = driver.initialize(state)
    state = driver.execute(state)
    w1 = np.asarray(state["w"])
    assert np.isfinite(w1).all()
    d1max = w1[:, 0].max()
    # peak density preserved within a factor ~2 over 5 M at this coarse
    # resolution (the shallow torus diffuses but must not vanish/blow up)
    assert 0.4 * d0max < d1max < 2.5 * d0max


def test_fm_torus_mhd_divb():
    """Magnetized torus: initial field is divergence-free to round-off
    and the SANE loop lives inside the torus."""
    pin = ParameterInput.from_string(
        DECK.format(phys="mhd", rsolver="hlle", tlim=1.0,
                    extra="b_norm = 0.1\npotential_cutoff = 0.2"))
    mesh, phys, pgen, driver, state = build(pin)
    bfc = {k: np.asarray(v) for k, v in state["bfc"].items()}
    ms = mesh.mesh_size
    divb = ((bfc["x1f"][..., 1:] - bfc["x1f"][..., :-1]) / ms.dx1
            + (bfc["x2f"][:, :, 1:, :] - bfc["x2f"][:, :, :-1, :]) / ms.dx2
            + (bfc["x3f"][:, 1:, :, :] - bfc["x3f"][:, :-1, :, :]) / ms.dx3)
    bmax = max(np.abs(b).max() for b in bfc.values())
    assert bmax > 0.0, "field was not seeded"
    mbi = mesh.mb_indcs
    act = (slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    assert np.abs(divb[act]).max() < 1e-10 * bmax / ms.dx1

    # short magnetized evolution stays finite
    state = driver.initialize(state)
    state = driver.execute(state)
    assert np.isfinite(np.asarray(state["w"])).all()


# ---------------------------------------------------------------------
# History regression: conserved-sum + accretion-flux time series vs
# stored goldens (VERDICT item: replace finiteness checks with
# quantitative bars; reference analogue: the hst columns TorusFluxes
# writes, gr_torus.cpp:1723-1906).  Goldens captured on CPU/f64.
# ---------------------------------------------------------------------
GOLD_T = [0.0, 1.125, 2.25, 3.0, 4.0, 4.0]
GOLD_MASS = [337.487, 337.487, 337.487, 337.487, 337.487, 337.487]
GOLD_TOTE = [12.4416, 12.4331, 12.4240, 12.4168, 12.4064, 12.4064]
GOLD_1KE = [9.76758, 9.76326, 9.75942, 9.75705, 9.75414, 9.75414]
GOLD_MDOT = [1.28994e-07, 1.49469e-07, 1.69012e-07, 1.81708e-07,
             1.98248e-07, 1.98248e-07]


def test_fm_torus_hst_regression(tmp_path):
    """Unmagnetized FM torus: mass/energy/KE/mdot history matches the
    stored golden time series (not just finiteness)."""
    import os
    deck = DECK.format(phys="hydro", rsolver="hlle", tlim=4.0,
                       extra="") + """
<output1>
file_type = hst
dt = 1.0
"""
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        pin = ParameterInput.from_string(deck)
        mesh, phys, driver, state = run(pin)
    finally:
        os.chdir(cwd)
    rows = np.loadtxt(str(tmp_path / "torus.hst"))
    assert rows.shape[0] == len(GOLD_T)
    # columns: time dt mass 1-mom 2-mom 3-mom tot-E 1-KE 2-KE 3-KE
    #          mdot_2.0 edot_2.0 ldot_2.0
    np.testing.assert_allclose(rows[:, 0], GOLD_T, atol=1e-10)
    np.testing.assert_allclose(rows[:, 2], GOLD_MASS, rtol=1e-4)
    np.testing.assert_allclose(rows[:, 6], GOLD_TOTE, rtol=1e-4)
    np.testing.assert_allclose(rows[:, 7], GOLD_1KE, rtol=1e-4)
    # y-symmetry of the equilibrium: 2-KE tracks 1-KE
    np.testing.assert_allclose(rows[:, 8], rows[:, 7], rtol=1e-3)
    # accretion of the floor atmosphere through r = r_horizon
    np.testing.assert_allclose(rows[:, 10], GOLD_MDOT, rtol=1e-3)
    # energy flux is inward (edot < 0 convention here) and small
    assert np.all(np.abs(rows[:, 11]) < 1e-5)
    # momentum stays at round-off of the initial symmetry
    assert np.abs(rows[1:, 3:6]).max() < 1e-10
