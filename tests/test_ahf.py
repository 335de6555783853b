"""Apparent-horizon finder (reference: src/z4c/fastflow.cpp).

The one-puncture (Schwarzschild in isotropic coordinates) initial data
has its apparent horizon at r = M/2 with irreducible mass M — the
standard calibration of horizon finders.
"""

import math

import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build


def test_ylm_orthonormal():
    from athenak_jax.z4c.ahf import FastFlow

    ff = FastFlow(lmax=4, ntheta=16)
    Y = ff.Y
    w = ff.weights
    # <Y_00 Y_00> = 1, cross terms vanish
    for ll in range(5):
        v = float(np.sum(w * Y["Y0"][ll] * Y["Y0"][ll]))
        assert abs(v - 1.0) < 1e-10, (ll, v)
    assert abs(float(np.sum(w * Y["Y0"][0] * Y["Y0"][2]))) < 1e-10
    v = float(np.sum(w * Y["Yc"][(2, 1)] * Y["Yc"][(2, 1)]))
    assert abs(v - 1.0) < 1e-10
    v = float(np.sum(w * Y["Yc"][(2, 1)] * Y["Ys"][(2, 1)]))
    assert abs(v) < 1e-10


DECK = """
<job>
basename = ahf

<mesh>
nghost = 4
nx1 = 64
x1min = -2.0
x1max = 2.0
nx2 = 64
x2min = -2.0
x2max = 2.0
nx3 = 64
x3min = -2.0
x3max = 2.0
ix1_bc = outflow
ox1_bc = outflow
ix2_bc = outflow
ox2_bc = outflow
ix3_bc = outflow
ox3_bc = outflow

<meshblock>
nx1 = 64
nx2 = 64
nx3 = 64

<time>
evolution = dynamic
integrator = rk3
cfl_number = 0.25
nlim = 0
tlim = 1.0

<z4c>
diss = 0.5
lapse_oplog = 2.0
lapse_advect = 1.0
shift_eta = 2.0

<problem>
pgen_name = z4c_one_puncture
punc_ADM_mass = 1.0
"""


def test_ahf_schwarzschild_puncture():
    """AH of puncture initial data: r_mean = M/2, M_irr = M to ~grid
    truncation (reference: fastflow on one-puncture)."""
    from athenak_jax.z4c.ahf import FastFlow, adm_fields_from_z4c

    pin = ParameterInput.from_string(DECK)
    mesh, phys, pgen, driver, state = build(pin)
    state = driver.initialize(state)
    fields = adm_fields_from_z4c(phys, state["u"])
    ff = FastFlow(lmax=6, ntheta=16, flow_iterations=300)
    props = ff.find(mesh, fields, r_guess=0.7)
    assert props is not None, "horizon not found"
    assert abs(props["mass_irr"] - 1.0) < 0.01, props
    assert abs(props["mean_radius"] - 0.5) < 0.03, props
    assert props["S"] < 0.01


TP_DECK = """
<job>
basename = twopunc

<mesh>
nghost = 4
nx1 = 48
x1min = -6.0
x1max = 6.0
nx2 = 48
x2min = -6.0
x2max = 6.0
nx3 = 48
x3min = -6.0
x3max = 6.0
ix1_bc = outflow
ox1_bc = outflow
ix2_bc = outflow
ox2_bc = outflow
ix3_bc = outflow
ox3_bc = outflow

<meshblock>
nx1 = 48
nx2 = 48
nx3 = 48

<time>
evolution = dynamic
integrator = rk3
cfl_number = 0.25
nlim = 0
tlim = 1.0

<z4c>
diss = 0.5
lapse_oplog = 2.0
lapse_advect = 1.0
shift_eta = 2.0

<problem>
pgen_name = z4c_two_punctures
punc_ADM_mass_1 = 1.0
punc_ADM_mass_2 = 1.0
punc1_x1 = -2.5
punc2_x1 = 2.5
"""


def test_two_punctures_brill_lindquist():
    """P=S=0: analytic Brill-Lindquist data — constraints at the
    discretization level; both horizons found with masses ~ m_i."""
    import jax
    from athenak_jax.z4c.ahf import FastFlow, adm_fields_from_z4c

    pin = ParameterInput.from_string(TP_DECK)
    mesh, phys, pgen, driver, state = build(pin)
    state = driver.initialize(state)
    H, M2 = jax.jit(phys.adm_constraints)(state["u"])
    mbi = mesh.mb_indcs
    act = (slice(None), slice(mbi.ks + 4, mbi.ke - 3),
           slice(mbi.js + 4, mbi.je - 3), slice(mbi.is_ + 4, mbi.ie - 3))
    Ha = np.abs(np.asarray(H)[act])
    # away from the punctures the analytic solution satisfies H = 0 to
    # truncation; medians are robust to the puncture spikes
    assert np.median(Ha) < 1e-4

    fields = adm_fields_from_z4c(phys, state["u"])
    ff = FastFlow(lmax=6, ntheta=16, flow_iterations=300)
    p1 = ff.find(mesh, fields, center=(-2.5, 0.0, 0.0), r_guess=0.6)
    ff2 = FastFlow(lmax=6, ntheta=16, flow_iterations=300)
    p2 = ff2.find(mesh, fields, center=(2.5, 0.0, 0.0), r_guess=0.6)
    assert p1 is not None and p2 is not None
    # equal-mass BL at separation d=5: each AH mass is raised by the
    # companion's conformal factor, M_AH ~ m(1 + m/(2d)) = 1.1, plus the
    # ~4% finite-dx bias measured on the single puncture at dx=0.25
    assert abs(p1["mass_irr"] - 1.1) < 0.08, p1
    assert abs(p2["mass_irr"] - 1.1) < 0.08, p2


def test_two_punctures_momentum_solve():
    """With momenta the SOR-solved correction u reduces the Hamiltonian
    constraint vs. the uncorrected Bowen-York superposition."""
    import jax

    args = ["problem/punc1_P_x2=0.2", "problem/punc2_P_x2=-0.2",
            "problem/tp_npoints=48", "problem/tp_iterations=3000"]
    pin = ParameterInput.from_string(TP_DECK)
    pin.modify_from_cmdline(args)
    mesh, phys, pgen, driver, state = build(pin)
    state = driver.initialize(state)
    H, _ = jax.jit(phys.adm_constraints)(state["u"])
    mbi = mesh.mb_indcs
    act = (slice(None), slice(mbi.ks + 4, mbi.ke - 3),
           slice(mbi.js + 4, mbi.je - 3), slice(mbi.is_ + 4, mbi.ie - 3))
    H_solved = float(np.median(np.abs(np.asarray(H)[act])))

    pin2 = ParameterInput.from_string(TP_DECK)
    pin2.modify_from_cmdline(args[:2] + ["problem/tp_npoints=48",
                                         "problem/tp_iterations=2"])
    mesh2, phys2, pgen2, driver2, state2 = build(pin2)
    state2 = driver2.initialize(state2)
    H2, _ = jax.jit(phys2.adm_constraints)(state2["u"])
    H_raw = float(np.median(np.abs(np.asarray(H2)[act])))
    assert H_solved < 0.5 * H_raw, (H_solved, H_raw)
