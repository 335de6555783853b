"""Z4c on statically refined meshes: 4th-order mixed-level prolongation
(reference: prolongation.hpp HighOrderProlongCC + z4c on multilevel
meshes) and 8th-order FD operators (nghost=5).
"""

import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build, run

DECK = """
<job>
basename = z4csmr

<mesh>
nghost = 4
nx1 = 16
x1min = -2.0
x1max = 2.0
nx2 = 16
x2min = -2.0
x2max = 2.0
nx3 = 16
x3min = -2.0
x3max = 2.0

<meshblock>
nx1 = 8
nx2 = 8
nx3 = 8

<mesh_refinement>
refinement = static
num_levels = 2

<refined_region1>
level = 1
x1min = -1.0
x1max = 0.0
x2min = -1.0
x2max = 0.0
x3min = -1.0
x3max = 0.0

<time>
evolution = dynamic
integrator = rk3
cfl_number = 0.25
nlim = 6
tlim = 1.0

<z4c>
diss = 0.5
damp_kappa1 = 0.02
damp_kappa2 = 0.0
lapse_oplog = 2.0
lapse_advect = 1.0
shift_eta = 2.0

<problem>
pgen_name = z4c_linear_wave
amp = 0.0
kx1 = 1.0
kx2 = 0.0
kx3 = 0.0
"""


def test_flat_fixed_point_on_smr():
    """Minkowski in trivial gauge stays an exact fixed point through the
    mixed-level (4th-order) ghost machinery."""
    pin = ParameterInput.from_string(DECK)
    mesh, phys, pgen, driver, state = build(pin)
    assert mesh.multilevel and phys.multilevel
    assert phys.bvals.prolong_order == 4
    state = driver.initialize(state)
    u0 = np.asarray(state["u"]).copy()
    state = driver.execute(state)
    mbi = mesh.mb_indcs
    act = (slice(None), slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    drift = np.abs(np.asarray(state["u"])[act] - u0[act]).max()
    assert drift < 1e-12, f"flat-space drift {drift:g} on SMR"


def test_z4c_wave_on_smr_stable():
    """A small-amplitude gauge wave crosses the refined region without
    blowing up; Hamiltonian constraint stays at the linear level."""
    pin = ParameterInput.from_string(DECK)
    pin.modify_from_cmdline(["problem/amp=1.0e-6", "time/nlim=16"])
    mesh, phys, pgen, driver, state = build(pin)
    state = driver.initialize(state)
    state = driver.execute(state)
    u = np.asarray(state["u"])
    assert np.isfinite(u).all()
    import jax
    H, M2 = jax.jit(phys.adm_constraints)(state["u"])
    mbi = mesh.mb_indcs
    act = (slice(None), slice(mbi.ks + 2, mbi.ke - 1),
           slice(mbi.js + 2, mbi.je - 1), slice(mbi.is_ + 2, mbi.ie - 1))
    Hmax = np.abs(np.asarray(H)[act]).max()
    assert Hmax < 5e-8, f"H constraint {Hmax:g} (expected linear level)"


def test_fd8_flat_fixed_point():
    """nghost=5 (8th-order FD) uniform run: flat space exact, wave run
    finite (reference: 8th-order operator option)."""
    deck = DECK.replace("nghost = 4", "nghost = 5")
    deck = deck.replace("refinement = static", "refinement = none")
    pin = ParameterInput.from_string(deck)
    pin.modify_from_cmdline(["time/nlim=4"])
    mesh, phys, pgen, driver, state = build(pin)
    state = driver.initialize(state)
    u0 = np.asarray(state["u"]).copy()
    state = driver.execute(state)
    mbi = mesh.mb_indcs
    act = (slice(None), slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    drift = np.abs(np.asarray(state["u"])[act] - u0[act]).max()
    assert drift < 1e-12


def test_puncture_on_smr(tmp_path):
    """One-puncture evolution on a 2-level SMR mesh: lapse collapses at
    the puncture, fields stay finite (reference: the production BBH path
    runs punctures on deep SMR trees).  Periodic BCs keep the jitted
    cycle small (the Sommerfeld branches triple XLA compile time and are
    covered by the uniform puncture test)."""
    deck = """
<job>
basename = {base}

<mesh>
nghost = 4
nx1 = 16
x1min = -8.0
x1max = 8.0
nx2 = 16
x2min = -8.0
x2max = 8.0
nx3 = 16
x3min = -8.0
x3max = 8.0

<meshblock>
nx1 = 8
nx2 = 8
nx3 = 8

<mesh_refinement>
refinement = static
num_levels = 2

<refined_region1>
level = 1
x1min = -4.0
x1max = 4.0
x2min = -4.0
x2max = 4.0
x3min = -4.0
x3max = 4.0

<time>
evolution = dynamic
integrator = rk3
cfl_number = 0.25
nlim = 8
tlim = 10.0

<z4c>
diss = 0.5
damp_kappa1 = 0.02
damp_kappa2 = 0.0
lapse_oplog = 2.0
lapse_advect = 1.0
shift_eta = 2.0
chi_min_floor = 1.0e-12

<problem>
pgen_name = z4c_one_puncture
punc_ADM_mass = 1.0
""".format(base=f"{tmp_path}/punc")
    pin = ParameterInput.from_string(deck)
    mesh, phys, driver, state = run(pin)
    u = np.asarray(state["u"])
    assert np.isfinite(u).all()
    from athenak_jax.z4c.z4c import I_ALPHA, I_CHI
    alpha = u[:, I_ALPHA]
    chi = u[:, I_CHI]
    assert alpha.min() > 0.0
    assert alpha.max() <= 1.05
    assert chi.min() > 0.0
