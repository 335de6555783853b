"""Dynamical GRMHD on statically refined meshes.

Reference capability: dyn_grmhd runs on SMR/AMR (refined TOV + AMR
linear waves, /root/reference/tst/test_suite/dyngrmhd/
test_dyngrmhd_lwave3d_amr_gpu.py, src/dyn_grmhd/).  Here: the TOV star
with a refined region over the stellar interior — Cowling (fixed ADM)
and fully coupled Z4c — stays near equilibrium, matching the uniform
-mesh drift bars of test_dyngr.py.
"""

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build

TOV_SMR = """
<job>
basename = tovsmr

<mesh>
nghost = {ng}
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

<mesh_refinement>
refinement = static
num_levels = 2

<refined_region1>
level = 1
x1min = -7.5
x1max = 7.5
x2min = -7.5
x2max = 7.5
x3min = -7.5
x3max = 7.5

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.25
tlim = 100.0
nlim = {nlim}

<coord>
general_rel = true

{spacetime}

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

Z4C_BLOCK = """
<z4c>
lapse_oplog = 2.0
lapse_harmonicf = 1.0
lapse_advect = 1.0
shift_ggamma = 0.75
shift_advect = 1.0
shift_eta = 2.0
diss = 0.5
"""


def _run(deck):
    pin = ParameterInput.from_string(deck)
    mesh, phys, pgen, driver, state = build(pin)
    state = driver.initialize(state)
    state = driver.execute(state)
    return driver.mesh, driver.phys, state


@pytest.mark.slow
def test_tov_cowling_smr_equilibrium():
    """Fixed-metric TOV on a 2-level mesh: the star (inside the refined
    region) keeps its central density, and the level boundary does not
    inject noise (drift bar matches the uniform-mesh test)."""
    mesh, phys, st = _run(TOV_SMR.format(ng=2, nlim=20, spacetime="<adm>"))
    assert mesh.multilevel and mesh.mb_lev.max() == 1
    w = np.asarray(st["w"])
    assert np.isfinite(w).all()
    drift = abs(w[:, 0].max() - 1.28e-3) / 1.28e-3
    assert drift < 0.13, f"central density drift {drift}"


@pytest.mark.slow
def test_tov_coupled_z4c_smr_stable():
    """Fully coupled star+spacetime on SMR (the BNS production shape):
    finite fields, bounded drift, physical lapse (needs nghost>=4 for
    the 4th-order Z4c mixed-level prolongation)."""
    mesh, phys, st = _run(
        TOV_SMR.format(ng=4, nlim=8, spacetime="<adm>" + Z4C_BLOCK))
    assert mesh.multilevel
    w = np.asarray(st["w"])
    z = np.asarray(st["z"])
    assert np.isfinite(w).all() and np.isfinite(z).all()
    drift = abs(w[:, 0].max() - 1.28e-3) / 1.28e-3
    assert drift < 0.13, f"central density drift {drift}"
    from athenak_jax.z4c.z4c import I_ALPHA
    assert z[:, I_ALPHA].min() > 0.1 and z[:, I_ALPHA].max() < 1.05
