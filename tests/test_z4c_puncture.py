"""Z4c one-puncture: stable short evolution with lapse collapse.

(reference: tst/test_suite/z4c boosted/one-puncture tests,
inputs/z4c/ one_puncture decks)
"""

import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import run
from athenak_jax.z4c.z4c import I_ALPHA, I_CHI

DECK = """
<job>
basename = punc

<mesh>
nghost = 2
nx1 = 32
x1min = -6.0
x1max = 6.0
ix1_bc = outflow
ox1_bc = outflow
nx2 = 32
x2min = -6.0
x2max = 6.0
ix2_bc = outflow
ox2_bc = outflow
nx3 = 32
x3min = -6.0
x3max = 6.0
ix3_bc = outflow
ox3_bc = outflow

<time>
evolution = dynamic
integrator = rk3
cfl_number = 0.25
tlim = 1.0

<z4c>
diss = 0.5
damp_kappa1 = 0.02
damp_kappa2 = 0.0
lapse_oplog = 2.0
lapse_advect = 1.0
shift_Gamma = 0.75
shift_eta = 2.0

<problem>
pgen_name = z4c_one_puncture
punc_ADM_mass = 1.0
"""


def test_one_puncture_short_evolution():
    pin = ParameterInput.from_string(DECK)
    mesh, phys, driver, state = run(pin)
    u = np.asarray(state["u"])
    assert np.isfinite(u).all()
    mbi = mesh.mb_indcs
    act = (slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    chi = u[:, I_CHI][act]
    alpha = u[:, I_ALPHA][act]
    assert chi.min() > 0.0
    # lapse bounded, deeply dipped near the puncture, near flat far away
    assert alpha.min() > 0.0 and alpha.max() < 1.05
    assert alpha.min() < 0.5
    a_far = alpha[0, 0, 0, 0]
    assert a_far > 0.8
    assert mesh.ncycle >= 10
    # constraints bounded (coarse grid: just no blow-up)
    H, M2 = phys.adm_constraints(state["u"])
    assert np.isfinite(np.asarray(H)).all()
    assert np.abs(np.asarray(H)[act]).max() < 100.0
