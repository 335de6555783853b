"""Turbulence driver: energy injection at the prescribed rate, zero net
momentum, solenoidal forcing.

(reference: src/srcterms/turb_driver.cpp normalization + momentum removal;
tst inputs: inputs/hydro/turb.athinput)
"""

import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import run
from athenak_jax.indices import IDN, IEN

DECK = """
<job>
basename = turb

<mesh>
nghost = 2
nx1 = 16
x1min = -0.5
x1max = 0.5
nx2 = 16
x2min = -0.5
x2max = 0.5
nx3 = 16
x3min = -0.5
x3max = 0.5

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 0.5

<hydro>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hllc

<turb_driving>
nlow = 1
nhigh = 2
dedt = 0.1
tcorr = 0.5
seed = 3

<problem>
pgen_name = turb
d0 = 1.0
p0 = 1.0
"""


def test_turbulence_driving():
    pin = ParameterInput.from_string(DECK)
    mesh, phys, driver, state = run(pin)
    mbi = mesh.mb_indcs
    act = (slice(None), slice(None),
           slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.ie + 1))
    u = np.asarray(state["u"])[act]
    w = np.asarray(state["w"])[act]
    vol = mesh.mesh_size.dx1 * mesh.mesh_size.dx2 * mesh.mesh_size.dx3

    # kinetic energy was injected at the dedt order of magnitude
    # (the reference normalization targets the KE injection rate; only the
    # f.v work term enters total E, so exact-rate assertions need steady
    # state -- here we check the machinery, not the calibration)
    ke = 0.5 * (w[:, IDN] * (w[:, 1] ** 2 + w[:, 2] ** 2
                             + w[:, 3] ** 2)).sum() * vol
    assert 0.05 * 0.1 * mesh.time < ke < 20.0 * 0.1 * mesh.time

    # net momentum stays zero (removal step)
    for c in (1, 2, 3):
        assert abs(u[:, c].sum() * vol) < 1e-12

    # velocity field actually has structure (not uniform)
    assert w[:, 1].std() > 1e-4


SMR_DECK = DECK.replace("<time>", """<meshblock>
nx1 = 8
nx2 = 8
nx3 = 8

<mesh_refinement>
refinement = static
num_levels = 2

<refined_region1>
level = 1
x1min = -0.5
x1max = 0.0
x2min = -0.5
x2max = 0.0
x3min = -0.5
x3max = 0.0

<time>""")


def test_turbulence_driving_smr():
    """Driving composes with SMR: volume-weighted normalization and
    momentum removal (per-block cell volumes) keep zero net momentum and
    the dedt-order injection on a 2-level mesh."""
    import pytest  # noqa: F401
    pin = ParameterInput.from_string(SMR_DECK)
    mesh, phys, driver, state = run(pin)
    assert mesh.multilevel and mesh.mb_lev.max() == 1
    mbi = mesh.mb_indcs
    act = (slice(None), slice(None),
           slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.ie + 1))
    u = np.asarray(state["u"])[act]
    w = np.asarray(state["w"])[act]
    vol = (np.asarray(mesh.mb_size["dx1"])
           * np.asarray(mesh.mb_size["dx2"])
           * np.asarray(mesh.mb_size["dx3"])).reshape(-1, 1, 1, 1, 1)

    ke = 0.5 * (vol[:, 0] * w[:, IDN]
                * (w[:, 1] ** 2 + w[:, 2] ** 2 + w[:, 3] ** 2)).sum()
    assert 0.05 * 0.1 * mesh.time < ke < 20.0 * 0.1 * mesh.time

    # net momentum stays zero under the volume-weighted removal
    mom_tot = max(abs((vol * u[:, 1:4]).sum(axis=(0, 2, 3, 4))).max(), 0.0)
    assert mom_tot < 1e-12
    assert w[:, 1].std() > 1e-4
