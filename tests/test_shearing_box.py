"""Shearing box: epicyclic oscillation + sheared passive-scalar pattern.

(reference: src/shearing_box/; inputs/shearing_box/epicycle.athinput,
shwave decks)
"""

import math

import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build, run
from athenak_jax.indices import IVX, IVY

BASE = """
<job>
basename = sbox

<mesh>
nghost = 2
nx1 = 32
x1min = -0.5
x1max = 0.5
ix1_bc = shear_periodic
ox1_bc = shear_periodic
nx2 = 32
x2min = -0.5
x2max = 0.5
nx3 = 4
x3min = -0.0625
x3max = 0.0625

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = {tlim}

<hydro>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hllc
nscalars = {nscalars}

<shearing_box>
qshear = 1.5
omega0 = 1.0

<problem>
pgen_name = turb
d0 = 1.0
p0 = 1.0
"""


def test_epicyclic_oscillation():
    """Uniform vx perturbation oscillates at kappa = sqrt(2(2-q)) Om."""
    om, q = 1.0, 1.5
    kappa = math.sqrt(2.0 * (2.0 - q)) * om
    period = 2.0 * math.pi / kappa
    deck = BASE.format(tlim=period, nscalars=0)
    pin = ParameterInput.from_string(deck)
    mesh, phys, pgen, driver, state = build(pin)
    amp = 1.0e-3
    u = state["u"].at[:, 1].add(amp * state["u"][:, 0])
    w, u2, _ = phys.cons_to_prim(u)
    state = dict(state, u=u2, w=w)
    state = driver.initialize(state)
    state = driver.execute(state)
    mbi = mesh.mb_indcs
    act = (0, slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.ie + 1))
    vx = np.asarray(state["w"])[:, IVX][act]
    vy = np.asarray(state["w"])[:, IVY][act]
    # after one full epicyclic period vx returns to +amp, vy to ~0
    assert np.allclose(vx, amp, rtol=0.05)
    assert np.abs(vy).max() < 0.3 * amp


def test_scalar_shwave_pattern():
    """Passive stripe s=sin(2 pi y) sheared by orbital advection into
    sin(2 pi (y + q Om x t)) — validates OA remap AND the shear-periodic
    boundary phase shift."""
    om, q = 1.0, 1.5
    tlim = 0.5
    deck = BASE.format(tlim=tlim, nscalars=1)
    pin = ParameterInput.from_string(deck)
    mesh, phys, pgen, driver, state = build(pin)

    import jax.numpy as jnp
    mbi = mesh.mb_indcs
    x1v, x2v, _ = mesh.cell_centers(0)
    Y = np.asarray(x2v)[None, None, :, None]
    # concentrations are floored at 0 (reference: ideal_hyd.cpp:96-99),
    # so use a non-negative stripe
    s0 = 0.5 * (1.0 + np.sin(2.0 * math.pi * Y))
    u = state["u"].at[:, 5].set(jnp.asarray(
        np.broadcast_to(s0, state["u"][:, 5].shape)) * state["u"][:, 0])
    w, u2, _ = phys.cons_to_prim(u)
    state = dict(state, u=u2, w=w)
    state = driver.initialize(state)
    state = driver.execute(state)

    t = mesh.time
    act = (0, slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.ie + 1))
    s = np.asarray(state["w"])[:, 5][act]
    X = np.asarray(x1v)[None, None, mbi.is_:mbi.ie + 1]
    Yc = np.asarray(x2v)[None, mbi.js:mbi.je + 1, None]
    expect = 0.5 * (1.0 + np.sin(2.0 * math.pi * (Yc + q * om * X * t)))
    err = np.abs(s - expect).mean()
    assert err < 0.05, f"shwave pattern L1 error {err}"
