"""Self-gravity: FFT Poisson solution + Jeans dispersion relation.

(reference: src/gravity/mg_gravity.cpp, pgen/tests/jeans.cpp,
tst/test_suite/multigrid/)
"""

import math

import jax
import jax.numpy as jnp
import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build
from athenak_jax.indices import IDN

DECK = """
<job>
basename = jeans

<mesh>
nghost = 2
nx1 = 32
x1min = 0.0
x1max = 1.0
nx2 = 8
x2min = 0.0
x2max = 1.0
nx3 = 8
x3min = 0.0
x3max = 1.0

<time>
evolution = dynamic
integrator = rk3
cfl_number = 0.3
tlim = 1.0

<hydro>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hllc

<gravity>
four_pi_G = {fpg}

<hydro_srcterms>
self_gravity = true

<problem>
pgen_name = turb
d0 = 1.0
p0 = 0.6
"""


def test_poisson_solution():
    """lap(phi) = 4 pi G (rho - mean) solved exactly for a sine mode."""
    pin = ParameterInput.from_string(DECK.format(fpg=1.0))
    mesh, phys, pgen, driver, state = build(pin)
    mbi = mesh.mb_indcs
    x1v, _, _ = mesh.cell_centers(0)
    X = np.asarray(x1v)[None, None, None, :]
    k = 2.0 * math.pi
    rho = 1.0 + 0.1 * np.sin(k * X)
    u = state["u"].at[:, IDN].set(jnp.asarray(
        np.broadcast_to(rho, state["u"][:, IDN].shape)))
    phi = phys.pgrav.solve(u, phys.bvals)
    act = (0, 0, mbi.ks + 2, mbi.js + 2, slice(mbi.is_, mbi.ie + 1))
    got = np.asarray(phi)[act]
    # discrete eigenvalue of the FD Laplacian for this mode
    dx = mesh.mesh_size.dx1
    lam = (2.0 * math.cos(k * dx) - 2.0) / dx ** 2
    expect = 1.0 * 0.1 * np.sin(k * X[0, 0, 0]) / lam
    np.testing.assert_allclose(got, expect[mbi.is_:mbi.ie + 1],
                               rtol=1e-10, atol=1e-12)


def test_jeans_oscillation_frequency():
    """Standing sound wave with self-gravity oscillates at
    omega^2 = cs^2 k^2 - 4 pi G rho0 (stable regime)."""
    fpg = 20.0
    pin = ParameterInput.from_string(DECK.format(fpg=fpg))
    mesh, phys, pgen, driver, state = build(pin)
    mbi = mesh.mb_indcs
    x1v, _, _ = mesh.cell_centers(0)
    X = np.asarray(x1v)[None, None, None, :]
    k = 2.0 * math.pi
    amp = 1.0e-4
    gam = 5.0 / 3.0
    cs2 = gam * 0.6 / 1.0
    rho = 1.0 + amp * np.sin(k * X)
    # adiabatic perturbation dp = cs^2 drho (pure acoustic-Jeans mode,
    # no entropy component)
    pres = 0.6 + cs2 * amp * np.sin(k * X)
    u = state["u"].at[:, IDN].set(jnp.asarray(
        np.broadcast_to(rho, state["u"][:, IDN].shape)))
    u = u.at[:, 4].set(jnp.asarray(
        np.broadcast_to(pres / (gam - 1.0), state["u"][:, 4].shape)))
    w, u2, _ = phys.cons_to_prim(u)
    state = dict(state, u=u2, w=w)
    state = driver.initialize(state)

    cyc = jax.jit(driver.make_cycle_fn())
    dt = jnp.asarray(driver.mesh.dt, dtype=u.dtype)
    sin_mode = np.sin(k * np.asarray(x1v)[mbi.is_:mbi.ie + 1])
    act = (slice(None), IDN, slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))

    t, proj0, tcross = 0.0, None, None
    for n in range(400):
        state, dtn, _ = cyc(state, dt)
        t += float(dt)
        d = np.asarray(state["u"])[act].mean(axis=(0, 1, 2))
        proj = float((d - d.mean()) @ sin_mode)
        if proj0 is None:
            proj0 = proj
        if proj0 * proj < 0.0:  # first sign flip: omega t = pi/2
            tcross = t
            break
    assert tcross is not None, "no oscillation detected"
    cs2 = 5.0 / 3.0 * 0.6 / 1.0
    omega = math.sqrt(cs2 * k * k - fpg * 1.0)
    expect = 0.5 * math.pi / omega
    assert abs(tcross - expect) / expect < 0.08, \
        f"zero crossing at {tcross}, expected {expect}"
