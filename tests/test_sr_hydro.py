"""Special-relativistic hydro: c2p round trip + shocktube sanity.

Mirrors the reference SR suite intent (reference: tst/test_suite/sr/) with
framework-level checks: the Galeazzi c2p inverts p2c to round-off, the SR
solvers reduce to the Newtonian ones at small velocity, and the MB1
shocktube (Mignone & Bodo 2005) runs stably with bounded Lorentz factor.
"""

import jax
import jax.numpy as jnp
import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import run
from athenak_jax.ops.eos import EOSData
from athenak_jax.ops.eos_sr import (cons_to_prim_sr_hydro,
                                    prim_to_cons_sr_hydro)
from athenak_jax.indices import IDN, IEN, IVX


def test_sr_c2p_round_trip():
    rng = np.random.default_rng(42)
    n = 512
    w = np.zeros((1, 5, 1, 1, n))
    w[0, 0, 0, 0] = 10.0 ** rng.uniform(-3, 2, n)       # rho
    w[0, 1:4, 0, 0] = rng.uniform(-5, 5, (3, n))        # u^i up to gamma~9
    p = 10.0 ** rng.uniform(-4, 2, n)
    gam = 4.0 / 3.0
    w[0, 4, 0, 0] = p / (gam - 1.0)
    eos = EOSData(gamma=gam, is_ideal=True,
                  dfloor=1e-10, pfloor=1e-12)
    wj = jnp.asarray(w)
    u = prim_to_cons_sr_hydro(wj, eos)
    w2, u2, counters = cons_to_prim_sr_hydro(u, eos)
    assert int(counters["nc2p_fail"]) == 0
    np.testing.assert_allclose(np.asarray(w2), w, rtol=1e-9, atol=1e-11)


def test_sr_reduces_to_newtonian():
    """v ~ 1e-3: SR Sod tube matches the Newtonian solution closely."""
    base = """
<job>
basename = sod

<mesh>
nghost = 2
nx1 = 128
x1min = -0.5
x1max = 0.5
nx2 = 1
x2min = -0.5
x2max = 0.5
nx3 = 1
x3min = -0.5
x3max = 0.5
ix1_bc = outflow
ox1_bc = outflow
{coord}

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.4
tlim = 100.0

<hydro>
eos = ideal
gamma = 1.4
reconstruct = plm
rsolver = hlle

<problem>
pgen_name = shock_tube
shock_dir = 1
xshock = 0.0
dl = 1.0e-6
ul = 0.0
vl = 0.0
wl = 0.0
pl = 1.0e-12
dr = 1.25e-7
ur = 0.0
vr = 0.0
wr = 0.0
pr = 1.0e-13
"""
    # scaled Sod: sound speeds ~ 1e-3 of c, same self-similar solution
    pin = ParameterInput.from_string(base.format(coord=""))
    mesh_n, phys_n, drv_n, st_n = run(pin)
    pin = ParameterInput.from_string(
        base.format(coord="\n<coord>\nspecial_rel = true\n"))
    mesh_s, phys_s, drv_s, st_s = run(pin)
    wn = np.asarray(st_n["w"])[0, :, 0, 0]
    ws = np.asarray(st_s["w"])[0, :, 0, 0]
    # L1 comparison (pointwise diffs at shock fronts are position-
    # sensitive); SR corrections are O(v/c) ~ 1e-3
    for ch in (IDN, IVX, IEN):
        l1 = np.abs(ws[ch] - wn[ch]).mean()
        scale = np.abs(wn[ch]).max()
        assert l1 / scale < 1.0e-3, f"channel {ch}: {l1/scale}"


def test_sr_mb1_shocktube():
    """MB1 (Mignone & Bodo 2005): ul = 0.9 shocktube, HLLC, runs stably."""
    deck = """
<job>
basename = mb1

<mesh>
nghost = 2
nx1 = 256
x1min = -0.5
x1max = 0.5
nx2 = 1
x2min = -0.5
x2max = 0.5
nx3 = 1
x3min = -0.5
x3max = 0.5
ix1_bc = outflow
ox1_bc = outflow

<coord>
special_rel = true

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.4
tlim = 0.4

<hydro>
eos = ideal
gamma = 1.3333333333333333
reconstruct = plm
rsolver = hllc

<problem>
pgen_name = shock_tube
shock_dir = 1
xshock = 0.0
dl = 1.0
pl = 1.0
ul = 0.9
vl = 0.0
wl = 0.0
dr = 1.0
pr = 10.0
ur = 0.0
vr = 0.0
wr = 0.0
"""
    pin = ParameterInput.from_string(deck)
    mesh, phys, driver, state = run(pin)
    w = np.asarray(state["w"])[0, :, 0, 0]
    assert np.isfinite(w).all()
    assert (w[IDN] > 0).all()
    # Lorentz factor bounded and of the right order
    lor = np.sqrt(1.0 + (w[1] ** 2 + w[2] ** 2 + w[3] ** 2))
    assert lor.max() < 5.0
    assert lor.max() > 1.2  # relativistic flow developed
    # pressure jump direction preserved (right side drives a shock left)
    mbi = mesh.mb_indcs
    p = (phys.eos.gamma - 1.0) * w[IEN, mbi.is_:mbi.ie + 1]
    assert p[-10:].mean() > p[:10].mean()
