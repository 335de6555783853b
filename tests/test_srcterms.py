"""Source terms: constant acceleration + ISM cooling curve sanity.

Mirrors the reference's source-term behavior (reference:
src/srcterms/srcterms.cpp:113-204, ismcooling.hpp:19-57).
"""

import jax.numpy as jnp
import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build, run
from athenak_jax.srcterms import ism_cool_fn
from athenak_jax.units import Units

ACCEL_DECK = """
<job>
basename = accel

<mesh>
nghost = 2
nx1 = 16
x1min = 0.0
x1max = 1.0
nx2 = 1
x2min = 0.0
x2max = 1.0
nx3 = 1
x3min = 0.0
x3max = 1.0

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.4
tlim = 0.1
nlim = 20

<hydro>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hllc

<hydro_srcterms>
const_accel = true
const_accel_val = 2.0
const_accel_dir = 1

<problem>
pgen_name = advection
advect_dir = 1
velocity = 0.0
amp = 0.0
"""


def test_constant_accel_uniform_medium():
    """Uniform gas + constant accel: v(t) = g t exactly (no gradients)."""
    pin = ParameterInput.from_string(ACCEL_DECK)
    mesh, phys, driver, state = run(pin)
    g = 2.0
    t = mesh.time
    w = np.asarray(state["w"])
    mbi = mesh.mb_indcs
    vx = w[:, 1, :, :, mbi.is_:mbi.ie + 1]
    np.testing.assert_allclose(vx, g * t, rtol=1e-10)


def test_ism_cooling_curve_branches():
    """Cooling curve is positive, continuous-ish at branch switches, and
    matches the published values at table nodes."""
    t = jnp.array([1.0e2, 1.0e3, 1.585e4, 1.0e6, 1.0e9], dtype=jnp.float64)
    lam = np.asarray(ism_cool_fn(t))
    assert (lam > 0).all()
    # table node log T = 5.0 is index (5.0-4.12)/0.04 = 22
    lam5 = float(ism_cool_fn(jnp.array([1.0e5], jnp.float64))[0])
    assert np.isclose(np.log10(lam5), -20.6815, atol=0.02)
    # branch continuity at logT = 4.2 within interpolation slack
    below = float(ism_cool_fn(jnp.array([10 ** 4.199], jnp.float64))[0])
    above = float(ism_cool_fn(jnp.array([10 ** 4.201], jnp.float64))[0])
    assert abs(np.log10(below) - np.log10(above)) < 0.25


def test_units_scalings():
    pin = ParameterInput.from_string("""
<units>
length_cgs = 3.0856775809623245e18
mass_cgs = 1.0e33
time_cgs = 3.15576e13
mu = 0.6
""")
    u = Units(pin)
    assert np.isclose(u.velocity_cgs, u.length_cgs / u.time_cgs)
    assert np.isclose(u.density_cgs, u.mass_cgs / u.length_cgs ** 3)
    # temperature unit: mu m_H v^2 / k_B
    expect = u.velocity_cgs ** 2 * 0.6 * 1.660538921e-24 / 1.3806488e-16
    assert np.isclose(u.temperature_cgs, expect)
