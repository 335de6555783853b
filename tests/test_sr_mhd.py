"""Special-relativistic MHD: Kastaun c2p round trip + shocktube sanity.

(reference: src/eos/ideal_c2p_mhd.hpp SR parts, tst/test_suite/sr/)
"""

import jax.numpy as jnp
import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import run
from athenak_jax.ops.eos import EOSData
from athenak_jax.ops.eos_sr import (cons_to_prim_sr_mhd,
                                    prim_to_cons_sr_mhd)
from athenak_jax.indices import IDN, IEN


def test_sr_mhd_c2p_round_trip():
    rng = np.random.default_rng(7)
    n = 512
    w = np.zeros((1, 5, 1, 1, n))
    w[0, 0, 0, 0] = 10.0 ** rng.uniform(-2, 1, n)
    w[0, 1:4, 0, 0] = rng.uniform(-3, 3, (3, n))
    gam = 4.0 / 3.0
    p = 10.0 ** rng.uniform(-3, 1, n)
    w[0, 4, 0, 0] = p / (gam - 1.0)
    bcc = np.zeros((1, 3, 1, 1, n))
    bcc[0, :, 0, 0] = rng.uniform(-2, 2, (3, n))
    eos = EOSData(gamma=gam, is_ideal=True, dfloor=1e-10, pfloor=1e-12)
    wj, bj = jnp.asarray(w), jnp.asarray(bcc)
    u = prim_to_cons_sr_mhd(wj, bj, eos)
    w2, u2, counters = cons_to_prim_sr_mhd(u, bj, eos)
    assert int(counters["nc2p_fail"]) == 0
    np.testing.assert_allclose(np.asarray(w2), w, rtol=1e-6, atol=1e-9)


def test_sr_mhd_shocktube():
    """Relativistic Brio-Wu-like tube (Balsara test 1 parameters) runs
    stably with HLLE and preserves positivity."""
    deck = """
<job>
basename = srbw

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

<mhd>
eos = ideal
gamma = 2.0
reconstruct = plm
rsolver = hlle

<problem>
pgen_name = shock_tube
shock_dir = 1
xshock = 0.0
dl = 1.0
pl = 1.0
ul = 0.0
vl = 0.0
wl = 0.0
bxl = 0.5
byl = 1.0
bzl = 0.0
dr = 0.125
pr = 0.1
ur = 0.0
vr = 0.0
wr = 0.0
bxr = 0.5
byr = -1.0
bzr = 0.0
"""
    pin = ParameterInput.from_string(deck)
    mesh, phys, driver, state = run(pin)
    w = np.asarray(state["w"])[0, :, 0, 0]
    assert np.isfinite(w).all()
    assert (w[IDN] > 0).all()
    assert (w[IEN] > 0).all()
    lor = np.sqrt(1.0 + w[1] ** 2 + w[2] ** 2 + w[3] ** 2)
    assert lor.max() < 3.0
    # left fast rarefaction + right shock structure developed
    assert mesh.ncycle > 50
