"""GR MHD: Kastaun c2p round trip in curved space + unmagnetized Bondi.

(reference: src/eos/ideal_grmhd.cpp, mhd/rsolvers/llf_mhd_singlestate.hpp
GRMHD branch)
"""

import jax.numpy as jnp
import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import run
from athenak_jax.gr.cks import metric
from athenak_jax.ops.eos import EOSData
from athenak_jax.ops.eos_gr import (cons_to_prim_gr_mhd,
                                    prim_to_cons_gr_mhd)


def test_gr_mhd_c2p_round_trip():
    rng = np.random.default_rng(3)
    n = 256
    # positions outside the horizon of a spinning hole
    x = rng.uniform(2.5, 10, n)
    y = rng.uniform(-10, 10, n)
    z = rng.uniform(-10, 10, n)
    gl, gu = metric(jnp.asarray(x).reshape(1, 1, 1, n),
                    jnp.asarray(y).reshape(1, 1, 1, n),
                    jnp.asarray(z).reshape(1, 1, 1, n), a=0.5)

    w = np.zeros((1, 5, 1, 1, n))
    w[0, 0, 0, 0] = 10.0 ** rng.uniform(-2, 0, n)
    w[0, 1:4, 0, 0] = rng.uniform(-1, 1, (3, n))
    gam = 13.0 / 9.0
    p = 10.0 ** rng.uniform(-3, 0, n)
    w[0, 4, 0, 0] = p / (gam - 1.0)
    bcc = np.zeros((1, 3, 1, 1, n))
    bcc[0, :, 0, 0] = rng.uniform(-0.5, 0.5, (3, n))
    eos = EOSData(gamma=gam, is_ideal=True, dfloor=1e-10, pfloor=1e-12)
    wj, bj = jnp.asarray(w), jnp.asarray(bcc)
    u = prim_to_cons_gr_mhd(wj, bj, eos, gl, gu)
    w2, u2, counters = cons_to_prim_gr_mhd(u, bj, eos, gl, gu)
    assert int(counters["nc2p_fail"]) == 0
    np.testing.assert_allclose(np.asarray(w2), w, rtol=1e-6, atol=1e-8)


def test_gr_mhd_bondi_stationary():
    """Unmagnetized Bondi through the full GRMHD path stays stationary."""
    deck = """
<job>
basename = grmhd_bondi

<mesh>
nghost = 2
nx1 = 24
x1min = -10.0
x1max = 10.0
ix1_bc = user
ox1_bc = user
nx2 = 24
x2min = -10.0
x2max = 10.0
ix2_bc = user
ox2_bc = user
nx3 = 24
x3min = -10.0
x3max = 10.0
ix3_bc = user
ox3_bc = user

<coord>
general_rel = true
a = 0.0
excise = true
dexcise = 1.0e-8
pexcise = 0.333e-12

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 2.0

<mhd>
eos = ideal
reconstruct = plm
rsolver = hlle
gamma = 1.3333333333333

<problem>
pgen_name = gr_bondi
k_adi = 1.0
r_crit = 8.0
"""
    pin = ParameterInput.from_string(deck)
    mesh, phys, driver, state = run(pin)
    import os
    fname = "grmhd_bondi-errs.dat"
    assert os.path.exists(fname)
    data = np.loadtxt(fname)
    os.remove(fname)
    rms_l1 = float(np.atleast_2d(data)[-1, 4])
    assert rms_l1 < 1.0e-2, f"GRMHD Bondi deviated: RMS-L1 = {rms_l1}"
    assert np.isfinite(np.asarray(state["w"])).all()
