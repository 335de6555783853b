"""FOFC: cells whose update would need floors get first-order fluxes.

(reference: src/hydro/hydro_fofc.cpp, mhd_fofc.cpp).  A cell is driven
toward a floor violation by hand; the cycle must flag it (nfofc event
counter, reference eventlog parity) and keep the state finite.
"""

import jax
import jax.numpy as jnp
import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build

BLAST = """
<job>
basename = fofcblast

<mesh>
nghost = 2
nx1 = 32
x1min = -0.5
x1max = 0.5
nx2 = 32
x2min = -0.5
x2max = 0.5
nx3 = 1
x3min = -0.5
x3max = 0.5

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.4
tlim = 0.06

<{phys}>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = {rsolver}
fofc = true
dfloor = 1.0e-8
pfloor = 1.0e-10

<problem>
pgen_name = blast
inner_radius = 0.05
outer_radius = 0.1
prat = 1.0e4
b_amb = {b_amb}
"""


def _poked_cycle(phys_block, rsolver, b_amb):
    deck = BLAST.format(phys=phys_block, rsolver=rsolver, b_amb=b_amb)
    pin = ParameterInput.from_string(deck)
    mesh, phys, pgen, driver, state = build(pin)
    state = driver.initialize(state)
    mbi = mesh.mb_indcs
    u = state["u"]
    k, j, i = mbi.ks, mbi.js + 16, mbi.is_ + 16
    u = u.at[0, 4, k, j, i].set(u[0, 4, k, j, i] * 1e-12)
    if phys.is_mhd:
        w, u2, _ = phys.cons_to_prim(u, state["bcc"])
    else:
        w, u2, _ = phys.cons_to_prim(u)
    state = dict(state, u=u2, w=w)
    cyc = jax.jit(driver.make_cycle_fn())
    s1, dtn, counters = cyc(state, jnp.asarray(1e-3, dtype=u.dtype))
    return s1, counters


def test_fofc_hydro_triggers_and_survives():
    s1, counters = _poked_cycle("hydro", "hllc", 0.0)
    assert int(counters["nfofc"]) > 0
    assert np.isfinite(np.asarray(s1["u"])).all()
    assert (np.asarray(s1["w"])[:, 0] > 0).all()


def test_fofc_mhd_triggers_and_survives():
    s1, counters = _poked_cycle("mhd", "hlld", 1.0)
    assert int(counters["nfofc"]) > 0
    assert np.isfinite(np.asarray(s1["u"])).all()
    assert (np.asarray(s1["w"])[:, 0] > 0).all()
