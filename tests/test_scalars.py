"""Passive scalars: advection preserves the profile and conserves total.

(reference: scalar handling in src/hydro/rsolvers/*.hpp and
src/eos/ideal_hyd.cpp scalar c2p blocks)
"""

import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build, run

DECK = """
<job>
basename = scal

<mesh>
nghost = 2
nx1 = 64
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
tlim = 1.0

<hydro>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hllc
nscalars = 1

<problem>
pgen_name = advection
advect_dir = 1
velocity = 1.0
amp = 0.0
"""


def test_scalar_advection_conserves():
    pin = ParameterInput.from_string(DECK)
    mesh, phys, pgen, driver, state = build(pin)
    assert phys.nvar == 6
    # paint a top-hat scalar concentration
    import jax.numpy as jnp
    mbi = mesh.mb_indcs
    x1v, _, _ = mesh.cell_centers(0)
    s = jnp.asarray((np.abs(x1v - 0.5) < 0.2).astype(float))
    u = state["u"].at[:, 5].set(s[None, None, None, :] * state["u"][:, 0])
    state = dict(state, u=u)
    state = driver.initialize(state)
    total0 = float(np.asarray(state["u"])[0, 5, 0, 0,
                                          mbi.is_:mbi.ie + 1].sum())
    state = driver.execute(state)
    ua = np.asarray(state["u"])[0, 5, 0, 0, mbi.is_:mbi.ie + 1]
    total1 = float(ua.sum())
    # conservation (periodic box)
    np.testing.assert_allclose(total1, total0, rtol=1e-12)
    # after one period the profile should come back (diffused but centered)
    wa = np.asarray(state["w"])[0, 5, 0, 0, mbi.is_:mbi.ie + 1]
    com = (x1v[mbi.is_:mbi.ie + 1] * wa).sum() / wa.sum()
    assert abs(com - 0.5) < 0.02
    assert wa.min() >= -1e-10 and wa.max() <= 1.0 + 1e-10
