"""Sod shock tube regression (reference deck: tst/inputs/sod.athinput)."""

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.indices import IDN, IEN, IM1
from athenak_jax.main import run

DECK = """
<job>
basename = Sod

<mesh>
nghost = 2
nx1 = 256
x1min = -0.5
x1max = 0.5
ix1_bc = outflow
ox1_bc = outflow
nx2 = 1
x2min = -0.5
x2max = 0.5
ix2_bc = periodic
ox2_bc = periodic
nx3 = 1
x3min = -0.5
x3max = 0.5
ix3_bc = periodic
ox3_bc = periodic

<meshblock>
nx1 = 64
nx2 = 1
nx3 = 1

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.8
nlim = -1
tlim = 0.25
ndiag = 10000

<hydro>
eos = ideal
reconstruct = plm
rsolver = hllc
gamma = 1.4

<problem>
pgen_name = shock_tube
shock_dir = 1
xshock = 0.0
dl = 1.0
pl = 1.0
ul = 0.0
vl = 0.0
wl = 0.0
dr = 0.125
pr = 0.1
ur = 0.0
vr = 0.0
wr = 0.0
"""


@pytest.mark.parametrize("rsolver", ["llf", "hlle", "hllc", "roe"])
def test_sod(tmp_path, rsolver):
    pin = ParameterInput.from_string(DECK)
    pin.modify_from_cmdline([
        f"hydro/rsolver={rsolver}",
        f"job/basename={tmp_path}/Sod",
    ])
    mesh, phys, driver, state = run(pin)
    mbi = mesh.mb_indcs
    ua = np.asarray(state["u"])[:, :, mbi.ks, mbi.js, mbi.is_:mbi.ie + 1]

    d = ua[:, IDN].ravel()
    e = ua[:, IEN].ravel()
    assert np.all(np.isfinite(ua)), "non-finite values in solution"
    assert d.min() > 0.05 and d.max() < 1.05, "density out of expected range"

    # conservation of mass and energy (outflow BCs: nothing leaves by t=0.25)
    vol = mesh.mesh_size.dx1 * mesh.mesh_size.dx2 * mesh.mesh_size.dx3
    mass = vol * d.sum()
    ener = vol * e.sum()
    assert mass == pytest.approx(0.5625, rel=1e-10)
    assert ener == pytest.approx((1.0 / 0.4 + 0.1 / 0.4) / 2, rel=1e-10)

    # shock has propagated to the right: density ahead of contact elevated
    # Sod solution at t=0.25: post-shock plateau density ~0.2656, shock at
    # x~0.434, contact at x~0.23
    nx = d.size
    x = np.linspace(-0.5 + 0.5 / nx, 0.5 - 0.5 / nx, nx)
    plateau = d[(x > 0.28) & (x < 0.40)]
    assert plateau.mean() == pytest.approx(0.2656, rel=0.02)


def test_sod_multiblock_matches_singleblock(tmp_path):
    """Decomposing into MeshBlocks must not change the answer (halo exchange
    correctness), matching the reference's block-invariance property."""
    results = []
    for mbx in (256, 32):
        pin = ParameterInput.from_string(DECK)
        pin.modify_from_cmdline([
            f"meshblock/nx1={mbx}",
            f"job/basename={tmp_path}/Sod{mbx}",
        ])
        mesh, phys, driver, state = run(pin)
        mbi = mesh.mb_indcs
        ua = np.asarray(state["u"])[:, :, mbi.ks, mbi.js, mbi.is_:mbi.ie + 1]
        # reassemble blocks in x order
        order = np.argsort(mesh.mb_size["x1min"])
        results.append(np.concatenate([ua[g] for g in order], axis=-1))
    np.testing.assert_allclose(results[0], results[1], rtol=1e-12, atol=1e-14)
