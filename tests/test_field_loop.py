"""Field-loop advection + LW implosion regressions.

field_loop (reference: src/pgen/fluids/field_loop.cpp, GS05): div B
stays at round-off while the loop advects, and magnetic energy decays
only slightly (dissipation bound).
lw_implode (reference: src/pgen/tests/lw_implode.cpp, Liska & Wendroff
2003): the flow must stay exactly symmetric about the x=y diagonal.
"""

import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import run

LOOP_DECK = """
<job>
basename = Loop

<mesh>
nghost = 2
nx1 = 64
x1min = -1.0
x1max = 1.0
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
nx1 = 32
nx2 = 16
nx3 = 1

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.4
nlim = -1
tlim = 0.5
ndiag = 10000

<mhd>
eos = ideal
reconstruct = plm
rsolver = hlld
gamma = 1.666666667

<problem>
pgen_name = field_loop
rad = 0.3
amp = 1.0e-3
iprob = 1
"""

IMPLODE_DECK = """
<job>
basename = Implode

<mesh>
nghost = 2
nx1 = 64
x1min = 0.0
x1max = 0.3
ix1_bc = reflect
ox1_bc = reflect
nx2 = 64
x2min = 0.0
x2max = 0.3
ix2_bc = reflect
ox2_bc = reflect
nx3 = 1
x3min = -0.5
x3max = 0.5
ix3_bc = periodic
ox3_bc = periodic

<meshblock>
nx1 = 32
nx2 = 32
nx3 = 1

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
nlim = 100
tlim = 0.5
ndiag = 10000

<hydro>
eos = ideal
reconstruct = plm
rsolver = hllc
gamma = 1.4

<problem>
pgen_name = lw_implode
d_in = 0.125
p_in = 0.14
d_out = 1.0
p_out = 1.0
"""


def _divb(mesh, bfc):
    mbi = mesh.mb_indcs
    act = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.ie + 1))
    b1 = np.asarray(bfc["x1f"])
    b2 = np.asarray(bfc["x2f"])
    d = ((b1[:, :, :, 1:] - b1[:, :, :, :-1])[(slice(None),) + act]
         / float(mesh.mesh_size.dx1)
         + (b2[:, :, 1:, :] - b2[:, :, :-1, :])[(slice(None),) + act]
         / float(mesh.mesh_size.dx2))
    if mesh.three_d:
        b3 = np.asarray(bfc["x3f"])
        d = d + (b3[:, 1:, :, :] - b3[:, :-1, :, :])[
            (slice(None),) + act] / float(mesh.mesh_size.dx3)
    return np.abs(d).max()


def test_field_loop_advection(tmp_path):
    pin = ParameterInput.from_string(LOOP_DECK)
    pin.modify_from_cmdline([f"job/basename={tmp_path}/Loop"])
    mesh, phys, driver, state = run(pin)

    assert _divb(mesh, state["bfc"]) < 1e-12

    # magnetic-energy retention after half a crossing is a sharp
    # regression metric: measured 0.7169 at 64x32 (0.8497 at 128x64,
    # converging toward GS05's CT behavior).  A broken CT/EMF path
    # collapses it; extra dissipation shows up immediately.
    bcc = np.asarray(state["bcc"], dtype=np.float64)
    eb_final = (bcc ** 2).sum()
    # initial energy from a fresh 0-cycle build
    pin0 = ParameterInput.from_string(LOOP_DECK)
    pin0.modify_from_cmdline([f"job/basename={tmp_path}/Loop0",
                              "time/nlim=0"])
    _, _, _, st0 = run(pin0)
    eb0 = (np.asarray(st0["bcc"], dtype=np.float64) ** 2).sum()
    assert 0.68 * eb0 < eb_final < 0.78 * eb0


def test_field_loop_3d_rotated_divb(tmp_path):
    """iprob=4 (cylinder rotated in the x1-x3 plane): B = curl A on the
    staggered mesh must give div B = 0 at round-off, and it must stay
    there under CT evolution."""
    pin = ParameterInput.from_string(LOOP_DECK)
    pin.modify_from_cmdline([
        f"job/basename={tmp_path}/Loop3d",
        "mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16",
        "mesh/x1min=-0.5", "mesh/x1max=0.5",
        "meshblock/nx1=16", "meshblock/nx2=16", "meshblock/nx3=16",
        "time/nlim=5", "problem/iprob=4", "problem/rad=0.2",
    ])
    mesh, phys, driver, state = run(pin)
    assert _divb(mesh, state["bfc"]) < 1e-12
    assert np.isfinite(np.asarray(state["u"])).all()


def test_lw_implode_diagonal_symmetry(tmp_path):
    """The solution must remain symmetric under x <-> y reflection
    (the canonical pass/fail criterion for this test)."""
    pin = ParameterInput.from_string(IMPLODE_DECK)
    pin.modify_from_cmdline([f"job/basename={tmp_path}/Implode"])
    mesh, phys, driver, state = run(pin)
    assert mesh.ncycle == 100

    mbi = mesh.mb_indcs
    # assemble the global interior density field (2x2 blocks of 32^2)
    act = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.ie + 1))
    u = np.asarray(state["u"], dtype=np.float64)
    n1, n2 = mesh.mesh_indcs.nx1, mesh.mesh_indcs.nx2
    dens = np.zeros((n2, n1))
    en = np.zeros((n2, n1))
    for gid in range(mesh.nmb_total):
        l1, l2, _ = mesh.lloc_eachmb[gid]
        sl = (slice(l2 * mbi.nx2, (l2 + 1) * mbi.nx2),
              slice(l1 * mbi.nx1, (l1 + 1) * mbi.nx1))
        dens[sl] = u[gid, 0][act][0]
        en[sl] = u[gid, 4][act][0]
    np.testing.assert_allclose(dens, dens.T, rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(en, en.T, rtol=1e-11, atol=1e-13)
