"""Circularly polarized Alfven wave convergence, 1D/2D with static
refinement — mirrors the reference regression
(reference: tst/test_suite/nr/test_nr_cpaw_amr_cpu.py, thresholds
2.0e-3/0.35 in 1D and 7.0e-3/0.45 in 2D at 32->64 zones,
tst/inputs/cpaw.athinput deck)."""

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import run

DECK = """
<job>
basename = cpaw

<mesh>
nghost = 2
nx1 = 32
x1min = 0.0
x1max = 2.0
ix1_bc = periodic
ox1_bc = periodic
nx2 = 1
x2min = 0.0
x2max = 1.0
ix2_bc = periodic
ox2_bc = periodic
nx3 = 1
x3min = 0.0
x3max = 1.0
ix3_bc = periodic
ox3_bc = periodic

<meshblock>
nx1 = 8
nx2 = 1
nx3 = 1

<mesh_refinement>
refinement = static

<refined_region1>
level = 1
x1min = 0.8
x1max = 1.2
x2min = 0.4
x2max = 0.6
x3min = 0.0
x3max = 1.0

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
nlim = -1
tlim = 1.0
ndiag = 100000

<mhd>
eos = ideal
reconstruct = plm
rsolver = llf
gamma = 1.66666666667

<problem>
pgen_name = cpaw
b_par = 1.0
b_perp = 0.1
pres = 0.1
v_par = 0.0
right_polar = true
along_x1 = false
"""

_RMS_L1_INDEX = 4


def _run_once(tmp_path, label, res):
    one_d = label == "1D"
    pin = ParameterInput.from_string(DECK)
    pin.modify_from_cmdline([
        f"job/basename={tmp_path}/cpaw_{label}",
        f"mesh/nx1={res}",
        f"mesh/nx2={1 if one_d else res // 2}",
        f"meshblock/nx1={res // 4}",
        f"meshblock/nx2={1 if one_d else res // 8}",
        f"problem/along_x1={'true' if one_d else 'false'}",
    ])
    run(pin)
    fname = pin.get_string("job", "basename") + "-errs.dat"
    return np.atleast_2d(np.loadtxt(fname))


@pytest.mark.parametrize("label,max_error,max_ratio", [
    ("1D", 2.0e-3, 0.35),
    ("2D", 7.0e-3, 0.45),
])
def test_cpaw_smr_convergence(tmp_path, label, max_error, max_ratio):
    _run_once(tmp_path, label, 32)
    data = _run_once(tmp_path, label, 64)
    low = data[0][_RMS_L1_INDEX]
    high = data[1][_RMS_L1_INDEX]
    assert high < max_error, \
        f"{label} CPAW error {high:g} exceeds {max_error:g}"
    assert high / low < max_ratio, \
        f"{label} CPAW ratio {high / low:g} exceeds {max_ratio:g}"


def test_cpaw_3d_divb_and_error(tmp_path):
    """Short 3D diagonal-propagation run: div B stays at round-off and
    the standing-field error is small (reference inputs/tests/cpaw3d)."""
    pin = ParameterInput.from_string(DECK)
    pin.modify_from_cmdline([
        f"job/basename={tmp_path}/cpaw3d",
        "mesh/nx1=16", "mesh/nx2=8", "mesh/nx3=8",
        "mesh/x1max=2.0", "mesh/x2max=1.0", "mesh/x3max=1.0",
        "meshblock/nx1=8", "meshblock/nx2=8", "meshblock/nx3=8",
        "mesh_refinement/refinement=none",
        "time/tlim=0.2",
    ])
    mesh, phys, driver, state = run(pin)
    bfc = state["bfc"]
    mbi = mesh.mb_indcs
    act = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.ie + 1))
    b1 = np.asarray(bfc["x1f"])
    b2 = np.asarray(bfc["x2f"])
    b3 = np.asarray(bfc["x3f"])
    dx1 = float(mesh.mesh_size.dx1)
    dx2 = float(mesh.mesh_size.dx2)
    dx3 = float(mesh.mesh_size.dx3)
    divb = ((b1[:, :, :, 1:] - b1[:, :, :, :-1])[(slice(None),) + act] / dx1
            + (b2[:, :, 1:, :] - b2[:, :, :-1, :])[(slice(None),) + act] / dx2
            + (b3[:, 1:, :, :] - b3[:, :-1, :, :])[(slice(None),) + act] / dx3)
    assert np.max(np.abs(divb)) < 1e-12
    assert np.all(np.isfinite(np.asarray(state["u"])))
