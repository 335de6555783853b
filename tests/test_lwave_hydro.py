"""1D hydro linear-wave convergence, mirroring the reference regression
thresholds (reference: tst/test_suite/nr/test_nr_lwave1d_cpu.py:15-40).

Runs the sound wave (flag 0/4) and entropy wave (flag 3) at 32 and 64 zones
and asserts both the 64-zone error and the convergence ratio against the
reference's golden values.
"""

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import run

DECK = """
<job>
basename = LinWave

<mesh>
nghost    = 3
nx1       = 64
x1min     = 0.0
x1max     = 3.0
ix1_bc    = periodic
ox1_bc    = periodic
nx2       = 1
x2min     = 0.0
x2max     = 1.5
ix2_bc    = periodic
ox2_bc    = periodic
nx3       = 1
x3min     = 0.0
x3max     = 1.5
ix3_bc    = periodic
ox3_bc    = periodic

<meshblock>
nx1 = 16
nx2 = 1
nx3 = 1

<time>
evolution  = dynamic
integrator = rk2
cfl_number = 0.4
nlim       = -1
tlim       = 1.0
ndiag      = 10000

<hydro>
eos         = ideal
reconstruct = plm
rsolver     = llf
gamma       = 1.66666666667

<problem>
pgen_name = linear_wave
wave_flag = 0
amp       = 1.0e-6
dens      = 1.0
pgas      = 0.6
vx0       = 0.0
along_x1  = true
"""

# (integrator, recon, wave): (max 64-zone rms error, max ratio) from the
# reference thresholds
ERRORS = {
    ("rk2", "plm", "0"): (2.1e-08, 0.28),
    ("rk2", "plm", "4"): (2.1e-08, 0.28),
    ("rk2", "plm", "3"): (1.2e-08, 0.29),
    ("rk3", "wenoz", "0"): (2.3e-11, 0.11),
    ("rk2", "ppm4", "0"): (1.7e-08, 0.35),
    ("rk2", "ppmx", "0"): (2.1e-09, 0.26),
}


def _run_once(tmp_path, integ, recon, wave, res, rsolver):
    pin = ParameterInput.from_string(DECK)
    vx0 = 1.0 if wave == "3" else 0.0
    pin.modify_from_cmdline([
        f"time/integrator={integ}",
        f"hydro/reconstruct={recon}",
        f"hydro/rsolver={rsolver}",
        f"problem/wave_flag={wave}",
        f"problem/vx0={vx0}",
        f"mesh/nx1={res}",
        f"job/basename={tmp_path}/LinWave_{integ}_{recon}_{wave}",
    ])
    mesh, phys, driver, state = run(pin)
    # read rms error from the errs file the pgen wrote
    fname = pin.get_string("job", "basename") + "-errs.dat"
    data = np.loadtxt(fname)
    return float(np.atleast_2d(data)[-1][4])


@pytest.mark.parametrize("integ,recon,wave", sorted(ERRORS))
def test_lwave1d_convergence(tmp_path, integ, recon, wave):
    max_err, max_ratio = ERRORS[(integ, recon, wave)]
    rsolver = "llf"
    e32 = _run_once(tmp_path, integ, recon, wave, 32, rsolver)
    e64 = _run_once(tmp_path, integ, recon, wave, 64, rsolver)
    assert e64 < max_err, f"64-zone error {e64:g} exceeds {max_err:g}"
    assert e64 / e32 < max_ratio, \
        f"convergence ratio {e64 / e32:g} exceeds {max_ratio:g}"


@pytest.mark.parametrize("rsolver", ["llf", "hlle", "hllc", "roe"])
def test_lwave1d_solvers(tmp_path, rsolver):
    """Every Riemann solver passes the plm/rk2 sound-wave threshold."""
    e64 = _run_once(tmp_path, "rk2", "plm", "0", 64, rsolver)
    assert e64 < 2.1e-08


def test_lr_symmetry(tmp_path):
    """L- and R-going sound-wave errors identical (reference asserts this)."""
    el = _run_once(tmp_path, "rk2", "plm", "0", 32, "llf")
    er = _run_once(tmp_path, "rk2", "plm", "4", 32, "llf")
    assert el == pytest.approx(er, rel=1e-10)
