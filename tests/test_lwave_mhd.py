"""1D MHD linear-wave convergence, mirroring the reference thresholds
(reference: tst/test_suite/nr/test_nr_lwave1d_cpu.py MHD entries).

Wave flags: 0/6 fast, 1/5 Alfven, 2/4 slow, 3 entropy.
"""

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import run

DECK = """
<job>
basename = LinWaveMHD

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

<mhd>
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
bx0       = 1.0
by0       = 1.4142136
bz0       = 0.5
along_x1  = true
"""

# reference thresholds (error @64 zones, convergence ratio)
ERRORS = {
    ("rk2", "plm", "0"): (2.5e-08, 0.28),   # fast
    ("rk2", "plm", "6"): (2.5e-08, 0.28),
    ("rk2", "plm", "5"): (1.7e-08, 0.29),   # Alfven
    ("rk2", "plm", "4"): (2.8e-08, 0.32),   # slow
    ("rk2", "plm", "3"): (2.2e-08, 0.30),   # entropy
    ("rk3", "wenoz", "0"): (1.8e-10, 0.23),
}


def _run_once(tmp_path, integ, recon, wave, res, rsolver):
    pin = ParameterInput.from_string(DECK)
    vx0 = 1.0 if wave == "3" else 0.0
    pin.modify_from_cmdline([
        f"time/integrator={integ}",
        f"mhd/reconstruct={recon}",
        f"mhd/rsolver={rsolver}",
        f"problem/wave_flag={wave}",
        f"problem/vx0={vx0}",
        f"mesh/nx1={res}",
        f"job/basename={tmp_path}/LW_{integ}_{recon}_{wave}_{rsolver}",
    ])
    run(pin)
    fname = pin.get_string("job", "basename") + "-errs.dat"
    data = np.loadtxt(fname)
    return float(np.atleast_2d(data)[-1][4])


@pytest.mark.parametrize("integ,recon,wave", sorted(ERRORS))
def test_lwave1d_mhd_convergence(tmp_path, integ, recon, wave):
    max_err, max_ratio = ERRORS[(integ, recon, wave)]
    e32 = _run_once(tmp_path, integ, recon, wave, 32, "llf")
    e64 = _run_once(tmp_path, integ, recon, wave, 64, "llf")
    assert e64 < max_err, f"64-zone error {e64:g} exceeds {max_err:g}"
    assert e64 / e32 < max_ratio, \
        f"convergence ratio {e64 / e32:g} exceeds {max_ratio:g}"


@pytest.mark.parametrize("rsolver", ["llf", "hlle", "hlld"])
def test_lwave1d_mhd_solvers(tmp_path, rsolver):
    e64 = _run_once(tmp_path, "rk2", "plm", "0", 64, rsolver)
    assert e64 < 2.5e-08
