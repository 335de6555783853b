"""Z4c: Minkowski exactness, linear-wave propagation + convergence,
constraint behavior.

(reference: tst/test_suite/z4c/, src/pgen/tests/z4c_linear_wave.cpp)
"""

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build, run

DECK = """
<job>
basename = z4clw

<mesh>
nghost = {ng}
nx1 = {nx}
x1min = 0.0
x1max = 1.0
nx2 = 4
x2min = 0.0
x2max = 1.0
nx3 = 4
x3min = 0.0
x3max = 1.0

<time>
evolution = dynamic
integrator = rk3
cfl_number = 0.25
tlim = 1.0

<z4c>
diss = 0.5
damp_kappa1 = 0.02
damp_kappa2 = 0.0
lapse_oplog = 2.0
lapse_advect = 1.0
shift_eta = 2.0

<problem>
pgen_name = z4c_linear_wave
amp = 1.0e-6
kx1 = 1.0
kx2 = 0.0
kx3 = 0.0
"""


def test_minkowski_rhs_zero():
    """Flat space in trivial gauge must be an exact fixed point."""
    pin = ParameterInput.from_string(DECK.format(ng=2, nx=16))
    pin.set_value("problem", "amp", 0.0)
    mesh, phys, pgen, driver, state = build(pin)
    rhs = np.asarray(phys.rhs(state["u"]))
    mbi = mesh.mb_indcs
    act = (slice(None), slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    assert np.abs(rhs[act]).max() < 1e-13


@pytest.mark.parametrize("ng", [2, 3])
def test_z4c_linear_wave_propagates(ng):
    """One period of a +-polarized wave along x: the solution returns to
    the initial data with small L1 error, and the error converges."""
    errs = {}
    for nx in (16, 32):
        pin = ParameterInput.from_string(DECK.format(ng=ng, nx=nx))
        import os
        mesh, phys, driver, state = run(pin)
        fname = "z4clw-errs.dat"
        data = np.atleast_2d(np.loadtxt(fname))
        os.remove(fname)
        errs[nx] = float(data[-1, 4])
        u = np.asarray(state["u"])
        assert np.isfinite(u).all()
    # convergence: at least ~2nd order for ng=2, better for ng=3
    ratio = errs[32] / errs[16]
    assert ratio < 0.35, f"no convergence: {errs}"
    # absolute accuracy for amp=1e-6 (2nd order at ng=2, 4th at ng=3)
    assert errs[32] < (2.0e-8 if ng == 2 else 2.0e-9), f"errs: {errs}"


def test_z4c_constraints_small():
    """Hamiltonian/momentum constraints stay at the amp^2 level for a
    linear wave."""
    pin = ParameterInput.from_string(DECK.format(ng=3, nx=32))
    mesh, phys, driver, state = run(pin)
    H, M2 = phys.adm_constraints(state["u"])
    mbi = mesh.mb_indcs
    act = (slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    h = np.abs(np.asarray(H)[act]).max()
    m = np.abs(np.asarray(M2)[act]).max()
    # amp = 1e-6: quadratic constraint violation ~1e-12 + truncation
    assert h < 1.0e-8, f"H violation {h}"
    assert m < 1.0e-16, f"M^2 violation {m}"
