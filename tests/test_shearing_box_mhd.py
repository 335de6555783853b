"""MHD shearing-wave regression (reference:
tst/test_suite/sbox/test_sbox_mhdshwave_mpicpu.py).

Runs the compressible MHD shwave of Johnson, Guan & Gammie (2008,
figure 11) and compares the evolution of the dByc mode amplitude
against the semi-analytic solution obtained by integrating the
linearized equations of motion (table from the reference test suite,
originally provided by C. Gammie & B. Johnson).
"""

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import run

# dByc(t) for t in [0, 3] every 0.01
DBYC = np.array([
    1.36931e-07, 1.28815e-07, 1.07707e-07, 7.62110e-08, 4.23426e-08, 1.32185e-09,
    -3.87724e-08, -7.40506e-08, -9.87246e-08, -1.16802e-07, -1.23362e-07, -1.18208e-07,
    -1.04505e-07, -8.04852e-08, -4.98106e-08, -1.93897e-08, 1.54716e-08, 4.80139e-08,
    7.54768e-08, 9.38418e-08, 1.06338e-07, 1.09509e-07, 1.04556e-07, 9.09907e-08,
    7.03736e-08, 4.77003e-08, 1.93603e-08, -9.68054e-09, -3.42018e-08, -5.84271e-08,
    -7.74343e-08, -8.89311e-08, -9.51379e-08, -9.40686e-08, -8.73045e-08, -7.39243e-08,
    -5.56273e-08, -3.64617e-08, -1.31662e-08, 1.03062e-08, 2.99858e-08, 4.94559e-08,
    6.49406e-08, 7.46434e-08, 8.05161e-08, 8.09087e-08, 7.68229e-08, 6.77213e-08,
    5.46246e-08, 4.04430e-08, 2.26687e-08, 4.12050e-09, -1.20621e-08, -2.89283e-08,
    -4.34604e-08, -5.37980e-08, -6.20288e-08, -6.60789e-08, -6.68865e-08, -6.38676e-08,
    -5.82536e-08, -4.91178e-08, -3.76301e-08, -2.60487e-08, -1.22002e-08, 2.19303e-10,
    1.36256e-08, 2.57754e-08, 3.50509e-08, 4.33582e-08, 4.91123e-08, 5.19474e-08,
    5.25523e-08, 5.08796e-08, 4.67220e-08, 4.04784e-08, 3.35132e-08, 2.45141e-08,
    1.58711e-08, 5.88514e-09, -3.90754e-09, -1.20847e-08, -2.03312e-08, -2.65610e-08,
    -3.21058e-08, -3.59443e-08, -3.78613e-08, -3.83426e-08, -3.73463e-08, -3.47612e-08,
    -3.08277e-08, -2.64050e-08, -2.06473e-08, -1.50695e-08, -8.55572e-09, -2.07482e-09,
    3.43521e-09, 9.12927e-09, 1.35814e-08, 1.77565e-08, 2.06369e-08, 2.28818e-08,
    2.40554e-08, 2.42214e-08, 2.34848e-08, 2.20908e-08, 1.98127e-08, 1.69331e-08,
    1.40054e-08, 1.04574e-08, 7.21290e-09, 3.61130e-09, 5.70384e-10, -2.55057e-09,
    -5.25076e-09, -7.23267e-09, -8.94492e-09, -9.98909e-09, -1.06303e-08, -1.07364e-08,
    -1.04248e-08, -9.68374e-09, -8.74610e-09, -7.46591e-09, -6.20714e-09, -4.74801e-09,
    -3.33695e-09, -2.19415e-09, -1.10171e-09, -3.47726e-10, 2.20111e-10, 4.60218e-10,
    4.33263e-10, 1.12372e-10, -3.87121e-10, -1.13795e-09, -1.91805e-09, -2.84862e-09,
    -3.65496e-09, -4.45758e-09, -5.06642e-09, -5.38102e-09, -5.41891e-09, -5.13141e-09,
    -4.41655e-09, -3.27645e-09, -1.91551e-09, -2.63436e-11, 1.92502e-09, 4.35233e-09,
    6.63758e-09, 9.24538e-09, 1.17674e-08, 1.38270e-08, 1.58137e-08, 1.71830e-08,
    1.81667e-08, 1.84652e-08, 1.80795e-08, 1.68795e-08, 1.51137e-08, 1.23567e-08,
    9.26436e-09, 5.14873e-09, 4.86000e-10, -3.98366e-09, -9.19885e-09, -1.38296e-08,
    -1.88192e-08, -2.28700e-08, -2.67765e-08, -2.97761e-08, -3.15177e-08, -3.22850e-08,
    -3.18126e-08, -2.99192e-08, -2.65765e-08, -2.24343e-08, -1.65713e-08, -1.04396e-08,
    -2.73753e-09, 5.51545e-09, 1.30248e-08, 2.13114e-08, 2.82155e-08, 3.50901e-08,
    4.06429e-08, 4.41833e-08, 4.63278e-08, 4.64287e-08, 4.43929e-08, 4.00582e-08,
    3.43460e-08, 2.60156e-08, 1.71668e-08, 5.97422e-09, -6.02759e-09, -1.68954e-08,
    -2.87610e-08, -3.96068e-08, -4.78670e-08, -5.50615e-08, -5.91900e-08, -6.09194e-08,
    -5.93185e-08, -5.50306e-08, -4.70783e-08, -3.74576e-08, -2.42025e-08, -9.00962e-09,
    5.46658e-09, 2.20015e-08, 3.78398e-08, 5.05149e-08, 6.23142e-08, 7.06773e-08,
    7.46584e-08, 7.48131e-08, 7.09304e-08, 6.20939e-08, 4.88831e-08, 3.40093e-08,
    1.46222e-08, -6.42394e-09, -2.54179e-08, -4.57730e-08, -6.36356e-08, -7.63025e-08,
    -8.58570e-08, -8.95711e-08, -8.75315e-08, -7.91275e-08, -6.45986e-08, -4.72013e-08,
    -2.37300e-08, 2.29595e-09, 2.60330e-08, 5.15391e-08, 7.37823e-08, 8.92576e-08,
    1.00359e-07, 1.03656e-07, 9.95387e-08, 8.70136e-08, 6.68360e-08, 4.04104e-08,
    1.32961e-08, -1.90367e-08, -5.06481e-08, -7.58516e-08, -9.85180e-08, -1.12978e-07,
    -1.17595e-07, -1.12743e-07, -9.73153e-08, -7.23556e-08, -4.37686e-08, -6.94745e-09,
    3.15430e-08, 6.41650e-08, 9.57125e-08, 1.18594e-07, 1.30180e-07, 1.29677e-07,
    1.16581e-07, 9.10965e-08, 5.54419e-08, 1.79436e-08, -2.69008e-08, -6.99926e-08,
    -1.06573e-07, -1.30160e-07, -1.43629e-07, -1.41384e-07, -1.23128e-07, -9.46564e-08,
    -5.17544e-08, -1.80583e-09, 4.95549e-08, 9.14983e-08, 1.29231e-07, 1.52269e-07,
    1.57305e-07, 1.43115e-07, 1.15221e-07, 6.96857e-08, 1.42947e-08, -4.41858e-08,
    -9.83014e-08, -1.36897e-07, -1.64096e-07, -1.70176e-07, -1.53648e-07, -1.16029e-07,
    -6.84345e-08, -5.18798e-09, 6.01508e-08, 1.18489e-07, 1.61356e-07, 1.82156e-07,
    1.79271e-07,
])

DECK = """
<job>
basename = shwave4

<mesh>
nghost = 3
nx1 = 16
x1min = -0.25
x1max = 0.25
ix1_bc = shear_periodic
ox1_bc = shear_periodic
nx2 = 16
x2min = -0.25
x2max = 0.25
nx3 = 16
x3min = -0.25
x3max = 0.25

<meshblock>
nx1 = 16
nx2 = 8
nx3 = 16

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
nlim = -1
tlim = 3.0

<shearing_box>
qshear = 1.5
omega0 = 1.0

<mhd>
eos = isothermal
reconstruct = wenoz
rsolver = hlle
iso_sound_speed = 1.0

<problem>
pgen_name = shwave
ipert = 4
d0 = 1.0
amp = 1.0e-6
nwx = -2
nwy = 1
nwz = 1
beta = 20

<output1>
file_type = hst
dt = 0.01
user_hist_only = true
"""


def test_mhd_shwave(tmp_path):
    pin = ParameterInput.from_string(DECK)
    pin.modify_from_cmdline([f"job/basename={tmp_path}/shwave4"])
    mesh, phys, driver, state = run(pin)
    data = np.loadtxt(f"{tmp_path}/shwave4.user.hst")
    t, dbyc = data[:, 0], data[:, 2]
    # sample the semi-analytic table at the output times
    ref = np.interp(t, np.linspace(0.0, 3.0, 301), DBYC)
    err = np.abs(dbyc - ref).mean()
    # reference threshold at 16^3 (test_sbox_mhdshwave_mpicpu.py)
    assert err < 2.1e-8, f"MHD shwave mean error {err:g} > 2.1e-8"

    # div-B at round-off through orbital advection + shear BCs
    mbi = mesh.mb_indcs
    bfc = state["bfc"]
    x1f = np.asarray(bfc["x1f"])
    x2f = np.asarray(bfc["x2f"])
    x3f = np.asarray(bfc["x3f"])
    ms = mesh.mesh_size
    div = ((x1f[..., 1:] - x1f[..., :-1]) / ms.dx1
           + (x2f[..., 1:, :] - x2f[..., :-1, :]) / ms.dx2
           + (x3f[..., 1:, :, :] - x3f[..., :-1, :, :]) / ms.dx3)
    a = (slice(None), slice(mbi.ks, mbi.ke + 1),
         slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    assert np.abs(div[a]).max() < 1e-12


MRI2D_DECK = """
<job>
basename = hb3

<mesh>
nghost = 3
nx1 = 32
x1min = -0.5
x1max = 0.5
ix1_bc = shear_periodic
ox1_bc = shear_periodic
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

<time>
evolution = dynamic
integrator = rk3
cfl_number = 0.4
tlim = {tlim}

<shearing_box>
qshear = 1.5
omega0 = 1.0

<mhd>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hlld

<problem>
pgen_name = mri2d
beta = 400
amp = 0.01
ifield = 2
"""


def _me3(state, mesh):
    """Volume-integrated toroidal magnetic energy (component 3)."""
    mbi = mesh.mb_indcs
    act = (slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    b3 = np.asarray(state["bcc"])[:, 2]
    return float((0.5 * b3[act] ** 2).sum())


def _divb_max(state, mesh):
    mbi = mesh.mb_indcs
    bfc = state["bfc"]
    b1 = np.asarray(bfc["x1f"])
    b2 = np.asarray(bfc["x2f"])
    ms = mesh.mesh_size
    act = (slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    div = ((b1[..., mbi.is_ + 1:mbi.ie + 2] -
            b1[..., mbi.is_:mbi.ie + 1])[:, :, mbi.js:mbi.je + 1] / ms.dx1
           + (b2[..., mbi.js + 1:mbi.je + 2, :]
              - b2[..., mbi.js:mbi.je + 1, :])[
                  ..., mbi.is_:mbi.ie + 1] / ms.dx2)
    return float(np.abs(div[:, mbi.ks:mbi.ke + 1]).max())


@pytest.mark.slow
def test_mri2d_growth(tmp_path):
    """2D r-z MRI (HB92 "HB3", reference pgen mri2d.cpp): with a
    resolved uniform vertical field the toroidal magnetic energy grows
    by orders of magnitude within a few 1/Omega — driven by the
    SourceTermsFC background-orbital EMF — while div(B) stays at
    round-off."""
    import os
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        # t=2 is past the initial transient (measured ME3(2) ~ 1.5e-7);
        # the instability then e-folds at ~0.45/Omega on B
        pin = ParameterInput.from_string(MRI2D_DECK.format(tlim=2.0))
        mesh1, phys1, driver1, st1 = run(pin)
        me_early = _me3(st1, mesh1)

        pin = ParameterInput.from_string(MRI2D_DECK.format(tlim=7.0))
        mesh2, phys2, driver2, st2 = run(pin)
        me_late = _me3(st2, mesh2)
    finally:
        os.chdir(cwd)
    assert np.isfinite(np.asarray(st2["w"])).all()
    assert _divb_max(st2, mesh2) < 1e-10
    # measured growth over dt=5 is ~e^4.5; require a conservative 10x
    assert me_late > 10.0 * me_early, (me_early, me_late)
