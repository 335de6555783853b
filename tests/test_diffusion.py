"""Diffusion: measured decay rates of sinusoidal perturbations vs analytic.

Mirrors the reference diffusion regression suite
(reference: tst/test_suite/diffusion/) but validates against the exact
linear decay rates instead of golden values:

  shear mode    vy ~ exp(-nu k^2 t)
  field mode    by ~ exp(-eta k^2 t)
  entropy mode  dT ~ exp(-alpha (gamma-1)/gamma k^2 t)
"""

import math

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import run
from athenak_jax.indices import IDN, IEN, IVY

BASE = """
<job>
basename = diff

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
tlim = {tlim}

<{phys}>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = {rsolver}
{coeffs}

<problem>
pgen_name = diffusion_test
perturb = {perturb}
amp = 1.0e-6
"""


def _amplitude(x, y):
    """Least-squares amplitude of sin(2 pi x) in y."""
    s = np.sin(2.0 * math.pi * x)
    return abs(np.dot(y, s) / np.dot(s, s))


def _cells(mesh):
    mbi = mesh.mb_indcs
    return slice(mbi.is_, mbi.ie + 1)


def test_viscous_shear_decay():
    nu = 0.02
    tlim = 2.0
    deck = BASE.format(phys="hydro", rsolver="hllc", tlim=tlim,
                       coeffs=f"nu_iso = {nu}", perturb="vy")
    pin = ParameterInput.from_string(deck)
    mesh, phys, driver, state = run(pin)
    x1v, _, _ = mesh.cell_centers(0)
    act = _cells(mesh)
    vy = np.asarray(state["w"])[0, IVY, 0, 0, act]
    amp = _amplitude(x1v[act], vy)
    expect = 1.0e-6 * math.exp(-nu * (2 * math.pi) ** 2 * tlim)
    assert np.isclose(amp, expect, rtol=0.05)


def test_ohmic_field_decay():
    """Zero background field: By perturbation decays by pure diffusion
    (with b0 != 0 it would be a resistively damped Alfven wave at half
    this rate)."""
    eta = 0.02
    tlim = 2.0
    deck = BASE.format(phys="mhd", rsolver="hlld", tlim=tlim,
                       coeffs=f"eta_ohm = {eta}", perturb="by")
    pin = ParameterInput.from_string(deck)
    mesh, phys, driver, state = run(pin)
    x1v, _, _ = mesh.cell_centers(0)
    act = _cells(mesh)
    by = np.asarray(state["bcc"])[0, 1, 0, 0, act]
    amp = _amplitude(x1v[act], by)
    expect = 1.0e-6 * math.exp(-eta * (2 * math.pi) ** 2 * tlim)
    assert np.isclose(amp, expect, rtol=0.05)


def test_conduction_entropy_decay():
    alpha = 0.02
    tlim = 2.0
    gam = 5.0 / 3.0
    deck = BASE.format(phys="hydro", rsolver="hllc", tlim=tlim,
                       coeffs=f"alpha_iso = {alpha}", perturb="temp")
    pin = ParameterInput.from_string(deck)
    mesh, phys, driver, state = run(pin)
    x1v, _, _ = mesh.cell_centers(0)
    act = _cells(mesh)
    w = np.asarray(state["w"])[0, :, 0, 0, act]
    temp = (gam - 1.0) * w[IEN] / w[IDN]
    dT = temp - temp.mean()
    amp = _amplitude(x1v[act], dT)
    chi = alpha * (gam - 1.0) / gam
    # initial dT amplitude = T0 * amp with T0 = p0/d0 = 1
    expect = 1.0e-6 * math.exp(-chi * (2 * math.pi) ** 2 * tlim)
    assert np.isclose(amp, expect, rtol=0.05)


def test_ambipolar_field_decay():
    """Pressure-balanced Bz(x1) perturbation on uniform Bz background:
    stationary mode with J perpendicular to B, decaying at eta_ad B^2 k^2.

    Weak field (vA^2 << cs^2) so the compressive back-reaction factor
    cs^2/(cs^2+vA^2) -> 1 (flux-freezing partially restores B as the gas
    re-balances total pressure)."""
    eta_ad = 2.0
    b0 = 0.1
    tlim = 2.0
    deck = BASE.format(phys="mhd", rsolver="hlld", tlim=tlim,
                       coeffs=f"eta_ad = {eta_ad}", perturb="bz_pb")
    deck += f"b0 = {b0}\n"
    pin = ParameterInput.from_string(deck)
    mesh, phys, driver, state = run(pin)
    x1v, _, _ = mesh.cell_centers(0)
    act = _cells(mesh)
    bz = np.asarray(state["bcc"])[0, 2, 0, 0, act]
    amp = _amplitude(x1v[act], bz - bz.mean())
    expect = 1.0e-6 * math.exp(
        -eta_ad * b0 ** 2 * (2 * math.pi) ** 2 * tlim)
    assert np.isclose(amp, expect, rtol=0.05)


SMR_DECK = """
<job>
basename = diffsmr

<mesh>
nghost = 2
nx1 = 32
x1min = 0.0
x1max = 1.0
nx2 = 8
x2min = 0.0
x2max = 0.25
nx3 = 1
x3min = 0.0
x3max = 1.0

<meshblock>
nx1 = 8
nx2 = 8

<mesh_refinement>
refinement = static
num_levels = 2

<refined_region1>
level = 1
x1min = 0.25
x1max = 0.75
x2min = 0.0
x2max = 0.25

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.4
tlim = {tlim}

<{phys}>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = {rsolver}
{coeffs}

<problem>
pgen_name = diffusion_test
perturb = {perturb}
amp = 1.0e-6
"""


@pytest.mark.slow
def test_viscous_shear_decay_smr():
    """Viscosity composes with SMR (reference runs diffusion on refined
    meshes freely): the decay rate on a 2-level mesh matches the
    analytic nu k^2, i.e. the level boundary neither damps nor feeds
    the mode."""
    nu = 0.02
    tlim = 1.0
    deck = SMR_DECK.format(phys="hydro", rsolver="hllc", tlim=tlim,
                           coeffs=f"nu_iso = {nu}", perturb="vy")
    pin = ParameterInput.from_string(deck)
    mesh, phys, driver, state = run(pin)
    assert mesh.multilevel and mesh.mb_lev.max() == 1
    mbi = mesh.mb_indcs
    act = (slice(None), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.ie + 1))
    vy = np.asarray(state["w"])[:, IVY, 0]
    amp = np.abs(vy[act]).max()
    expect = 1.0e-6 * math.exp(-nu * (2 * math.pi) ** 2 * tlim)
    assert np.isclose(amp, expect, rtol=0.05)


@pytest.mark.slow
def test_ohmic_field_decay_smr():
    """Ohmic resistivity composes with SMR: resistive EMFs ride the
    edge-EMF correction, div(B) stays at round-off and the decay rate
    matches eta k^2."""
    eta = 0.02
    tlim = 1.0
    deck = SMR_DECK.format(phys="mhd", rsolver="hlld", tlim=tlim,
                           coeffs=f"eta_ohm = {eta}", perturb="by")
    pin = ParameterInput.from_string(deck)
    mesh, phys, driver, state = run(pin)
    assert mesh.multilevel
    mbi = mesh.mb_indcs
    act = (slice(None), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.ie + 1))
    by = np.asarray(state["bcc"])[:, 1, 0]
    amp = np.abs(by[act]).max()
    expect = 1.0e-6 * math.exp(-eta * (2 * math.pi) ** 2 * tlim)
    assert np.isclose(amp, expect, rtol=0.05)
