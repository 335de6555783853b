"""Radiation: geodesic-grid quadrature, hohlraum light front, scattering
isotropization.

(reference: src/geodesic-grid/, src/radiation/; tst/test_suite/rad/)
"""

import math

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import run, build
from athenak_jax.radiation.geodesic_grid import GeodesicGrid

DECK = """
<job>
basename = hohl

<mesh>
nghost = 2
nx1 = 64
x1min = 0.0
x1max = 1.0
ix1_bc = user
ox1_bc = outflow
nx2 = 4
x2min = 0.0
x2max = 1.0
nx3 = 4
x3min = 0.0
x3max = 1.0

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.4
tlim = 0.5

<radiation>
nlevel = 2
{opac}

<problem>
pgen_name = rad_hohlraum
i_beam = 1.0
"""


def test_geodesic_quadrature():
    """Angle quadrature integrates low-order moments exactly enough:
    sum w = 1, sum w n = 0, sum w n n = delta/3."""
    for nlev in (1, 2, 4):
        g = GeodesicGrid(nlev)
        assert g.nangles == 10 * nlev ** 2 + 2
        assert abs(g.weights.sum() - 1.0) < 1e-12
        m1 = (g.weights[:, None] * g.nh).sum(axis=0)
        assert np.abs(m1).max() < 1e-12
        m2 = np.einsum("a,ai,aj->ij", g.weights, g.nh, g.nh)
        assert np.abs(m2 - np.eye(3) / 3.0).max() < 2e-3


def test_hohlraum_light_front():
    """The radiation front crosses the box at light speed; behind the
    front E approaches the half-isotropic value sum_{nx>0} w."""
    pin = ParameterInput.from_string(DECK.format(opac=""))
    mesh, phys, driver, state = run(pin)
    mbi = mesh.mb_indcs
    E, F = phys.moments(state["u"])
    E = np.asarray(E)[0, mbi.ks + 1, mbi.js + 1, mbi.is_:mbi.ie + 1]
    x1v, _, _ = mesh.cell_centers(0)
    x = np.asarray(x1v)[mbi.is_:mbi.ie + 1]
    t = mesh.time
    # well behind the front: E ~ sum of w over nx>0 (beam fills half-space)
    wpos = phys.grid.weights[phys.grid.nh[:, 0] > 0].sum()
    behind = x < 0.5 * t
    ahead = x > 1.2 * t
    assert E[behind].mean() > 0.6 * wpos
    assert E[ahead].max() < 0.05 * wpos
    # leading edge: the fastest angles (n_x ~ 1) define a front at x = t
    # (the profile is graded since each angle's front moves at n_x c)
    lit = np.where(E > 0.01 * wpos)[0]
    xfront = x[lit[-1]]
    dx = x[1] - x[0]
    assert 0.8 * t < xfront <= t + 3 * dx, f"front at {xfront}, t={t}"


def test_scattering_isotropizes():
    """Pure relaxation (uniform field, no gradients): strong scattering
    drives I -> J exactly, conserving the mean intensity."""
    import jax.numpy as jnp
    deck = DECK.format(opac="kappa_s = 50.0")
    pin = ParameterInput.from_string(deck)
    mesh, phys, pgen, driver, state = build(pin)
    phys.bvals.user_bc_func = None  # uniform periodic-like relaxation
    # anisotropic but spatially uniform IC: I_a = 1 + n_x, stored in the
    # evolved variable i0 = n^0 n_0 I (negative-definite in flat space)
    nh = phys.grid.nh[:, 0].reshape(1, -1, 1, 1, 1)
    nn = np.asarray(phys.n0) * np.asarray(phys.n_0)
    i0 = jnp.asarray(nn * (1.0 + 0.9 * np.broadcast_to(nh, phys.shape)))
    state = dict(state, u=i0, w=i0)
    state = driver.initialize(state)
    saved = phys.save_state(state)
    s1, _ = phys.stage_update(state, saved, 0.0, 1.0, 0.5)
    out = np.asarray(s1["u"])[0, :, 3, 3, 10]
    J0 = float((phys.grid.weights * np.asarray(i0)[0, :, 3, 3, 10]).sum())
    J1 = float((phys.grid.weights * out).sum())
    # J conserved by scattering
    assert abs(J1 - J0) < 1e-10
    # anisotropy reduced by the implicit factor 1/(1+ks*dt) = 1/26
    aniso0 = 0.9
    aniso1 = (out.max() - out.min()) / 2.0
    assert aniso1 < 0.1 * aniso0


RELAX_DECK = """
<job>
basename = relax

<mesh>
nghost = 2
nx1 = 4
x1min = -0.5
x1max = 0.5
nx2 = 1
x2min = -0.5
x2max = 0.5
nx3 = 1
x3min = -0.5
x3max = 0.5

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 10.0

<coord>
general_rel = true
minkowski = true

<hydro>
eos = ideal
gamma = 2.0
reconstruct = plm
rsolver = hlle

<radiation>
nlevel = 1
arad = 1.0
kappa_a = 1.0
kappa_s = 0.0
kappa_p = 0.0

<problem>
pgen_name = rad_relax
erad = 1.0
temp = 100.0
"""


def test_rad_relax_equilibrium():
    """Gas and radiation relax to the common equilibrium of
    a T^4 + rho T/(gm-1) = const (reference: rad_relax.cpp +
    inputs/radiation/relax.athinput; gamma=2 so gm1=1):
    T^4 + T = 101 -> T_eq = 3.0890."""
    from athenak_jax.main import run as _run
    pin = ParameterInput.from_string(RELAX_DECK)
    mesh, phys, driver, state = _run(pin)
    mbi = mesh.mb_indcs
    act = (slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    w = np.asarray(state["w"])
    tgas = w[:, 4][act] / w[:, 0][act]        # e*gm1/rho, gm1=1
    # radiation energy: coordinate-frame R^00
    er = np.asarray(phys.rad.coord_energy_density(state))
    er = er[(slice(None),) + act[1:]]
    teq = 3.1451803
    assert np.allclose(tgas, teq, rtol=1e-4), tgas.mean()
    assert np.allclose(er, 101.0 - teq, rtol=1e-3), er.mean()
    # the implicit coupling conserves gas+radiation energy to round-off
    assert np.allclose(tgas + er, 101.0, rtol=1e-10)


def test_rad_relax_compton_equilibrium():
    """Pure-scattering relaxation with Compton exchange (reference:
    radiation_source.cpp:290-377): absorption cannot move energy
    (kappa_a = kappa_p = 0), but thermal Compton drives
    T_rad -> T_gas while conserving gas+radiation energy, so the
    equilibrium is the same T^4 + T = 101 root as the absorption
    relax test."""
    from athenak_jax.main import run as _run
    # pure scattering: kappa_s = 2 with inv_te ~ 0.1 gives a Compton
    # exchange rate ~ 4 ks inv_te jr ~ 7/time; the gas velocity is
    # EXPLICIT in the coupling (reference radiation_source.cpp u_tet
    # from the stage primitives), so dt must resolve the radiation-drag
    # time 1/(ks * Er) ~ 0.05 -- hence cfl 0.1 and a mild temperature
    # contrast (the same restriction applies to the reference scheme)
    deck = RELAX_DECK.replace("kappa_a = 1.0", "kappa_a = 0.0") \
                     .replace("kappa_s = 0.0", "kappa_s = 2.0") \
                     .replace("temp = 100.0", "temp = 10.0") \
                     .replace("cfl_number = 0.3", "cfl_number = 0.1") \
                     .replace("tlim = 10.0", "tlim = 6.0")
    # GR code units fix temperature_cgs = mu m_u c^2 / k_B; pick mu so
    # inv_t_electron ~ 0.1, keeping the Compton exchange well-resolved
    deck = deck.replace("<problem>", """<units>
density_cgs = 1.0
bhmass_msun = 1.0
mu = 5.486e-5

<problem>""")
    pin = ParameterInput.from_string(deck)
    pin.set_value("radiation", "compton", "true")
    mesh, phys, driver, state = _run(pin)
    mbi = mesh.mb_indcs
    act = (slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    w = np.asarray(state["w"])
    tgas = w[:, 4][act] / w[:, 0][act]
    er = np.asarray(phys.rad.coord_energy_density(state))
    er = er[(slice(None),) + act[1:]]
    # equilibrium of T^4 + T = 11 (arad = rho = gm1 = 1)
    teq = 1.7442276
    trad = er.mean() ** 0.25
    # energy conserved through the Compton exchange
    assert np.allclose(tgas + er, 11.0, rtol=1e-6), (tgas + er).mean()
    # gas and radiation temperatures equilibrated
    assert np.allclose(tgas, teq, rtol=2e-3), tgas.mean()
    assert np.allclose(trad, teq, rtol=2e-3), trad


def test_compton_requires_units():
    import pytest
    deck = RELAX_DECK + "\n"
    pin = ParameterInput.from_string(deck)
    pin.set_value("radiation", "compton", "true")
    with pytest.raises(ValueError, match="units"):
        build(pin)


SHADOW_DECK = """
<job>
basename = shadow

<mesh>
nghost = 2
nx1 = 64
x1min = -0.25
x1max = 0.25
ix1_bc = user
ox1_bc = outflow
nx2 = 32
x2min = -0.125
x2max = 0.125
ix2_bc = outflow
ox2_bc = outflow
nx3 = 1
x3min = -0.5
x3max = 0.5

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.4
tlim = 0.6

<coord>
general_rel = true
minkowski = true

<hydro>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hlle

<radiation>
nlevel = 2
arad = 1.0
power_opacity = true
kappa_s = 0.0
kappa_p = 0.0
fixed_fluid = true

<problem>
pgen_name = rad_shadow
i_beam = 100.0
"""


@pytest.mark.slow
def test_rad_shadow():
    """The optically thick blob casts a shadow: the beam-lit region
    beside the cloud carries orders of magnitude more radiation energy
    than directly behind it (reference: rad_shadow.cpp)."""
    from athenak_jax.main import run as _run
    pin = ParameterInput.from_string(SHADOW_DECK)
    mesh, phys, driver, state = _run(pin)
    er = np.asarray(phys.rad.coord_energy_density(state))
    mbi = mesh.mb_indcs
    assert np.isfinite(er).all()
    # sample the x ~ +0.2 plane (behind the cloud): on-axis (shadow)
    # vs off-axis (lit)
    i_probe = mbi.is_ + int(0.9 * mbi.nx1)
    j_mid = mbi.js + mbi.nx2 // 2
    j_edge = mbi.js + 1
    shadow = er[:, mbi.ks, j_mid, i_probe].min()
    lit = er[:, mbi.ks, j_edge, i_probe].max()
    assert lit > 1.0e-3
    assert shadow < 0.2 * lit, (shadow, lit)


DIFF_DECK = """
<job>
basename = raddiff

<mesh>
nghost = 2
nx1 = 128
x1min = -2.0
x1max = 2.0
nx2 = 1
x2min = -0.5
x2max = 0.5
nx3 = 1
x3min = -0.5
x3max = 0.5

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = {tlim}

<coord>
general_rel = true
minkowski = true

<hydro>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hlle

<radiation>
nlevel = 2
arad = 1.0
kappa_a = 0.0
kappa_s = 40.0
kappa_p = 0.0
fixed_fluid = true

<problem>
pgen_name = rad_diffusion
v1 = 0.0
nu = 4.0
"""


@pytest.mark.slow
def test_rad_diffusion_pulse():
    """Scattering-dominated Gaussian pulse spreads at the analytic
    diffusion rate: at time t the comoving solution has width factor
    W(t) = 4 D nu^2 (t0'+t') + 1 with D = 1/(3 kappa_s)
    (reference: rad_diffusion.cpp ICs evaluated at a later time)."""
    from athenak_jax.main import run as _run
    tlim = 1.0
    pin = ParameterInput.from_string(DIFF_DECK.format(tlim=tlim))
    mesh, phys, driver, state = _run(pin)
    er = np.asarray(phys.rad.coord_energy_density(state))
    mbi = mesh.mb_indcs
    assert np.isfinite(er).all()
    x1v, _, _ = mesh.cell_centers(0)
    x = x1v[mbi.is_:mbi.ie + 1]
    prof = er[0, 0, 0, mbi.is_:mbi.ie + 1]
    nu, ks = 4.0, 40.0
    dd = 1.0 / (3.0 * ks)
    want = (np.exp(-nu**2 * x**2 / (4*dd*nu**2*tlim + 1.0))
            / np.sqrt(4*dd*nu**2*tlim + 1.0))
    # M1/angular discretization keeps the pulse within a few % of the
    # diffusion solution at tau >> 1
    core = np.abs(x) < 1.0
    err = np.abs(prof - want)[core].max() / want.max()
    assert err < 0.08, err
