"""External initial-data importers (reference: pgen/z4c/spectre/
z4c_spectre_bbh.cpp, pgen/dyn_grmhd/lorene/lorene_bns.cpp).

Round-trip strategy: export an analytic solution onto a donor grid,
import it through the file path, and compare against the direct pgen.
"""

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build

Z4C_DECK = """
<job>
basename = imp

<mesh>
nghost = 2
nx1 = 16
x1min = -4.0
x1max = 4.0
ix1_bc = outflow
ox1_bc = outflow
nx2 = 16
x2min = -4.0
x2max = 4.0
ix2_bc = outflow
ox2_bc = outflow
nx3 = 16
x3min = -4.0
x3max = 4.0
ix3_bc = outflow
ox3_bc = outflow

<time>
evolution = dynamic
integrator = rk3
cfl_number = 0.25
tlim = 0.05

<z4c>
diss = 0.1

<problem>
pgen_name = {pgen}
{extra}
"""


def _donor_puncture(path, n=96, ext=8.0, m=1.0):
    """Brill-Lindquist ADM data on a donor grid (analytic)."""
    xs = np.linspace(-ext, ext, n)
    Z, Y, X = np.meshgrid(xs, xs, xs, indexing="ij")
    r = np.maximum(np.sqrt(X * X + Y * Y + Z * Z), 1e-12)
    psi4 = (1.0 + 0.5 * m / r) ** 4
    zero = np.zeros_like(psi4)
    data = {"x": xs, "y": xs, "z": xs,
            "g_xx": psi4, "g_yy": psi4, "g_zz": psi4,
            "g_xy": zero, "g_xz": zero, "g_yz": zero,
            "K_xx": zero, "K_xy": zero, "K_xz": zero,
            "K_yy": zero, "K_yz": zero, "K_zz": zero,
            "alpha": psi4 ** (-0.5)}
    np.savez(path, **data)


def test_z4c_adm_import_matches_direct(tmp_path):
    from athenak_jax.z4c.z4c import I_ALPHA, I_CHI, I_GXX

    donor = str(tmp_path / "bl.npz")
    _donor_puncture(donor)
    deck = Z4C_DECK.format(pgen="z4c_adm_import",
                           extra=f"id_filename = {donor}")
    pin = ParameterInput.from_string(deck)
    mesh, phys, pgen, driver, state = build(pin)
    u_imp = np.asarray(state["u"])

    deck2 = Z4C_DECK.format(pgen="z4c_one_puncture",
                            extra="punc_ADM_mass = 1.0")
    pin2 = ParameterInput.from_string(deck2)
    mesh2, phys2, pgen2, driver2, state2 = build(pin2)
    u_dir = np.asarray(state2["u"])

    mbi = mesh.mb_indcs
    act = (slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    # interpolation error of the donor resolution, away from the
    # puncture the fields are smooth: few-1e-3 agreement
    for ch, tol in ((I_CHI, 5e-3), (I_GXX, 1e-12), (I_ALPHA, 5e-3)):
        d = np.abs(u_imp[:, ch][act] - u_dir[:, ch][act])
        assert d.max() < tol, (ch, d.max())

    # short evolution stays finite
    state = driver.initialize(state)
    state = driver.execute(state)
    assert np.isfinite(np.asarray(state["u"])).all()


DYNGR_DECK = """
<job>
basename = impbns

<mesh>
nghost = 2
nx1 = 16
x1min = -16.0
x1max = 16.0
ix1_bc = outflow
ox1_bc = outflow
nx2 = 16
x2min = -16.0
x2max = 16.0
ix2_bc = outflow
ox2_bc = outflow
nx3 = 16
x3min = -16.0
x3max = 16.0
ix3_bc = outflow
ox3_bc = outflow

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.25
tlim = 0.05

<coord>
general_rel = true
minkowski = true

<adm>

<mhd>
eos = ideal
dyn_eos = ideal
dyn_error = reset_floor
reconstruct = plm
rsolver = llf
gamma = 2.0
dfloor = 1.0e-12
pfloor = 1.0e-15

<problem>
pgen_name = {pgen}
{extra}
"""


def _donor_tov(path, mesh, phys, n=80, ext=18.0):
    """Sample the TOV-star solution onto a donor grid via the tov pgen's
    own solver (the 'external solver output' stand-in)."""
    from athenak_jax.utils_tov import PolytropeEOS, TOVStar

    eos = PolytropeEOS(kappa=100.0, gamma=2.0)
    tov = TOVStar(eos, rhoc=1.28e-3, dr=1e-3)
    xs = np.linspace(-ext, ext, n)
    Z, Y, X = np.meshgrid(xs, xs, xs, indexing="ij")
    r = np.sqrt(X * X + Y * Y + Z * Z)
    rho, P, _m, alp, psi4 = tov.sample_iso(r.ravel())
    rho = rho.reshape(r.shape)
    P = P.reshape(r.shape)
    alp = alp.reshape(r.shape)
    psi4 = psi4.reshape(r.shape)
    zero = np.zeros_like(psi4)
    np.savez(path, x=xs, y=xs, z=xs,
             g_xx=psi4, g_yy=psi4, g_zz=psi4,
             g_xy=zero, g_xz=zero, g_yz=zero,
             K_xx=zero, K_xy=zero, K_xz=zero,
             K_yy=zero, K_yz=zero, K_zz=zero,
             alpha=alp, rho=rho, press=P,
             vel_x=zero, vel_y=zero, vel_z=zero)
    return tov


def test_dyngr_bns_import_matches_tov(tmp_path):
    donor = str(tmp_path / "tov.npz")

    deck2 = DYNGR_DECK.format(
        pgen="dyngr_tov", extra="rhoc = 1.28e-3\nkappa = 100.0\n"
                                "gamma = 2.0")
    pin2 = ParameterInput.from_string(deck2)
    mesh2, phys2, pgen2, driver2, state2 = build(pin2)
    _donor_tov(donor, mesh2, phys2)

    deck = DYNGR_DECK.format(pgen="dyngr_bns_import",
                             extra=f"id_filename = {donor}")
    pin = ParameterInput.from_string(deck)
    mesh, phys, pgen, driver, state = build(pin)

    w_imp = np.asarray(state["w"])
    w_dir = np.asarray(state2["w"])
    mbi = mesh.mb_indcs
    act = (slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    # central density and profile agree to donor-grid interpolation error
    assert abs(w_imp[:, 0][act].max() - w_dir[:, 0][act].max()) \
        < 0.02 * w_dir[:, 0][act].max()
    d = np.abs(w_imp[:, 0][act] - w_dir[:, 0][act])
    assert d.max() < 0.05 * w_dir[:, 0][act].max()

    # short fixed-spacetime evolution stays finite
    state = driver.initialize(state)
    state = driver.execute(state)
    assert np.isfinite(np.asarray(state["w"])).all()
