"""Derived output variables (reference: src/outputs/outputs.hpp
var_choice + derived_variables.cpp kernels): channel counts, labels, and
analytic sanity on known fields."""

import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build
from athenak_jax.outputs.variables import resolve

MHD_DECK = """
<job>
basename = dv

<mesh>
nghost = 2
nx1 = 16
x1min = -0.5
x1max = 0.5
nx2 = 16
x2min = -0.5
x2max = 0.5
nx3 = 16
x3min = -0.5
x3max = 0.5

<meshblock>
nx1 = 16
nx2 = 16
nx3 = 16

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 1.0

<mhd>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hlld

<problem>
pgen_name = blast
inner_radius = 0.1
outer_radius = 0.25
prat = 10.0
b_amb = 0.5
"""


def _mhd_state():
    pin = ParameterInput.from_string(MHD_DECK)
    mesh, phys, pgen, driver, state = build(pin)
    state = driver.initialize(state)
    return mesh, phys, state


def test_mhd_curvature_variables():
    mesh, phys, state = _mhd_state()
    mbi = mesh.mb_indcs
    act = (slice(None), slice(None), slice(mbi.ks + 1, mbi.ke),
           slice(mbi.js + 1, mbi.je), slice(mbi.is_ + 1, mbi.ie))
    for name, label in [("mhd_curv", "curv"), ("mhd_curv_alt", "curv_alt"),
                        ("mhd_k_jxb", "k_jxb"),
                        ("mhd_curv_perp", "curv_perp")]:
        labels, arr = resolve(name, phys, state, mesh)
        assert labels == [label]
        a = np.asarray(arr)
        assert a.shape[1] == 1
        assert np.isfinite(a[act]).all(), name
        # blast field is uniform B = (b_amb,0,0): all curvature
        # diagnostics vanish in the interior
        assert np.abs(a[act]).max() < 1e-10, name


def test_sgs_channel_counts():
    mesh, phys, state = _mhd_state()
    labels, arr = resolve("mhd_sgs", phys, state, mesh)
    assert len(labels) == 59 and arr.shape[1] == 59  # reference n_sgs
    # consistency: channel 8 is mx*mx/rho
    u = np.asarray(state["u"])
    np.testing.assert_allclose(np.asarray(arr)[:, 8],
                               u[:, 1] ** 2 / u[:, 0], rtol=1e-12)


def test_dynamo_ks_channels():
    mesh, phys, state = _mhd_state()
    labels, arr = resolve("mhd_dynamo_ks", phys, state, mesh)
    assert len(labels) == 8 and arr.shape[1] == 8
    a = np.asarray(arr)
    # B2/B4 exact for the uniform ambient field outside the blast
    bcc = np.asarray(state["bcc"])
    b2 = (bcc ** 2).sum(axis=1)
    np.testing.assert_allclose(a[:, 0], b2, rtol=1e-12)
    np.testing.assert_allclose(a[:, 1], b2 * b2, rtol=1e-12)


def test_z4c_constraint_monitors():
    deck = """
<job>
basename = dvz

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
integrator = rk2
cfl_number = 0.25
tlim = 1.0

<z4c>
diss = 0.5

<problem>
pgen_name = z4c_one_puncture
punc_ADM_mass = 1.0
"""
    pin = ParameterInput.from_string(deck)
    mesh, phys, pgen, driver, state = build(pin)
    state = driver.initialize(state)
    labels, arr = resolve("con", phys, state, mesh)
    assert labels == ["con_C", "con_H", "con_M", "con_Z",
                      "con_Mx", "con_My", "con_Mz"]
    a = np.asarray(arr)
    mbi = mesh.mb_indcs
    act = (slice(None), slice(None), slice(mbi.ks + 2, mbi.ke - 1),
           slice(mbi.js + 2, mbi.je - 1), slice(mbi.is_ + 2, mbi.ie - 1))
    assert np.isfinite(a[act]).all()
    # C = H^2 + M^2 + Theta^2 + 4Z >= each non-negative part
    assert (a[act][:, 0] >= 0).all()
    assert (a[act][:, 3] >= -1e-30).all()
    C = a[:, 0]
    H = a[:, 1]
    M = a[:, 2]
    Z = a[:, 3]
    lhs = C[act[0], act[2], act[3], act[4]]
    rhs = (H ** 2 + M ** 2 + 4 * Z)[act[0], act[2], act[3], act[4]]
    # C also contains Theta^2 >= 0
    assert (lhs - rhs >= -1e-12 * np.abs(lhs).max()).all()


def test_prtcl_density_deposit():
    deck = MHD_DECK + """
<particles>
ppc = 2
pusher = drift
"""
    pin = ParameterInput.from_string(deck)
    mesh, phys, pgen, driver, state = build(pin)
    state = driver.initialize(state)
    labels, arr = resolve("prtcl_d", phys, state, mesh)
    assert labels == ["prtcl_d"]
    dens = np.asarray(arr)[:, 0]
    ms = mesh.mesh_size
    vol = float(ms.dx1) * float(ms.dx2) * float(ms.dx3)
    total = dens.sum() * vol
    assert abs(total - phys.ppart.nprtcl) < 0.5


def test_mhd_jcon_manufactured():
    """4-current from a manufactured field: static fluid, B_z = a*x in
    flat space => j^2 = a/sqrt(4pi), other components ~0 (reference:
    derived_variables.cpp:364-527 with get_detg_Fcon)."""
    import jax.numpy as jnp
    mesh, phys, state = _mhd_state()
    mbi = mesh.mb_indcs
    a = 0.7
    x1 = np.linspace(-0.5, 0.5, mbi.nx1, endpoint=False) + 0.5 / mbi.nx1
    xg = np.concatenate([x1[:2] - 2 * (x1[1] - x1[0]), x1,
                         x1[-2:] + 2 * (x1[1] - x1[0])])[:mbi.ncells1]
    # rebuild padded coordinate (ng=2 ghosts each side)
    dx = x1[1] - x1[0]
    xg = np.arange(mbi.ncells1) * dx + (-0.5 - 2 * dx) + 0.5 * dx
    w = np.zeros_like(np.asarray(state["w"]))
    w[:, 0] = 1.0
    w[:, 4] = 1.0
    bcc = np.zeros_like(np.asarray(state["bcc"]))
    bcc[:, 2] = a * xg[None, None, None, :]
    w = jnp.asarray(w)
    bcc = jnp.asarray(bcc)

    # no prior state -> zeros (reference have_prior=False branch)
    labels, j = resolve("mhd_jcon", phys, dict(state, w=w, bcc=bcc), mesh)
    assert labels == ["j0", "j1", "j2", "j3"]
    assert np.all(np.asarray(j) == 0.0)

    # prior state identical (static): time term vanishes
    phys._jcon_prev = (w, bcc, 0.1)
    try:
        labels, j = resolve("mhd_jcon", phys, dict(state, w=w, bcc=bcc),
                            mesh)
    finally:
        phys._jcon_prev = None
    j = np.asarray(j)
    act = (slice(None), slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_ + 1, mbi.ie))
    # Ampere: (curl B)_y = d_z B_x - d_x B_z = -a
    expect = -a / np.sqrt(4.0 * np.pi)
    np.testing.assert_allclose(j[:, 2][act[0], act[2], act[3], act[4]],
                               expect, rtol=1e-10)
    for c in (0, 1, 3):
        assert np.abs(j[:, c][act[0], act[2], act[3], act[4]]).max() \
            < 1e-12


def test_rad_moments_10ch_and_fluid_frame():
    """rad_coord gives the 10 symmetric R^{munu}; trace-free holds; a
    static fluid's rad_fluid moments equal the coordinate moments in
    flat space (reference: derived_variables.cpp:1076-1260)."""
    import importlib.util
    import sys as _sys
    spec = importlib.util.spec_from_file_location(
        "tr", "tests/test_radiation.py")
    tr = importlib.util.module_from_spec(spec)
    _sys.modules["tr"] = tr
    spec.loader.exec_module(tr)
    pin = ParameterInput.from_string(tr.DECK.format(opac=""))
    mesh, phys, pgen, driver, state = build(pin)
    state = driver.initialize(state)

    labels, R = resolve("rad_coord", phys, state, mesh)
    assert labels[0] == "r00" and len(labels) == 10
    R = np.asarray(R)
    r00, r11, r22, r33 = R[:, 0], R[:, 4], R[:, 7], R[:, 9]
    assert (r00 > 0).any()
    # R^mu_mu = 0 in flat space: -r00 + r11 + r22 + r33 = 0
    np.testing.assert_allclose(r11 + r22 + r33, r00, rtol=1e-10)

    # static fluid: fluid-frame == coordinate-frame in flat space
    import jax.numpy as jnp
    w = jnp.zeros(R[:, :5].shape, dtype=state["u"].dtype)
    w = w.at[:, 0].set(1.0)
    lf, Rf = phys.fluid_moments(state["u"], w)
    assert lf[0] == "fr00"
    np.testing.assert_allclose(np.asarray(Rf), R, rtol=1e-10,
                               atol=1e-12)
