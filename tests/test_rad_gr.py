"""GR radiation: tetrad identities, angular-flux conservation, and the
coupled radiation-hydro linear wave (reference:
tst/test_suite/rad/test_rad_lwave1d_amr_cpu.py, inputs/lwave_rad.athinput).
"""

import math

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import run


def test_tetrad_orthonormal():
    """e_(a)^mu g_munu e_(b)^nu = eta_ab on random points in Kerr."""
    from athenak_jax.gr.cks import metric
    from athenak_jax.radiation.tetrad import tetrad

    rng = np.random.default_rng(7)
    x = rng.uniform(2.0, 8.0, 64)
    y = rng.uniform(-6.0, 6.0, 64)
    z = rng.uniform(-5.0, 5.0, 64)
    spin = 0.9
    gl, gu = metric(x, y, z, spin)
    e, ecov = tetrad(x, y, z, spin)
    eta = np.diag([-1.0, 1.0, 1.0, 1.0])
    for a in range(4):
        for b in range(4):
            dot = sum(np.asarray(gl[mu][nu]) * np.asarray(e[a][mu])
                      * np.asarray(e[b][nu])
                      for mu in range(4) for nu in range(4))
            assert np.abs(dot - eta[a, b]).max() < 1e-11, (a, b)
        # covariant tetrad consistency: ecov = g . e
        for mu in range(4):
            cov = sum(np.asarray(gl[nu][mu]) * np.asarray(e[a][nu])
                      for nu in range(4))
            assert np.abs(cov - np.asarray(ecov[a][mu])).max() < 1e-11


def test_ricci_rotation_flat_zero():
    from athenak_jax.radiation.tetrad import ricci_rotation

    x = np.linspace(1.5, 4.0, 8)
    om = ricci_rotation(x, x, x, 0.0, minkowski=True)
    for i in range(4):
        for j in range(4):
            for k in range(4):
                assert np.abs(np.asarray(om[i][j][k])).max() < 1e-12


def test_ricci_rotation_antisymmetry():
    """omega_(ab)c antisymmetric in its first two (flat) indices after
    lowering with eta — a structural identity of rotation coefficients."""
    from athenak_jax.radiation.tetrad import ricci_rotation

    rng = np.random.default_rng(3)
    x = rng.uniform(2.5, 6.0, 32)
    y = rng.uniform(-4.0, 4.0, 32)
    z = rng.uniform(-4.0, 4.0, 32)
    om = ricci_rotation(x, y, z, 0.6)
    eta = [-1.0, 1.0, 1.0, 1.0]
    for a in range(4):
        for b in range(4):
            for c in range(4):
                lhs = eta[a] * np.asarray(om[a][b][c])
                rhs = -eta[b] * np.asarray(om[b][a][c])
                assert np.abs(lhs - rhs).max() < 1e-8, (a, b, c)


RAD_LWAVE_DECK = """
<job>
basename = rad_linwave

<mesh>
nghost = 4
nx1 = 32
x1min = 0.0
x1max = 1.0
nx2 = 1
x2min = 0.0
x2max = 1.0
nx3 = 1
x3min = 0.0
x3max = 1.0

<meshblock>
nx1 = 8
nx2 = 1
nx3 = 1

<coord>
general_rel = true
minkowski = true

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
nlim = -1
tlim = 1.0

<hydro>
eos = ideal
reconstruct = wenoz
rsolver = hlle
gamma = 1.6666666666666667

<radiation>
nlevel = 0
angular_fluxes = false
reconstruct = plm
kappa_a = 10.0
kappa_s = 10.0
kappa_p = 0.0
arad = 19.253382731290966

<problem>
pgen_name = rad_linear_wave
along_x1 = true
rho = 1.0
pgas = 2.497687326549491e-01
erad = 7.493061979648474e-02
delta = 1.0e-4
omega_real = 3.1488157526582414e+00
omega_imag = -2.6190006385782953e-02
drho_real = 8.3877889167048014e-01
drho_imag = 0.0
dpgas_real = 3.2084488925731219e-01
dpgas_imag = -9.9134535607493107e-03
dux_real = 4.2035369927276667e-01
dux_imag = -3.4962560317943620e-03
derad_real = 1.2904189937790903e-01
derad_imag = 1.5203926879094193e-03
dfxrad_real = 1.3260665610966586e-03
dfxrad_imag = -6.7017329068802516e-03
"""


def _run_rad_lwave(tmp_path, res, tag):
    pin = ParameterInput.from_string(RAD_LWAVE_DECK)
    pin.modify_from_cmdline([
        f"job/basename={tmp_path}/radlw{tag}",
        f"mesh/nx1={res}", f"meshblock/nx1={res // 4}",
    ])
    mesh, phys, driver, state = run(pin)
    data = np.loadtxt(pin.get_string("job", "basename") + "-errs.dat")
    return float(np.atleast_2d(data)[-1][4])


def test_rad_lwave1d_convergence(tmp_path):
    e32 = _run_rad_lwave(tmp_path, 32, "a")
    e64 = _run_rad_lwave(tmp_path, 64, "b")
    # uniform-grid gates (measured: 1.80e-6 / 5.01e-7, ratio 0.278;
    # the reference's tighter (3.5e-7, 0.23) is for its ADAPTIVE run
    # where most of the wave sits one level finer)
    assert e64 < 6.0e-7, f"rad lwave 64-zone error {e64:g}"
    assert e64 / e32 < 0.32, f"rad lwave ratio {e64 / e32:g}"


def test_rad_lwave1d_amr_smoke(tmp_path):
    """Short coupled radiation-hydro run with adaptive refinement: the
    tree refines on the wave crest, the i0 remap keeps intensities
    finite, and the run advances (reference: rad AMR deck,
    inputs/lwave_rad.athinput <mesh_refinement> block)."""
    pin = ParameterInput.from_string(RAD_LWAVE_DECK)
    extra = ("\n<mesh_refinement>\nrefinement = adaptive\n"
             "num_levels = 2\nncycle_check = 2\n"
             "refinement_interval = 2\n"
             "<amr_criterion1>\nmethod = min_max\n"
             "variable = hydro_u_d\nvalue_max = 1.00005\n")
    pin2 = ParameterInput.from_string(RAD_LWAVE_DECK + extra)
    pin2.modify_from_cmdline([
        f"job/basename={tmp_path}/radlwamr", "time/nlim=10",
    ])
    mesh, phys, driver, state = run(pin2)
    assert driver.pamr is not None
    assert driver.pamr.nmb_created > 0
    assert np.isfinite(np.asarray(state["i0"])).all()
    assert np.isfinite(np.asarray(state["u"])).all()
    del pin


def test_angular_flux_conservation():
    """The angular flux divergence telescopes: summing divfa * dOmega
    over all angles gives zero (the edge fluxes are antisymmetric)."""
    import jax
    jax.config.update("jax_enable_x64", True)
    from athenak_jax.bvals import BoundaryValues
    from athenak_jax.mesh import Mesh
    from athenak_jax.radiation.radiation import Radiation

    deck = """
<job>
basename = angtest
<mesh>
nghost = 2
nx1 = 8
x1min = 2.0
x1max = 6.0
nx2 = 8
x2min = -2.0
x2max = 2.0
nx3 = 8
x3min = -2.0
x3max = 2.0
<coord>
general_rel = true
a = 0.5
excise = false
<radiation>
nlevel = 2
angular_fluxes = true
<time>
evolution = dynamic
tlim = 1.0
"""
    pin = ParameterInput.from_string(deck)
    mesh = Mesh(pin)
    bv = BoundaryValues(mesh)
    rad = Radiation(pin, mesh, bv)
    rng = np.random.default_rng(5)
    n0n_0 = np.asarray(rad.n0) * np.asarray(rad.n_0)
    i0 = n0n_0 * rng.uniform(0.5, 2.0, rad.shape)
    div = np.asarray(rad.divfa(i0))
    tot = (div * rad.grid.solid_angles.reshape(1, -1, 1, 1, 1)).sum(axis=1)
    scale = np.abs(div).max()
    assert np.abs(tot).max() < 1e-10 * max(scale, 1.0)


BEAM_DECK = """
<job>
basename = beam

<mesh>
nghost = 2
nx1 = 32
x1min = -0.5
x1max = 4.5
ix1_bc = user
ox1_bc = user
nx2 = 32
x2min = -0.5
x2max = 4.5
ix2_bc = user
ox2_bc = user
nx3 = 1
x3min = -0.5
x3max = 0.5

<meshblock>
nx1 = 16
nx2 = 16
nx3 = 1

<coord>
general_rel = true
a = -0.9
excise = true
dexcise = -1.0
pexcise = -1.0

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
nlim = 25
tlim = 10.0

<radiation>
nlevel = 2
reconstruct = plm
angular_fluxes = true

<rad_srcterms>
rad_beam = true
dii_dt = 1.0
pos_1 = 3.91
pos_2 = 0.0
pos_3 = 0.0
dir_1 = 0.0
dir_2 = 1.0
dir_3 = 0.0
width = 0.7
spread = 10.0

<problem>
pgen_name = rad_beam
"""


def test_rad_beam_kerr(tmp_path):
    """Beam through Kerr spacetime (reference: rad_beam deck +
    test_rad_beam_gpu.py): intensities stay finite/nonnegative, energy
    appears along the beam, and the horizon region stays excised."""
    pin = ParameterInput.from_string(BEAM_DECK)
    pin.modify_from_cmdline([f"job/basename={tmp_path}/beam"])
    mesh, phys, driver, state = run(pin)
    i0 = np.asarray(state["u"])
    assert np.isfinite(i0).all()
    E = np.asarray(phys.moments(state["u"])[0])
    assert np.isfinite(E).all()
    assert E.max() > 1.0e-3          # beam energy injected + transported
    assert E.min() > -1.0e-10        # non-negative energy density
    # excised cells hold zero intensity
    if phys.excise_mask is not None:
        assert np.abs(i0[np.broadcast_to(
            phys.excise_mask[:, None], i0.shape)]).max() == 0.0

    # ---- quantitative regression (CPU/f64 goldens): injected-energy
    # budget and beam-lobe geometry after 25 cycles.  Measured:
    # total E = 2.1824, centroid = (3.767, 0.2105), Emax = 0.3551.
    mbi = mesh.mb_indcs
    act = (slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    Ea = E[act]
    tot, cx, cy = 0.0, 0.0, 0.0
    for gid in range(mesh.nmb_total):
        x1, x2, _ = mesh.cell_centers(gid)
        x1 = x1[mbi.is_:mbi.ie + 1]
        x2 = x2[mbi.js:mbi.je + 1]
        e = Ea[gid, 0]
        tot += e.sum()
        cx += (e * x1[None, :]).sum()
        cy += (e * x2[:, None]).sum()
    assert abs(tot - 2.1824) < 0.05 * 2.1824, tot
    assert abs(cx / tot - 3.767) < 0.1, cx / tot
    assert abs(cy / tot - 0.2105) < 0.05, cy / tot
    assert abs(Ea.max() - 0.3551) < 0.05 * 0.3551, Ea.max()
