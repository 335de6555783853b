"""CCE worldtube dumps + horizon cube dumps (reference: src/z4c/cce/,
src/z4c/horizon_dump.cpp): quadrature correctness, format round-trip,
and the deck-driven dump cadence on a one-puncture run."""

import glob
import math
import os

import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import run
from athenak_jax.z4c.cce import (CCE, chebyshev2_points,
                                 gauss_legendre_sphere, read_cce,
                                 read_horizon_dump, ylm_scalar)

DECK = """
<job>
basename = punc

<mesh>
nghost = 2
nx1 = 16
x1min = -6.0
x1max = 6.0
ix1_bc = outflow
ox1_bc = outflow
nx2 = 16
x2min = -6.0
x2max = 6.0
ix2_bc = outflow
ox2_bc = outflow
nx3 = 16
x3min = -6.0
x3max = 6.0
ix3_bc = outflow
ox3_bc = outflow

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.25
nlim = 2
tlim = 1.0

<z4c>
diss = 0.5
damp_kappa1 = 0.02
damp_kappa2 = 0.0
lapse_oplog = 2.0
lapse_advect = 1.0
shift_Gamma = 0.75
shift_eta = 2.0
dump_horizon_0 = true
co_0_dump_radius = 2.0
horizon_0_Nx = 6
horizon_dt = 100.0

<cce>
num_radii = 1
rin_0 = 2.0
rout_0 = 5.0
num_l_modes = 4
num_radial_modes = 3
cce_dt = 100.0

<problem>
pgen_name = z4c_one_puncture
punc_ADM_mass = 1.0
"""


def test_gauss_legendre_ylm_orthonormality():
    """The GL sphere integrates Ylm pairs exactly up to its band limit
    (reference quadrature: gauss_legendre.cpp:60-75)."""
    ntheta = 9
    theta, phi, w = gauss_legendre_sphere(ntheta)
    assert abs(w.sum() - 4.0 * math.pi) < 1e-12
    modes = [(0, 0), (1, 0), (1, 1), (2, -1), (2, 2), (4, 3), (8, -5)]
    for (l1, m1) in modes:
        r1, i1 = ylm_scalar(l1, m1, theta, phi)
        for (l2, m2) in modes:
            r2, i2 = ylm_scalar(l2, m2, theta, phi)
            # int Y1 conj(Y2) dOmega = delta_12
            re = np.sum(w * (r1 * r2 + i1 * i2))
            im = np.sum(w * (i1 * r2 - r1 * i2))
            want = 1.0 if (l1, m1) == (l2, m2) else 0.0
            assert abs(re - want) < 1e-10, (l1, m1, l2, m2, re)
            assert abs(im) < 1e-10


def test_chebyshev_radii():
    r = chebyshev2_points(2.0, 5.0, 7)
    assert np.all((r > 2.0) & (r < 5.0))
    assert np.all(np.diff(r) > 0)  # k ascending -> radius ascending


def test_cce_and_horizon_dump_roundtrip(tmp_path):
    """One-puncture run with <cce> + dump_horizon_0: files appear, read
    back with the right headers, and the l=0 alpha mode matches the
    sphere average of the interpolated lapse."""
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        pin = ParameterInput.from_string(DECK)
        mesh, phys, driver, state = run(pin)

        cce_files = sorted(glob.glob("cce/cce_*.bin"))
        assert cce_files, "no CCE dump written"
        d = read_cce(cce_files[0])
        assert d["nr"] == 3 and d["num_l_modes"] == 4
        assert d["rin"] == 2.0 and d["rout"] == 5.0
        assert d["real"].shape == (3, 10, 25)
        assert np.isfinite(d["real"]).all() and np.isfinite(d["imag"]).all()

        # physical content: c00(alpha) = sqrt(4 pi) * <alpha>_sphere,
        # with 0 < alpha < 1 outside the puncture
        for k in range(3):
            c00 = d["real"][k, 0, 0]
            mean_alpha = c00 / math.sqrt(4.0 * math.pi)
            assert 0.3 < mean_alpha < 1.0, (k, mean_alpha)
        # g_xx ~ psi^4 > 1 near the puncture: positive monopole
        assert d["real"][0, 4, 0] > d["real"][2, 4, 0] > 0.0

        # independent projection check at the innermost shell
        from athenak_jax.z4c.cce import cce_fields
        wt = CCE(pin, mesh, 0)
        fields = cce_fields(phys, state["u"])
        data_r, data_i = wt.decompose(mesh, fields)
        final = [read_cce(f) for f in cce_files]
        final = [d2 for d2 in final if d2["time"] == mesh.time]
        assert final, "no CCE dump at the final time"
        np.testing.assert_allclose(
            data_r, final[0]["real"].reshape(-1), rtol=0, atol=1e-12)

        # horizon cube dump
        hfiles = sorted(glob.glob("horizon_0/output_*/etk_output_file.dat"))
        assert hfiles, "no horizon dump written"
        h = read_horizon_dump(hfiles[0], 6)
        assert h["common_horizon"] == 0
        assert h["time"] == 0.0
        alpha = h["data"][0]
        gxx = h["data"][4]
        assert np.isfinite(h["data"]).all()
        assert (alpha > 0.0).all() and (alpha < 1.05).all()
        assert (gxx > 0.9).all()
        # ETK parameter file written alongside
        par = os.path.join(os.path.dirname(hfiles[0]),
                           "ET_analyze_BHaH_data_horizon.par")
        assert os.path.exists(par)
        with open(par) as f:
            txt = f.read()
        assert "AHFinderDirect::N_horizons = 1" in txt
        assert "Driver::global_nsize = 6" in txt
    finally:
        os.chdir(cwd)
