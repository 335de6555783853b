"""Disk-magnetosphere: star-disk interaction with a dipole cavity.

Physical invariants of src/pgen/fluids/disk-magnetosphere.cpp (the
reference ships no regression for this pgen): the IC has the Keplerian
disk outside rmagsph and the dense stellar atmosphere inside, div-B at
round-off for the dipole, the rfix interior stays pinned, the floor
holds everywhere, the planet orbits at the Keplerian rate with the
sin^2 mass ramp, and a short evolution stays finite.
"""

import math

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build

DECK = open("inputs/mhd/disk_magnetosphere.athinput").read()


def _divb(mesh, bfc):
    mbi = mesh.mb_indcs
    b1 = np.asarray(bfc["x1f"])
    b2 = np.asarray(bfc["x2f"])
    b3 = np.asarray(bfc["x3f"])
    dx = mesh.mesh_size.dx1
    dy = mesh.mesh_size.dx2
    dz = mesh.mesh_size.dx3
    act = (slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    div = ((b1[:, :, :, 1:] - b1[:, :, :, :-1]) / dx
           + (b2[:, :, 1:, :] - b2[:, :, :-1, :]) / dy
           + (b3[:, 1:, :, :] - b3[:, :-1, :, :]) / dz)
    return np.abs(div[act]).max()


def test_disk_magnetosphere_ic():
    pin = ParameterInput.from_string(DECK)
    mesh, phys, pgen, driver, state = build(pin)
    w = np.asarray(state["w"])
    mbi = mesh.mb_indcs

    # dipole field is divergence-free to round-off
    assert _divb(mesh, state["bfc"]) < 1e-12

    rho_in, rho_disk, vphi_err = [], [], []
    for gid in range(mesh.nmb_total):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        X3, X2, X1 = np.meshgrid(x3v, x2v, x1v, indexing="ij")
        rc = np.sqrt(X1 ** 2 + X2 ** 2 + X3 ** 2)
        d = w[gid, 0]
        rho_in.append(d[rc < 0.15].max() if (rc < 0.15).any() else 0.0)
        mid = (np.abs(X3) < 0.05) & (np.abs(rc - 1.0) < 0.1)
        if mid.any():
            rho_disk.append(d[mid].max())
            # azimuthal speed ~ Keplerian at r=1
            vphi = (-w[gid, 1] * X2 + w[gid, 2] * X1) / \
                np.sqrt(X1 ** 2 + X2 ** 2)
            vphi_err.append(np.abs(vphi[mid] - 1.0).max())
    # dense stellar interior, ordinary disk outside the cavity
    assert max(rho_in) > 50.0
    assert 0.3 < max(rho_disk) < 3.0
    assert max(vphi_err) < 0.2  # near-Keplerian (pressure correction)

    # planet history: mass ramp at t=0 is zero, position at x0
    labels, vals = phys.user_hist_func(mesh, dict(state, t=0.0))
    h = dict(zip(labels, vals))
    assert h["mp0"] == 0.0 and abs(h["xpp0"] - 1.0) < 1e-12
    # half an insertion period later the ramp is partial and the planet
    # has moved along its circular orbit at the Keplerian rate
    t1 = 2.0
    labels, vals = phys.user_hist_func(mesh, dict(state, t=t1))
    h1 = dict(zip(labels, vals))
    ome = math.sqrt((1.0 + 1.0e-3) / 1.0)
    assert abs(h1["xpp0"] - math.cos(ome * t1)) < 1e-12
    assert 0.0 < h1["mp0"] < 1.0e-3


@pytest.mark.slow
def test_disk_magnetosphere_evolves():
    """Short evolution of the (deliberately under-resolved) star-disk
    box: stays finite with positive floored density, div-B at
    round-off, and the rfix interior pinned to the initial stellar
    atmosphere.  The magnetosphere boundary layer is violent at this
    resolution (the production problem resolves scales 0.05-4 with
    AMR); the robustness invariants are the regression."""
    import jax
    import jax.numpy as jnp

    pin = ParameterInput.from_string(DECK)
    pin.set_value("time", "tlim", "0.5")
    mesh, phys, pgen, driver, state = build(pin)
    u0 = np.asarray(state["u"]).copy()
    state = driver.initialize(state)
    fn = jax.jit(driver.make_cycle_fn())
    dt = jnp.asarray(driver.mesh.dt, dtype=state["u"].dtype)
    for _ in range(8):
        state, dtnew, _ = fn(state, dt)
        dt = jnp.asarray(min(float(dtnew) * driver.cfl_no,
                             2.0 * float(dt)), dt.dtype)
    out = driver._unpadded(state)
    u = np.asarray(out["u"])
    assert np.isfinite(u).all()
    assert _divb(mesh, out["bfc"]) < 1e-11
    mbi = mesh.mb_indcs
    act = (slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    assert u[:, 0][act].min() > 0.0
    # rfix interior pinned: density inside rc<0.05 unchanged
    for gid in range(mesh.nmb_total):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        X3, X2, X1 = np.meshgrid(x3v[mbi.ks:mbi.ke + 1],
                                 x2v[mbi.js:mbi.je + 1],
                                 x1v[mbi.is_:mbi.ie + 1], indexing="ij")
        rc = np.sqrt(X1 ** 2 + X2 ** 2 + X3 ** 2)
        inside = rc < 0.05
        if inside.any():
            d_now = u[gid, 0, mbi.ks:mbi.ke + 1, mbi.js:mbi.je + 1,
                      mbi.is_:mbi.ie + 1][inside]
            d_ic = u0[gid, 0, mbi.ks:mbi.ke + 1, mbi.js:mbi.je + 1,
                      mbi.is_:mbi.ie + 1][inside]
            np.testing.assert_allclose(d_now, d_ic, rtol=1e-6)
