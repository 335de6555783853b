"""MHD on statically refined meshes: face-field restriction/prolongation,
EMF correction, div(B) preservation, and conservation.

Validation: linear face fields are reproduced exactly by the mixed-level
exchange (area-average restriction and min-mod/average prolongation are
exact for linear data); an Orszag-Tang-like vortex crossing refinement
boundaries keeps div(B) at round-off on BOTH levels (EMF correction) and
conserves mass/energy (CC flux correction).
"""

import jax.numpy as jnp
import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build

DECK = """
<job>
basename = smrmhd

<mesh>
nghost = 2
nx1 = 32
x1min = -0.5
x1max = 0.5
nx2 = 32
x2min = -0.5
x2max = 0.5
nx3 = {nx3}
x3min = -0.5
x3max = 0.5

<meshblock>
nx1 = 8
nx2 = 8
{mb3}

<mesh_refinement>
refinement = static

<refined_region1>
level = 1
x1min = -0.125
x1max = 0.125
x2min = -0.125
x2max = 0.125
x3min = -0.125
x3max = 0.125

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = {tlim}

<mhd>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hlld

<problem>
pgen_name = {pgen}
{pextra}
"""


def _build(pgen, nx3=1, tlim=0.1, pextra=""):
    mb3 = "nx3 = 8" if nx3 > 1 else ""
    pin = ParameterInput.from_string(DECK.format(
        pgen=pgen, nx3=nx3, mb3=mb3, tlim=tlim, pextra=pextra))
    return build(pin)


def _face_coords(mesh, gid):
    x1f, x2f, x3f = mesh.face_edges(gid)
    x1v, x2v, x3v = mesh.cell_centers(gid)
    return (x1f, x2f, x3f), (x1v, x2v, x3v)


def test_fc_linear_ghost_exactness_2d():
    """Linear B components are reproduced exactly in all mixed-level
    face ghosts (skipping periodic-wrap faces)."""
    mesh, phys, pgen, driver, state = _build("orszag_tang")
    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    ng = mbi.ng

    def f1(x, y):
        return 0.2 + 1.3 * x - 0.7 * y

    def f2(x, y):
        return -0.4 + 0.6 * x + 1.1 * y

    b1 = np.zeros((nmb, 1, mbi.ncells2, mbi.ncells1 + 1))
    b2 = np.zeros((nmb, 1, mbi.ncells2 + 1, mbi.ncells1))
    b3 = np.zeros((nmb, 2, mbi.ncells2, mbi.ncells1))
    for gid in range(nmb):
        (x1f, x2f, _), (x1v, x2v, _) = _face_coords(mesh, gid)
        b1[gid, 0] = f1(x1f[None, :], x2v[:, None])
        b2[gid, 0] = f2(x1v[None, :], x2f[:, None])
        b3[gid, :] = f1(x1v[None, :], x2v[:, None])
    bfc = {"x1f": jnp.asarray(b1), "x2f": jnp.asarray(b2),
           "x3f": jnp.asarray(b3)}
    filled = {k: np.asarray(v)
              for k, v in phys.fill_ghosts_fc(bfc).items()}

    errs = []
    for gid in range(nmb):
        lev = mesh.mb_lev[gid]
        lloc = mesh.lloc_eachmb[gid]
        nb = 4 << lev
        (x1f, x2f, _), (x1v, x2v, _) = _face_coords(mesh, gid)
        ex1 = f1(x1f[None, :], x2v[:, None])
        ex2 = f2(x1v[None, :], x2f[:, None])
        # interior transverse ranges
        jt = slice(mbi.js, mbi.je + 1)
        it = slice(mbi.is_, mbi.ie + 1)
        jtf = slice(mbi.js, mbi.je + 2)
        itf = slice(mbi.is_, mbi.ie + 2)
        # x1 ghosts of both components (skip wrap faces)
        if lloc[0] > 0:
            errs.append(np.abs(filled["x1f"][gid, 0, jt, :ng]
                               - ex1[jt, :ng]).max())
            errs.append(np.abs(filled["x2f"][gid, 0, jtf, :ng]
                               - ex2[jtf, :ng]).max())
        if lloc[0] < nb - 1:
            errs.append(np.abs(filled["x1f"][gid, 0, jt, -ng:]
                               - ex1[jt, -ng:]).max())
            errs.append(np.abs(filled["x2f"][gid, 0, jtf, -ng:]
                               - ex2[jtf, -ng:]).max())
        # x2 ghosts
        if lloc[1] > 0:
            errs.append(np.abs(filled["x2f"][gid, 0, :ng, it]
                               - ex2[:ng, it]).max())
            errs.append(np.abs(filled["x1f"][gid, 0, :ng, itf]
                               - ex1[:ng, itf]).max())
        if lloc[1] < nb - 1:
            errs.append(np.abs(filled["x2f"][gid, 0, -ng:, it]
                               - ex2[-ng:, it]).max())
            errs.append(np.abs(filled["x1f"][gid, 0, -ng:, itf]
                               - ex1[-ng:, itf]).max())
    assert max(errs) < 1e-12, max(errs)


def _divb_max(mesh, bfc):
    mbi = mesh.mb_indcs
    it = slice(mbi.is_, mbi.ie + 1)
    jt = slice(mbi.js, mbi.je + 1)
    kt = slice(mbi.ks, mbi.ke + 1) if mbi.nx3 > 1 else slice(None)
    b1 = np.asarray(bfc["x1f"])
    b2 = np.asarray(bfc["x2f"])
    dx1 = mesh.mb_size["dx1"].reshape(-1, 1, 1, 1)
    dx2 = mesh.mb_size["dx2"].reshape(-1, 1, 1, 1)
    div = ((b1[:, :, :, 1:] - b1[:, :, :, :-1]) / dx1
           + (b2[:, :, 1:, :] - b2[:, :, :-1, :]) / dx2)
    if mbi.nx3 > 1:
        b3 = np.asarray(bfc["x3f"])
        dx3 = mesh.mb_size["dx3"].reshape(-1, 1, 1, 1)
        div = div + (b3[:, 1:, :, :] - b3[:, :-1, :, :]) / dx3
    return np.abs(div[:, kt, jt, it]).max()


def _totals(mesh, u):
    mbi = mesh.mb_indcs
    it = slice(mbi.is_, mbi.ie + 1)
    jt = slice(mbi.js, mbi.je + 1)
    kt = slice(mbi.ks, mbi.ke + 1) if mbi.nx3 > 1 else slice(None)
    dv = mesh.mb_size["dx1"] * mesh.mb_size["dx2"]
    if mbi.nx3 > 1:
        dv = dv * mesh.mb_size["dx3"]
    act = np.asarray(u)[:, :, kt, jt, it]
    return (act.sum(axis=(2, 3, 4)) * dv[:, None]).sum(axis=0)


def test_divb_and_conservation_2d():
    mesh, phys, pgen, driver, state = _build("orszag_tang", tlim=0.05)
    state = driver.initialize(state)
    assert _divb_max(mesh, state["bfc"]) < 1e-11
    tot0 = _totals(mesh, state["u"])
    state = driver.execute(state)
    assert mesh.ncycle > 10
    assert _divb_max(mesh, state["bfc"]) < 1e-11
    tot1 = _totals(mesh, state["u"])
    assert abs(tot1[0] - tot0[0]) < 1e-12 * abs(tot0[0])
    assert abs(tot1[4] - tot0[4]) < 1e-12 * abs(tot0[4])
    assert not np.isnan(np.asarray(state["u"])).any()


def test_divb_and_conservation_3d():
    mesh, phys, pgen, driver, state = _build(
        "blast", nx3=32, tlim=0.02,
        pextra="inner_radius = 0.08\nouter_radius = 0.15\n"
               "prat = 20.0\nb_amb = 0.2")
    state = driver.initialize(state)
    assert _divb_max(mesh, state["bfc"]) < 1e-11
    tot0 = _totals(mesh, state["u"])
    state = driver.execute(state)
    assert mesh.ncycle > 5
    assert _divb_max(mesh, state["bfc"]) < 1e-11
    tot1 = _totals(mesh, state["u"])
    assert abs(tot1[0] - tot0[0]) < 1e-12 * abs(tot0[0])
    assert abs(tot1[4] - tot0[4]) < 1e-12 * abs(tot0[4])
    assert not np.isnan(np.asarray(state["u"])).any()
