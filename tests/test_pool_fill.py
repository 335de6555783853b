"""The block pool's gather ghost fill against a periodic wrap.

On a periodic same-level multi-block mesh every ghost cell (and ghost
face) of a block is a copy of the global field at the wrapped position,
so ``numpy.pad(mode="wrap")`` of the global field is an exact reference
for the cell-centred fill (bvals.fill_ghosts) and the face-centred fill
(MHD.fill_ghosts_fc).  Copies are exact data movement: no rounding to
tolerate.
"""

import jax
import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build

DECK = """
<job>
basename = pool_fill
precision = single

<mesh>
nghost = 2
nx1 = 16
x1min = -0.5
x1max = 0.5
nx2 = {nx2}
x2min = -0.5
x2max = 0.5
nx3 = {nx3}
x3min = -0.5
x3max = 0.5

<meshblock>
nx1 = 8
nx2 = {mb2}
nx3 = {mb3}

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 1.0

<mhd>
eos = ideal
reconstruct = plm
rsolver = hlld
gamma = 1.6666666666666667

<problem>
pgen_name = blast
inner_radius = 0.1
outer_radius = 0.25
prat = 100.0
b_amb = 0.1
"""


def _blocks(glob, mesh, active, face_axis=None):
    """Per-block arrays [nmb, ..., n3, n2, n1] cut from the wrap-padded
    global field ``glob`` [..., N3, N2, N1]: each block's ghost cells
    hold the periodic image, and only ``active`` axes have ghosts."""
    mbi = mesh.mb_indcs
    ng = mbi.ng
    nx = (mbi.nx3, mbi.nx2, mbi.nx1)
    lead = glob.ndim - 3
    pad = [(0, 0)] * lead
    for a in range(3):
        g = ng if active[a] else 0
        pad.append((g, g + (1 if face_axis == a and active[a] else 0)))
    wrapped = np.pad(glob, pad, mode="wrap")
    out = []
    for gid in range(mesh.nmb_total):
        l1, l2, l3 = mesh.lloc_eachmb[gid][:3]
        lo = (l3 * nx[0], l2 * nx[1], l1 * nx[2])
        sl = []
        for a in range(3):
            g = ng if active[a] else 0
            ext = nx[a] + 2 * g + (1 if face_axis == a else 0)
            sl.append(slice(lo[a], lo[a] + ext))
        out.append(wrapped[(Ellipsis,) + tuple(sl)])
    return np.stack(out)


@pytest.mark.parametrize("dims", [(16, 16, 8, 8), (16, 1, 8, 1)])
def test_gather_fill_matches_wrap(dims):
    nx2, nx3, mb2, mb3 = dims
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        pin = ParameterInput.from_string(
            DECK.format(nx2=nx2, nx3=nx3, mb2=mb2, mb3=mb3))
        mesh, phys, pgen, driver, state = build(pin)
        assert mesh.nmb_total > 1
        ms = mesh.mesh_indcs
        active = (ms.nx3 > 1, ms.nx2 > 1, True)
        ng = mesh.mb_indcs.ng
        rng = np.random.default_rng(7)

        # cell-centred: interiors from the global field, ghosts garbage
        glob = rng.normal(size=(phys.nvar, ms.nx3, ms.nx2, ms.nx1))
        ref = _blocks(glob, mesh, active).astype(np.float32)
        inp = rng.normal(size=ref.shape).astype(np.float32)
        act = tuple(slice(ng, -ng) if a else slice(None) for a in active)
        inp[(slice(None), slice(None)) + act] = \
            ref[(slice(None), slice(None)) + act]
        got = np.asarray(jax.jit(phys.bvals.fill_ghosts)(inp))
        np.testing.assert_array_equal(got, ref)

        # face-centred: both shared faces of a block are interior
        ref_b, inp_b = {}, {}
        for a, c in ((2, "x1f"), (1, "x2f"), (0, "x3f")):
            n = [ms.nx3, ms.nx2, ms.nx1]
            if not active[a]:
                n[a] += 1       # a flat axis keeps its two faces
            g = rng.normal(size=n)
            r = _blocks(g, mesh, active, face_axis=a).astype(np.float32)
            assert r.shape == state["bfc"][c].shape, (c, r.shape)
            i = rng.normal(size=r.shape).astype(np.float32)
            # on the face axis [ng, -ng) spans the nx + 1 interior faces
            i[(slice(None),) + act] = r[(slice(None),) + act]
            ref_b[c], inp_b[c] = r, i
        got_b = jax.jit(phys.fill_ghosts_fc)(inp_b)
        for c in ref_b:
            np.testing.assert_array_equal(np.asarray(got_b[c]), ref_b[c],
                                          err_msg=c)
    finally:
        jax.config.update("jax_enable_x64", old)
