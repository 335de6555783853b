"""Particles: drift trajectories, periodic wrapping, gid migration, trk.

(reference: src/particles/, pgen/particles/part_random.cpp,
inputs/particles/random_drift.athinput)
"""

import os

import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build, run

DECK = """
<job>
basename = parts

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
nx1 = 8
nx2 = 8
nx3 = 8

<time>
evolution = kinematic
integrator = rk2
cfl_number = 0.3
tlim = 0.3

<hydro>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = llf

<particles>
particle_type = cosmic_ray
ppc = 0.01
pusher = drift

<problem>
pgen_name = turb
d0 = 1.0
p0 = 1.0

<output1>
file_type = trk
dt = 0.05
"""


def test_particle_drift(tmp_path):
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        pin = ParameterInput.from_string(DECK)
        mesh, phys, pgen, driver, state = build(pin)
        x0 = np.asarray(state["prtcl_x"]).copy()
        v0 = np.asarray(state["prtcl_v"]).copy()
        assert x0.shape[0] == int(0.01 * 16 ** 3)

        from athenak_jax.outputs import make_outputs
        outs = make_outputs(pin, mesh, phys)
        state = driver.initialize(state)
        state = driver.execute(state, outputs=outs)

        # trajectories: x = x0 + v t (periodic wrap)
        x1 = np.asarray(state["prtcl_x"])
        expect = x0 + v0 * mesh.time
        span = 1.0
        expect = -0.5 + np.mod(expect + 0.5, span)
        np.testing.assert_allclose(x1, expect, rtol=0, atol=1e-12)
        # velocities unchanged for drift
        np.testing.assert_allclose(np.asarray(state["prtcl_v"]), v0)

        # owner gids valid and consistent with positions
        gids = phys.ppart.gids(x1)
        assert gids.min() >= 0 and gids.max() < mesh.nmb_total
        for p in range(min(5, len(gids))):
            g = gids[p]
            assert mesh.mb_size["x1min"][g] <= x1[p, 0] \
                <= mesh.mb_size["x1max"][g]

        # tracked output exists with rows
        trk = np.loadtxt("parts.trk")
        assert trk.shape[0] >= 10
    finally:
        os.chdir(cwd)


SMR_DECK = DECK.replace("<time>", """<mesh_refinement>
refinement = static
num_levels = 2

<refined_region1>
level = 1
x1min = -0.5
x1max = 0.0
x2min = -0.5
x2max = 0.0
x3min = -0.5
x3max = 0.0

<time>""")


def test_particle_drift_smr(tmp_path):
    """Particles compose with SMR: drift trajectories are exact on any
    mesh, and the owner-gid lookup resolves containing LEAF blocks."""
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        pin = ParameterInput.from_string(SMR_DECK)
        mesh, phys, driver, state = run(pin)
    finally:
        os.chdir(cwd)
    assert mesh.multilevel and mesh.mb_lev.max() == 1
    x = np.asarray(state["prtcl_x"])
    assert np.isfinite(x).all()
    assert (x >= -0.5).all() and (x <= 0.5).all()
    # owner lookup lands each particle in its containing leaf block
    gids = phys.ppart.gids(x)
    sz = mesh.mb_size
    for d, (lo, hi) in enumerate((("x1min", "x1max"), ("x2min", "x2max"),
                                  ("x3min", "x3max"))):
        assert (x[:, d] >= sz[lo][gids] - 1e-12).all()
        assert (x[:, d] <= sz[hi][gids] + 1e-12).all()
