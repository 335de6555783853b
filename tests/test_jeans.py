"""Jeans wave growth-rate/frequency validation vs the analytic dispersion
relation omega^2 = k^2 cs^2 (1 - n_jeans^2) — mirrors the reference
regression (reference: tst/test_suite/multigrid/test_mg_jeans3d_cpu.py,
max_rel_error 0.01 stable / 0.03 unstable with convergence ratio 0.3;
deck inputs/tests/jeans_wave.athinput)."""

import math

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import run
from athenak_jax.pgen import jeans_wave

DECK = """
<job>
basename = JeansWave

<mesh>
nghost = 2
nx1 = 32
x1min = 0.0
x1max = 1.0
ix1_bc = periodic
ox1_bc = periodic
nx2 = 16
x2min = 0.0
x2max = 0.5
ix2_bc = periodic
ox2_bc = periodic
nx3 = 16
x3min = 0.0
x3max = 0.5
ix3_bc = periodic
ox3_bc = periodic

<meshblock>
nx1 = 8
nx2 = 8
nx3 = 8

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
nlim = -1
tlim = 0.1
ndiag = 100000

<hydro>
eos = isothermal
reconstruct = plm
rsolver = hlle
iso_sound_speed = 1.0

<gravity>
four_pi_G = 1.0

<hydro_srcterms>
self_gravity = true

<problem>
pgen_name = gravity
amp = 1.0e-6
n_jeans = 0.5
"""


def _measure(tmp_path, res, n_jeans):
    pin = ParameterInput.from_string(DECK)
    pin.modify_from_cmdline([
        f"job/basename={tmp_path}/jeans_{res}_{n_jeans}",
        f"mesh/nx1={res}", f"mesh/nx2={res // 2}", f"mesh/nx3={res // 2}",
        f"problem/n_jeans={n_jeans}",
    ])
    mesh, phys, driver, state = run(pin)
    out = jeans_wave.final(pin, mesh, phys, state)
    return abs(out["omega_measured"] - out["omega"]) / out["omega"]


def test_jeans_stable_convergence(tmp_path):
    """n_jeans = 0.5: oscillation frequency converges to analytic
    (reference res_list [32, 64])."""
    e_lo = _measure(tmp_path, 32, 0.5)
    e_hi = _measure(tmp_path, 64, 0.5)
    assert e_hi < 0.01, f"stable omega error {e_hi:g} exceeds 0.01"
    assert e_hi / e_lo < 0.35, \
        f"stable convergence ratio {e_hi / e_lo:g} exceeds 0.35"


def test_jeans_unstable_convergence(tmp_path):
    """n_jeans = 2.0: growth rate converges to analytic."""
    e_lo = _measure(tmp_path, 16, 2.0)
    e_hi = _measure(tmp_path, 32, 2.0)
    assert e_hi < 0.03, f"unstable omega error {e_hi:g} exceeds 0.03"
    assert e_hi / e_lo < 0.35, \
        f"unstable convergence ratio {e_hi / e_lo:g} exceeds 0.35"


def test_jeans_multigrid_solver(tmp_path):
    """The multigrid solver path reproduces the stable-wave frequency
    (reference: test_mg_jeans3d_cpu.py 'mgi' mode, gravity/niteration=4)."""
    pin = ParameterInput.from_string(DECK)
    pin.modify_from_cmdline([
        f"job/basename={tmp_path}/jeans_mg",
        "mesh/nx1=32", "mesh/nx2=16", "mesh/nx3=16",
        "problem/n_jeans=0.5",
        "gravity/solver=multigrid",
        "gravity/threshold=-1",
        "gravity/niteration=4",
        "gravity/npresmooth=2",
        "gravity/npostsmooth=2",
        "gravity/full_multigrid=true",
    ])
    mesh, phys, driver, state = run(pin)
    out = jeans_wave.final(pin, mesh, phys, state)
    rel = abs(out["omega_measured"] - out["omega"]) / out["omega"]
    assert rel < 0.03, f"MG jeans omega error {rel:g} exceeds 0.03"
