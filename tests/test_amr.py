"""Adaptive mesh refinement regressions.

Covers the reference's AMR behavior (reference:
src/mesh/mesh_refinement.cpp, tst/inputs/divb_amr_2d.athinput,
tst/test_suite/sr/test_sr_lwave2d_amr_mpicpu.py): tree-update semantics
(2:1 ripple, family coarsening), exact conservation through
refine/derefine events, div-B preservation with CT on an adaptive mesh,
and linear-wave convergence on an AMR mesh.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from athenak_jax.amr import update_tree
from athenak_jax.athinput import ParameterInput
from athenak_jax.main import run

WRAPS = {"x1": True, "x2": True, "x3": True}


# ---------------------------------------------------------------------------
# tree-update unit tests (host logic)
# ---------------------------------------------------------------------------
def _flat(n1, n2):
    return [(l1, l2, 0, 0) for l2 in range(n2) for l1 in range(n1)]


def test_update_tree_refine_single():
    leaves = _flat(4, 4)
    flags = np.zeros(16, dtype=np.int32)
    flags[leaves.index((1, 1, 0, 0))] = 1
    new, prov = update_tree(leaves, flags, (4, 4, 1),
                            (True, True, False), WRAPS, 2)
    assert len(new) == 16 + 3          # one leaf -> 4 children
    kinds = [p[0] for p in prov]
    assert kinds.count("refined") == 4
    assert kinds.count("same") == 15
    # children cover the parent's quadrants at level 1
    ref = [(l, p) for (l, p) in zip(new, prov) if p[0] == "refined"]
    locs = sorted((l1, l2) for ((l1, l2, _, lev), _) in ref)
    assert locs == [(2, 2), (2, 3), (3, 2), (3, 3)]


def test_update_tree_two_one_ripple():
    """Refining a level-1 leaf must drag coarse neighbors to level 1."""
    # start: one level-1 family in the corner, rest level 0
    leaves = _flat(4, 4)
    flags = np.zeros(16, dtype=np.int32)
    flags[0] = 1
    lv1, prov = update_tree(leaves, flags, (4, 4, 1),
                            (True, True, False), WRAPS, 3)
    # now refine one of the new fine leaves; its coarse neighbors must split
    flags2 = np.zeros(len(lv1), dtype=np.int32)
    fine_gid = next(i for i, (l1, l2, l3, lev) in enumerate(lv1)
                    if lev == 1 and (l1, l2) == (1, 1))
    flags2[fine_gid] = 1
    lv2, prov2 = update_tree(lv1, flags2, (4, 4, 1),
                             (True, True, False), WRAPS, 3)
    levs = {}
    for (l1, l2, l3, lev) in lv2:
        levs.setdefault(lev, 0)
        levs[lev] += 1
    # the level-2 children exist
    assert levs.get(2, 0) == 4
    # ... and the whole tree remains 2:1 balanced: the ml-table builder
    # raises on any face with a missing fine donor family
    from athenak_jax.refinement import build_ml_tables
    build_ml_tables(lv2, (4, 4, 1), (True, True, False), WRAPS)


def test_update_tree_derefine_family():
    leaves = _flat(2, 2)
    flags = np.ones(4, dtype=np.int32)
    lv1, _ = update_tree(leaves, flags, (2, 2, 1),
                         (True, True, False), WRAPS, 2)
    assert len(lv1) == 16
    flags2 = -np.ones(len(lv1), dtype=np.int32)
    lv2, prov2 = update_tree(lv1, flags2, (2, 2, 1),
                             (True, True, False), WRAPS, 2)
    assert len(lv2) == 4
    assert all(p[0] == "derefined" and len(p[1]) == 4 for p in prov2)


def test_update_tree_noop():
    leaves = _flat(2, 2)
    flags = np.zeros(4, dtype=np.int32)
    new, prov = update_tree(leaves, flags, (2, 2, 1),
                            (True, True, False), WRAPS, 2)
    assert new is None and prov is None


# ---------------------------------------------------------------------------
# end-to-end: hydro advection with conservation through AMR events
# ---------------------------------------------------------------------------
HYDRO_DECK = """
<job>
basename = AMRBlob

<mesh>
nghost = 2
nx1 = 32
x1min = -0.5
x1max = 0.5
nx2 = 32
x2min = -0.5
x2max = 0.5
nx3 = 1
x3min = -0.5
x3max = 0.5

<meshblock>
nx1 = 8
nx2 = 8
nx3 = 1

<mesh_refinement>
refinement = adaptive
num_levels = 3
ncycle_check = 2
refinement_interval = 2

<amr_criterion1>
method = min_max
variable = hydro_u_d
value_max = 1.5

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
nlim = 40
tlim = 0.5

<hydro>
eos = ideal
reconstruct = plm
rsolver = hllc
gamma = 1.6666666666666667

<problem>
pgen_name = blast
prat = 10.0
drat = 4.0
inner_radius = 0.02
outer_radius = 0.12
pi_amb = 1.0
di_amb = 1.0
"""


def _totals(mesh, state, nvar=5):
    """Volume-weighted conserved sums (mass, momenta, energy)."""
    mbi = mesh.mb_indcs
    u = np.asarray(state["u"], dtype=np.float64)
    sl = (slice(None), slice(0, nvar), slice(mbi.ks, mbi.ke + 1),
          slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    vol = (np.asarray(mesh.mb_size["dx1"]) * np.asarray(mesh.mb_size["dx2"])
           * np.asarray(mesh.mb_size["dx3"]))
    return (u[sl].sum(axis=(2, 3, 4)) * vol[:, None]).sum(axis=0)


def test_amr_hydro_blast_conserves(tmp_path):
    pin = ParameterInput.from_string(HYDRO_DECK)
    pin.modify_from_cmdline([f"job/basename={tmp_path}/AMRBlob"])
    mesh, phys, driver, state = run(pin)
    assert driver.pamr is not None
    # the blast must actually have triggered refinement
    assert driver.pamr.nmb_created > 0
    assert int(mesh.mb_lev.max()) >= 1
    # mass/energy conserved through all refine/derefine events (periodic
    # box; restriction is exact cell averaging, prolongation is mean-
    # preserving min-mod -> conservation to round-off)
    tot = _totals(mesh, state)
    # initial totals from a fresh 0-cycle build of the same deck
    pin2 = ParameterInput.from_string(HYDRO_DECK)
    pin2.modify_from_cmdline([f"job/basename={tmp_path}/AMRBlob0",
                              "time/nlim=0"])
    mesh0, _, _, state0 = run(pin2)
    tot0 = _totals(mesh0, state0)
    assert np.allclose(tot[0], tot0[0], rtol=1e-12, atol=1e-13), \
        f"mass drift {tot[0] - tot0[0]:g}"
    assert np.allclose(tot[4], tot0[4], rtol=1e-12, atol=1e-12), \
        f"energy drift {tot[4] - tot0[4]:g}"


# ---------------------------------------------------------------------------
# MHD: div-B at round-off through AMR events (reference: divb_amr deck)
# ---------------------------------------------------------------------------
MHD_DECK = """
<job>
basename = AMRDivB

<mesh>
nghost = 2
nx1 = 32
x1min = -0.5
x1max = 0.5
nx2 = 32
x2min = -0.5
x2max = 0.5
nx3 = 1
x3min = -0.5
x3max = 0.5

<meshblock>
nx1 = 8
nx2 = 8
nx3 = 1

<mesh_refinement>
refinement = adaptive
num_levels = 3
ncycle_check = 2
refinement_interval = 2

<amr_criterion1>
method = min_max
variable = mhd_u_d
value_max = 1.5

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
nlim = 30
tlim = 0.5

<mhd>
eos = ideal
reconstruct = plm
rsolver = hlld
gamma = 1.6666666666666667

<problem>
pgen_name = blast
prat = 10.0
drat = 4.0
inner_radius = 0.02
outer_radius = 0.12
pi_amb = 1.0
di_amb = 1.0
b_amb = 0.7071067811865476
"""


def _max_divb(mesh, state):
    mbi = mesh.mb_indcs
    bfc = state["bfc"]
    x1f = np.asarray(bfc["x1f"], dtype=np.float64)
    x2f = np.asarray(bfc["x2f"], dtype=np.float64)
    dx1 = np.asarray(mesh.mb_size["dx1"]).reshape(-1, 1, 1, 1)
    dx2 = np.asarray(mesh.mb_size["dx2"]).reshape(-1, 1, 1, 1)
    div = ((x1f[..., 1:] - x1f[..., :-1]) / dx1
           + (x2f[..., 1:, :] - x2f[..., :-1, :]) / dx2)
    a = (slice(None), slice(mbi.ks, mbi.ke + 1),
         slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    return np.abs(div[a]).max()


def test_amr_mhd_divb(tmp_path):
    pin = ParameterInput.from_string(MHD_DECK)
    pin.modify_from_cmdline([f"job/basename={tmp_path}/AMRDivB"])
    mesh, phys, driver, state = run(pin)
    assert driver.pamr.nmb_created > 0
    assert _max_divb(mesh, state) < 2e-11


def test_amr_mhd_divb_3d(tmp_path):
    pin = ParameterInput.from_string(MHD_DECK)
    pin.modify_from_cmdline([
        f"job/basename={tmp_path}/AMRDivB3",
        "mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16",
        "meshblock/nx1=8", "meshblock/nx2=8", "meshblock/nx3=8",
        "mesh_refinement/num_levels=2",
        "time/nlim=12",
        # rebuild-per-epoch path (the fixed-capacity pool is exercised
        # by the 2-D AMR tests; tracing every 3-D mixed-level branch at
        # pool capacity makes this test ~4x slower on the CPU backend)
        "mesh_refinement/block_pool=false",
    ])
    mesh, phys, driver, state = run(pin)
    assert driver.pamr.nmb_created > 0
    mbi = mesh.mb_indcs
    bfc = state["bfc"]
    x1f = np.asarray(bfc["x1f"], dtype=np.float64)
    x2f = np.asarray(bfc["x2f"], dtype=np.float64)
    x3f = np.asarray(bfc["x3f"], dtype=np.float64)
    dx1 = np.asarray(mesh.mb_size["dx1"]).reshape(-1, 1, 1, 1)
    dx2 = np.asarray(mesh.mb_size["dx2"]).reshape(-1, 1, 1, 1)
    dx3 = np.asarray(mesh.mb_size["dx3"]).reshape(-1, 1, 1, 1)
    div = ((x1f[..., 1:] - x1f[..., :-1]) / dx1
           + (x2f[..., 1:, :] - x2f[..., :-1, :]) / dx2
           + (x3f[..., 1:, :, :] - x3f[..., :-1, :, :]) / dx3)
    a = (slice(None), slice(mbi.ks, mbi.ke + 1),
         slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    assert np.abs(div[a]).max() < 2e-11


# ---------------------------------------------------------------------------
# 2D linear-wave convergence on an AMR mesh (reference:
# tst/test_suite/sr/test_sr_lwave2d_amr_mpicpu.py pattern, Newtonian)
# ---------------------------------------------------------------------------
LWAVE_DECK = """
<job>
basename = AMRLinWave

<mesh>
nghost = 2
nx1 = 64
x1min = 0.0
x1max = 2.0
nx2 = 32
x2min = 0.0
x2max = 1.0
nx3 = 1
x3min = 0.0
x3max = 1.0

<meshblock>
nx1 = 8
nx2 = 8
nx3 = 1

<mesh_refinement>
refinement = adaptive
num_levels = 2
ncycle_check = 4
refinement_interval = 4

<amr_criterion1>
method = min_max
variable = hydro_u_d
value_max = 1.0000004

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.4
nlim = -1
tlim = 1.0

<hydro>
eos = ideal
reconstruct = plm
rsolver = hlle
gamma = 1.6666666666666667

<problem>
pgen_name = linear_wave
wave_flag = 0
amp = 1.0e-6
dens = 1.0
pgas = 0.6
vx0 = 0.0
"""


def _run_lwave_amr(tmp_path, res, tag):
    pin = ParameterInput.from_string(LWAVE_DECK)
    pin.modify_from_cmdline([
        f"job/basename={tmp_path}/AMRLinWave{tag}",
        f"mesh/nx1={res}", f"mesh/nx2={res // 2}",
        f"meshblock/nx1={res // 8}", f"meshblock/nx2={res // 8}",
    ])
    mesh, phys, driver, state = run(pin)
    fname = pin.get_string("job", "basename") + "-errs.dat"
    data = np.loadtxt(fname)
    return float(np.atleast_2d(data)[-1][4]), driver


def test_amr_lwave2d_convergence(tmp_path):
    e32, drv32 = _run_lwave_amr(tmp_path, 32, "a")
    e64, drv64 = _run_lwave_amr(tmp_path, 64, "b")
    # refinement must trigger (the wave crest crosses value_max)
    assert drv64.pamr.nmb_created > 0
    # thresholds mirror the reference's 2D AMR linear-wave gate
    # (error level set by the coarse region; ratio < 0.45 = converging)
    assert e64 < 1.2e-7, f"64-zone AMR error {e64:g}"
    assert e64 / e32 < 0.45, f"AMR convergence ratio {e64 / e32:g}"


# ---------------------------------------------------------------------------
# AMR-aware restart: the evolved tree is checkpointed and rebuilt
# (reference: restart.cpp:207-310 lloc lists + BuildTreeFromRestart)
# ---------------------------------------------------------------------------
def test_amr_restart_bit_exact_continuation(tmp_path):
    from athenak_jax.main import run_restart

    # uninterrupted run to nlim=40 (tree refines along the way)
    pin1 = ParameterInput.from_string(HYDRO_DECK)
    pin1.modify_from_cmdline([f"job/basename={tmp_path}/full"])
    mesh1, phys1, drv1, st1 = run(pin1)
    assert drv1.pamr.nmb_created > 0

    # interrupted at nlim=20 with a restart dump, then resumed
    deck2 = HYDRO_DECK + """
<output1>
file_type = rst
dcycle = 20
"""
    pin2 = ParameterInput.from_string(deck2)
    pin2.modify_from_cmdline([f"job/basename={tmp_path}/half",
                              "time/nlim=20"])
    mesh2a, _, drv2a, _ = run(pin2)
    assert int(mesh2a.mb_lev.max()) >= 1, "tree must be refined by nlim=20"
    import glob
    rst = sorted(glob.glob(f"{tmp_path}/half.*.rst"))[-1]
    mesh2, phys2, drv2, st2 = run_restart(rst, overrides=["time/nlim=40"])

    # the evolved tree was restored, not the deck's flat root tree
    assert mesh2.nmb_total == mesh1.nmb_total
    assert list(map(tuple, mesh2.leaves)) == list(map(tuple, mesh1.leaves))
    assert np.isclose(mesh1.time, mesh2.time, rtol=1e-14)
    np.testing.assert_allclose(np.asarray(st2["u"]), np.asarray(st1["u"]),
                               rtol=1e-13, atol=1e-15)
