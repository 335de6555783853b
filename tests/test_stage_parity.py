"""The plain MHD stage in f32 against the same stage in f64.

The f32 path is what the benchmark and the GPU smoke run; these cases
hold it to the f64 reference on the CPU after two full cycles, so a
precision-sensitive change to the stage cannot silently change the
physics.  Cases: Newtonian PLM + HLLD, SR PLM + HLLE, and the 8-block
mesh (coalescing and pencil packing off, so the block halo exchange
runs) against the single-block f64 run.
"""

import jax
import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build

DECK = """
<job>
basename = stage_parity

<mesh>
nghost = 2
nx1 = 28
x1min = -0.5
x1max = 0.5
ix1_bc = periodic
ox1_bc = periodic
nx2 = 28
x2min = -0.5
x2max = 0.5
ix2_bc = periodic
ox2_bc = periodic
nx3 = 28
x3min = -0.5
x3max = 0.5
ix3_bc = periodic
ox3_bc = periodic

<meshblock>
nx1 = 28
nx2 = 28
nx3 = 28

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 1.0
nlim = 2
ndiag = 10000

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

# SR MHD: the SR HLLE solver (reference solver set per regime:
# src/mhd/mhd_fluxes.cpp:39-70) and the Lorentz-factor transport
# velocity in the CT corner EMFs (mhd_corner_e.cpp:136-143)
SR_DECK = (DECK
           .replace("rsolver = hlld", "rsolver = hlle")
           .replace("<mhd>", "<coord>\nspecial_rel = true\n\n<mhd>")
           .replace("gamma = 1.6666666666666667",
                    "gamma = 1.3333333333333333")
           # mild overpressure: the 28^3 box has no FOFC, so keep the SR
           # c2p comfortably inside its convergence basin
           .replace("prat = 100.0", "prat = 5.0")
           .replace("cfl_number = 0.3", "cfl_number = 0.25"))

# 8 blocks of 14^3 over the same domain
BLOCKS8 = ["meshblock/nx1=14", "meshblock/nx2=14", "meshblock/nx3=14",
           "mesh/coalesce=false", "mesh/pencil_pack=false"]

# L1 relative error per variable: f32 rounding (6e-8) accumulated over
# two RK2 cycles of the blast, whose shell steepens it locally.
TOL_L1 = 1e-5


def _run(deck, x64, overrides=()):
    """Two cycles through Driver.execute; host copy of the final state
    and the driver (the state is in the gid block layout)."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", x64)
    try:
        pin = ParameterInput.from_string(deck)
        pin.modify_from_cmdline(
            list(overrides)
            + [f"job/precision={'double' if x64 else 'single'}"])
        mesh, phys, pgen, driver, state = build(pin)
        state = driver.execute(driver.initialize(state))
        host = jax.tree_util.tree_map(np.asarray, state)
    finally:
        jax.config.update("jax_enable_x64", old)
    return driver, host


def _global(arr, mesh, face_axis=None):
    """Stitch the active cells (and, for face arrays, faces) of every
    block of a [nmb, ..., n3, n2, n1] array into one global array."""
    mbi = mesh.mb_indcs
    ng = mbi.ng
    nx = (mbi.nx3, mbi.nx2, mbi.nx1)
    lead = arr.shape[1:-3]
    shape = lead + tuple(
        n * nb + (1 if face_axis == a else 0)
        for a, (n, nb) in enumerate(zip(
            nx, (mesh.nmb_x3, mesh.nmb_x2, mesh.nmb_x1))))
    out = np.zeros(shape, np.float64)
    for gid in range(mesh.nmb_total):
        l1, l2, l3 = mesh.lloc_eachmb[gid][:3]
        lo = (l3 * nx[0], l2 * nx[1], l1 * nx[2])
        src, dst = [], []
        for a in range(3):
            ext = nx[a] + (1 if face_axis == a else 0)
            src.append(slice(ng, ng + ext))
            dst.append(slice(lo[a], lo[a] + ext))
        out[(Ellipsis,) + tuple(dst)] = arr[(gid, Ellipsis) + tuple(src)]
    return out


def _l1(got, ref):
    return np.abs(got - ref).sum() / np.abs(ref).sum()


@pytest.mark.parametrize("case", ["newtonian_hlld", "sr_hlle", "blocks8"])
def test_plain_stage_f32_matches_f64(case):
    deck = SR_DECK if case == "sr_hlle" else DECK
    ovr = BLOCKS8 if case == "blocks8" else ()
    drv32, s32 = _run(deck, False, ovr)
    drv64, s64 = _run(deck, True)
    assert s32["u"].dtype == np.float32 and s64["u"].dtype == np.float64
    assert drv32.mesh.ncycle == drv64.mesh.ncycle == 2
    if case == "blocks8":
        assert drv32.mesh.nmb_total == 8 and s32["u"].shape[0] == 8
    assert np.isfinite(s32["u"]).all()
    u32, u64 = _global(s32["u"], drv32.mesh), _global(s64["u"], drv64.mesh)
    for v in range(u64.shape[0]):
        assert _l1(u32[v], u64[v]) < TOL_L1, f"u[{v}]"
    # B components share one scale: a component that starts at zero is
    # measured against the field as a whole
    bsum = sum(np.abs(_global(s64["bfc"][c], drv64.mesh, a)).sum()
               for a, c in ((2, "x1f"), (1, "x2f"), (0, "x3f")))
    for a, c in ((2, "x1f"), (1, "x2f"), (0, "x3f")):
        d = np.abs(_global(s32["bfc"][c], drv32.mesh, a)
                   - _global(s64["bfc"][c], drv64.mesh, a)).sum()
        assert d / bsum < TOL_L1, f"bfc[{c}]"
    assert np.isclose(float(drv32.mesh.dt), float(drv64.mesh.dt),
                      rtol=1e-4)
