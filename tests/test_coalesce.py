"""Block-coalescing parity: a uniform multi-block mesh run as one
superblock must reproduce the block-wise run exactly.

The transform (athenak_jax/parallel/coalesce.py) is the analogue of
the reference's MeshBlockPack batching (reference:
src/mesh/meshblock_pack.hpp:44-97) taken to its limit: co-resident
blocks are physically merged, so the same finite-volume stencils run on
the same global cell values and the results agree to round-off.
"""

import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import run


SOD = """
<job>
basename = Sod

<mesh>
nghost = 2
nx1 = 128
x1min = -0.5
x1max = 0.5
ix1_bc = outflow
ox1_bc = outflow
nx2 = 1
x2min = -0.5
x2max = 0.5
ix2_bc = periodic
ox2_bc = periodic
nx3 = 1
x3min = -0.5
x3max = 0.5
ix3_bc = periodic
ox3_bc = periodic

<meshblock>
nx1 = 32

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.8
nlim = 40
tlim = 0.25
ndiag = 10000

<hydro>
eos = ideal
reconstruct = plm
rsolver = hllc
gamma = 1.4

<problem>
pgen_name = shock_tube
shock_dir = 1
xshock = 0.0
dl = 1.0
pl = 1.0
ul = 0.0
vl = 0.0
wl = 0.0
dr = 0.125
pr = 0.1
ur = 0.0
vr = 0.0
wr = 0.0
"""


BLAST = """
<job>
basename = Blast

<mesh>
nghost = 2
nx1 = 32
x1min = -0.5
x1max = 0.5
ix1_bc = periodic
ox1_bc = periodic
nx2 = 32
x2min = -0.5
x2max = 0.5
ix2_bc = periodic
ox2_bc = periodic
nx3 = 32
x3min = -0.5
x3max = 0.5
ix3_bc = periodic
ox3_bc = periodic

<meshblock>
nx1 = 16
nx2 = 16
nx3 = 16

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
nlim = 10
tlim = 1.0
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
"""


def _run_pair(deck):
    pin_a = ParameterInput.from_string(deck)
    pin_a.set_value("mesh", "coalesce", "true")
    _, _, drv_a, st_a = run(pin_a)

    pin_b = ParameterInput.from_string(deck)
    pin_b.set_value("mesh", "coalesce", "false")
    pin_b.set_value("mesh", "pencil_pack", "false")
    _, _, drv_b, st_b = run(pin_b)

    assert drv_a._coal is not None, "coalescer did not engage"
    assert drv_b._coal is None
    return drv_a, st_a, drv_b, st_b


def test_pencil_blast_bitmatch():
    """x1-pencil lane packing (coalesce=false, pencil_pack on) must
    bit-match the unpacked block pool: the re-blocking is exact."""
    pin_a = ParameterInput.from_string(BLAST)
    pin_a.set_value("mesh", "coalesce", "false")
    _, _, drv_a, st_a = run(pin_a)
    assert drv_a._coal is not None, "pencil packing did not engage"
    assert drv_a._coal.factors == (1, 1, 2)
    assert drv_a._coal.mesh2.nmb_total == 4

    pin_b = ParameterInput.from_string(BLAST)
    pin_b.set_value("mesh", "coalesce", "false")
    pin_b.set_value("mesh", "pencil_pack", "false")
    _, _, drv_b, st_b = run(pin_b)
    assert drv_b._coal is None

    assert drv_a.mesh.ncycle == drv_b.mesh.ncycle
    np.testing.assert_allclose(np.asarray(st_a["u"]),
                               np.asarray(st_b["u"]),
                               rtol=0, atol=1e-12)
    for c in ("b1f", "b2f", "b3f"):
        if c in st_a:
            np.testing.assert_allclose(np.asarray(st_a[c]),
                                       np.asarray(st_b[c]),
                                       rtol=0, atol=1e-12)


def test_coalesce_sod_bitmatch():
    drv_a, st_a, drv_b, st_b = _run_pair(SOD)
    assert drv_a.mesh.ncycle == drv_b.mesh.ncycle
    np.testing.assert_allclose(drv_a.mesh.time, drv_b.mesh.time,
                               rtol=1e-14)
    np.testing.assert_allclose(np.asarray(st_a["u"]),
                               np.asarray(st_b["u"]),
                               rtol=0, atol=1e-13)


def test_coalesce_mhd_blast_bitmatch():
    drv_a, st_a, drv_b, st_b = _run_pair(BLAST)
    assert drv_a.mesh.ncycle == drv_b.mesh.ncycle
    np.testing.assert_allclose(np.asarray(st_a["u"]),
                               np.asarray(st_b["u"]),
                               rtol=0, atol=1e-12)
    for c in ("b1f", "b2f", "b3f"):
        if c in st_a:
            np.testing.assert_allclose(np.asarray(st_a[c]),
                                       np.asarray(st_b[c]),
                                       rtol=0, atol=1e-12)


def test_coalesce_declines_smr():
    """Multilevel meshes must keep the block pool."""
    pin = ParameterInput.from_string(SOD)
    pin.set_value("mesh_refinement", "refinement", "static")
    pin.set_value("refined_region1", "level", "1")
    pin.set_value("refined_region1", "x1min", "-0.25")
    pin.set_value("refined_region1", "x1max", "0.25")
    pin.set_value("refined_region1", "x2min", "-0.5")
    pin.set_value("refined_region1", "x2max", "0.5")
    pin.set_value("refined_region1", "x3min", "-0.5")
    pin.set_value("refined_region1", "x3max", "0.5")
    pin.set_value("time", "nlim", "5")
    _, _, drv, _ = run(pin)
    assert drv._coal is None
