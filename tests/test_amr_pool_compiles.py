"""AMR block pool compile stability (VERDICT item 4 'done' bar: an
adaptive run triggers at most the capacity-ladder recompiles after
warmup — tree updates alone must NOT retrace the cycle).

The pool turns every tree-dependent table into a traced input of one
jitted cycle (amr_pool.py), so the jit cache of the pooled cycle holds
one entry per *capacity*, not per tree.
"""

import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build

DECK = """
<job>
basename = poolc

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
nlim = 20
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
b_amb = 0.7071067811865476
"""


def test_pool_cycle_compiles_bounded():
    pin = ParameterInput.from_string(DECK)
    mesh, phys, pgen, driver, state = build(pin)
    assert driver.pamr is not None and driver.pamr.use_pool
    state = driver.initialize(state)
    state = driver.execute(state)

    pamr = driver.pamr
    # the tree must actually have evolved several times
    assert pamr.nmb_created >= 16, pamr.nmb_created
    ntrees = pamr.nmb_created  # lower bound on tree-update count proxy

    # one compiled cycle per capacity-ladder rung, NOT per tree update
    ncomp = pamr._pool_cycle._cache_size()
    assert ncomp <= 3, f"pooled cycle retraced {ncomp} times"
    nremap = pamr._pool_remap._cache_size()
    assert nremap <= 3, f"pooled remap retraced {nremap} times"
    if pamr._pool_dt is not None:
        assert pamr._pool_dt._cache_size() <= 3

    # and the run stayed physical
    u = np.asarray(driver._unpadded(state)["u"])
    assert np.isfinite(u).all()
    assert u[:, 0].min() > 0.0


def test_pool_cycle_multidevice_bounded():
    """8 virtual devices: the pooled adaptive run crosses >= 2 tree
    updates with a bounded compile count and matches the single-device
    pool run (VERDICT r4 item 4; the reference analogue rebuilds only
    comm metadata on amr_lb_seq_ changes, mesh.hpp:176-184)."""
    import jax

    from athenak_jax.parallel import make_device_mesh

    assert len(jax.devices()) >= 8

    # single-device reference
    pin = ParameterInput.from_string(DECK)
    mesh, phys, pgen, driver, state = build(pin)
    state = driver.initialize(state)
    state = driver.execute(state)
    ref = np.asarray(driver._unpadded(state)["u"])
    ref_trees = driver.pamr.nmb_created

    pin = ParameterInput.from_string(DECK)
    mesh, phys, pgen, driver, state = build(pin)
    assert driver.pamr is not None and driver.pamr.use_pool
    driver.dmesh = make_device_mesh(8)
    state = driver.initialize(state)
    assert driver.pamr.use_pool, "pool must stay enabled on a device mesh"
    assert driver.pamr.capacity % 8 == 0
    state = driver.execute(state)

    pamr = driver.pamr
    assert pamr.nmb_created >= 8, pamr.nmb_created  # >= 2 tree updates
    ncomp = pamr._pool_cycle._cache_size()
    assert ncomp <= 3, f"pooled cycle retraced {ncomp} times"
    assert pamr._pool_remap._cache_size() <= 3

    out = np.asarray(driver._unpadded(state)["u"])
    assert np.isfinite(out).all()
    assert out[:, 0].min() > 0.0
    # same tree evolution and same answer as one device (XLA partitions
    # the identical program; reductions may reassociate)
    assert pamr.nmb_created == ref_trees
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=5e-12, atol=1e-15)
