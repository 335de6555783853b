"""Cost-weighted load balancing (reference: src/mesh/load_balance.cpp:38-90)
and the weighted shard layout it drives (parallel/shard_comm.ShardLayout):
the device assignment must stay contiguous in Z-order, every rank must get
a block, and a weighted-layout shard cycle must bit-match one device.
"""

import jax
import jax.numpy as jnp
import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build
from athenak_jax.mesh import load_balance
from athenak_jax.parallel import make_device_mesh
from athenak_jax.parallel.shard_comm import shard_layout, unpad_state

# by module name (pytest puts tests/ on sys.path): an installed package
# named ``tests`` would shadow ``tests.test_shard_comm``
from test_shard_comm import DECK


def _check(cost, nranks):
    rank, gids, nmb = load_balance(np.asarray(cost, float), nranks)
    assert (np.diff(rank) >= 0).all(), "assignment must be contiguous"
    assert (nmb > 0).all(), "every rank must own a block"
    assert nmb.sum() == len(cost)
    np.testing.assert_array_equal(gids, np.concatenate(
        [[0], np.cumsum(nmb)[:-1]]))
    return rank, nmb


def test_uniform_costs_split_evenly():
    _, nmb = _check(np.ones(16), 8)
    np.testing.assert_array_equal(nmb, 2)
    # non-divisible: master rank(s) get the lighter share
    _, nmb = _check(np.ones(6), 4)
    assert nmb.tolist() == [1, 1, 2, 2]


def test_weighted_costs_balance_cost_not_count():
    cost = np.array([1, 1, 1, 1, 4, 4, 4, 4, 1, 1, 1, 1], float)
    rank, nmb = _check(cost, 4)
    per_rank = np.asarray([cost[rank == k].sum() for k in range(4)])
    # every rank within 2x of the ideal share (ideal = 6)
    assert per_rank.max() <= 2.0 * cost.sum() / 4
    # count-balanced split would be 3/3/3/3 = costs [3,9,9,3]; the
    # weighted split must beat its max cost
    assert per_rank.max() < 9.0


def test_extreme_skew_never_strands_a_rank():
    rank, nmb = _check(np.array([100, 1, 1, 1, 1, 1, 1, 1], float), 4)
    assert nmb[0] == 1  # the heavy block is alone on rank 0


def test_weighted_shard_cycle_bit_matches(tmp_path):
    """Non-uniform costs produce a non-identity pool layout; the shard
    cycle through that layout must still bit-match single-device."""
    assert len(jax.devices()) >= 4

    def _run(dmesh, cost=None, ncyc=3):
        pin = ParameterInput.from_string(DECK)
        pin.set_value("mesh", "coalesce", "false")
        mesh, phys, pgen, driver, state = build(pin)
        if cost is not None:
            mesh.cost_eachmb = np.asarray(cost, np.float32)
        driver.dmesh = dmesh
        state = driver.initialize(state)
        if dmesh is not None:
            fn = jax.jit(driver.make_shard_cycle_fn(state))
        else:
            fn = jax.jit(driver.make_cycle_fn())
        dt = jnp.asarray(driver.mesh.dt, dtype=state["u"].dtype)
        for _ in range(ncyc):
            state, dtnew, _ = fn(state, dt)
        return driver, jax.tree_util.tree_map(np.asarray, state), \
            float(dtnew)

    _, ref, rdt = _run(None)
    # 16 blocks: make the first four 5x heavier -> uneven block counts
    cost = np.ones(16)
    cost[:4] = 5.0
    d, sh, sdt = _run(make_device_mesh(4), cost=cost)
    lay = shard_layout(d.mesh, 4)
    assert not lay.identity
    assert lay.nmb_eachrank.min() < lay.nmb_eachrank.max()
    assert 0.0 < lay.lb_efficiency <= 1.0
    sh = unpad_state(sh, lay)
    assert np.isclose(rdt, sdt, rtol=1e-12)
    for k in ("u", "w"):
        np.testing.assert_array_equal(sh[k], ref[k])
    for c in ("x1f", "x2f", "x3f"):
        np.testing.assert_array_equal(sh["bfc"][c], ref["bfc"][c])
    # driver telemetry includes the lb-efficiency line
    d.wall_seconds = 1.0
    d.zcps = 0.0
    rep = d.finalize_report()
    assert "load balancing efficiency" in rep
