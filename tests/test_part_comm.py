"""Multi-device particle migration (reference: bvals_part.cpp).

Runs the bucketed ppermute exchange on an 8-device CPU mesh and checks
every particle lands on its destination device with the global multiset
preserved.  Arrays carry 2x headroom (live particles on even slots):
the fixed-capacity exchange needs free slots to make progress (see
part_comm docstring).
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from athenak_jax.parallel import make_device_mesh
from athenak_jax.parallel.part_comm import exchange_particles


def _key(r):
    return tuple(np.round(r, 12))


def _run_exchange(nlive, ndev, seed=0, cap=None, dead_frac=0.0,
                  balanced=False, passes=1):
    rng = np.random.default_rng(seed)
    nslot = 2 * nlive
    x = rng.standard_normal((nslot, 4))
    dest = rng.integers(0, ndev, nslot).astype(np.int32)
    if balanced:
        # exactly nlive/ndev live particles per destination
        dest[0::2] = rng.permutation(
            np.repeat(np.arange(ndev), nlive // ndev)).astype(np.int32)
    alive = np.zeros(nslot, bool)
    alive[0::2] = rng.random(nlive) >= dead_frac
    dmesh = make_device_mesh(ndev)

    def local(xl, dl, al):
        parts, al2, ovf = exchange_particles(
            {"x": xl}, al, dl, ndev, "mb", cap=cap)
        return parts["x"], al2, ovf.reshape((1,))

    fn = jax.shard_map(
        local, mesh=dmesh,
        in_specs=(P("mb"), P("mb"), P("mb")),
        out_specs=(P("mb"), P("mb"), P("mb")))
    dest_of = {_key(r): int(d) for r, d in zip(x, dest)}
    x2, dest2, alive2 = jnp.asarray(x), jnp.asarray(dest), \
        jnp.asarray(alive)
    for _ in range(passes):
        x2, alive2, ovf = fn(x2, dest2, alive2)
        if float(np.asarray(ovf).sum()) == 0:
            break
        # rows moved during the pass keep their payload; rebuild the
        # dest array for the retry from particle identity
        dest2 = jnp.asarray(np.array(
            [dest_of[_key(r)] for r in np.asarray(x2)], dtype=np.int32))
    return (np.asarray(x2), np.asarray(alive2), np.asarray(ovf),
            x, dest, alive)


def test_exchange_routes_to_destination():
    assert len(jax.devices()) >= 8
    nlive, ndev = 64, 8
    x2, alive2, ovf, x, dest, alive = _run_exchange(
        nlive, ndev, balanced=True, passes=6)
    L = len(alive2) // ndev
    assert ovf.sum() == 0
    got = {d: sorted(_key(r)
                     for r in x2[d * L:(d + 1) * L][
                         alive2[d * L:(d + 1) * L]])
           for d in range(ndev)}
    want = {d: sorted(_key(x[i]) for i in range(len(x))
                      if alive[i] and dest[i] == d)
            for d in range(ndev)}
    assert got == want
    assert alive2.sum() == alive.sum()


def test_exchange_overflow_keeps_particles():
    """With a tiny per-round capacity the exchange must report overflow
    and keep the unshipped particles alive (nothing lost)."""
    assert len(jax.devices()) >= 8
    x2, alive2, ovf, x, dest, alive = _run_exchange(64, 8, cap=1)
    assert alive2.sum() == alive.sum()   # no particle ever dropped
    assert ovf.sum() > 0                 # capacity pressure reported
    orig = {_key(r) for r in x}
    for r in x2[alive2]:
        assert _key(r) in orig


def test_exchange_respects_dead_slots():
    assert len(jax.devices()) >= 8
    x2, alive2, ovf, x, dest, alive = _run_exchange(
        64, 8, dead_frac=0.3, balanced=True, passes=6)
    assert ovf.sum() == 0
    assert alive2.sum() == alive.sum()
    ndev = 8
    L = len(alive2) // ndev
    for d in range(ndev):
        sl = slice(d * L, (d + 1) * L)
        rows = sorted(_key(r) for r in x2[sl][alive2[sl]])
        want = sorted(_key(x[i]) for i in range(len(x))
                      if alive[i] and dest[i] == d)
        assert rows == want


def test_particles_in_shard_cycle():
    """A blast + drift-particles deck runs the explicit shard cycle with
    the particle axis sharded; grid and particle state bit-match the
    single-device run."""
    import importlib.util
    import sys as _sys
    spec = importlib.util.spec_from_file_location(
        "tsc", "tests/test_shard_comm.py")
    tsc = importlib.util.module_from_spec(spec)
    _sys.modules["tsc"] = tsc
    spec.loader.exec_module(tsc)
    deck = tsc.DECK + """
<particles>
ppc = 0.5
"""
    d1, ref, rdt = tsc._run(deck, None)
    assert d1.phys.ppart is not None
    d2, sh, sdt = tsc._run(deck, make_device_mesh(8))
    assert np.isclose(rdt, sdt, rtol=1e-12)
    nmb = d1.mesh.nmb_total
    np.testing.assert_array_equal(sh["u"][:nmb], ref["u"])
    np.testing.assert_array_equal(sh["prtcl_x"], ref["prtcl_x"])
    np.testing.assert_array_equal(sh["prtcl_v"], ref["prtcl_v"])
