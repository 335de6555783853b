"""Multi-device particle migration: bucketed ppermute exchange.

Parity target: the reference's particle communication
(reference: src/particles/bvals_part.cpp — per-particle destination
GID/rank, counts exchanged ahead of variable-size MPI sends).

Design: particle arrays are sharded over devices along the
particle axis.  Destinations are computed in-trace from positions
(``gids_jnp`` + the layout's gid->device table); the exchange runs
inside shard_map as ``ndev-1`` rounds of fixed-capacity packed
``lax.ppermute`` buffers (static shapes — XLA requires them), with an
``alive`` slot mask instead of variable-length messages.  Overflowing a
round's capacity is counted and reported (the event-counter pattern the
driver already uses for c2p/FOFC fallbacks) rather than silently
dropped.

The drift pusher itself needs no in-cycle migration (particles never
read grid data, reference: particles_pushers.cpp:19-59), so the shard
cycle pushes particle shards elementwise; this exchange is the
primitive grid-coupled pushers (boris, ...) will call between the two
half-drifts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def gids_jnp(ppart, x):
    """Traced owner-gid lookup (device analogue of Particles.gids)."""
    xmin = jnp.asarray(ppart._xmin)
    width = jnp.asarray(ppart._mb_width)
    nxyz = jnp.asarray(ppart._nmb_xyz)
    loc = jnp.clip(jnp.floor((x - xmin) / width).astype(jnp.int32),
                   0, nxyz - 1)
    lut = jnp.asarray(ppart._gid_lut)
    return lut[loc[:, 2], loc[:, 1], loc[:, 0]]


def exchange_particles(parts, alive, dest_dev, ndev: int, axis: str,
                       cap: int | None = None):
    """Migrate particle rows to their destination devices.

    parts    : dict of local [L, ...] arrays (positions, velocities, ...)
    alive    : [L] bool — which local slots hold real particles
    dest_dev : [L] int32 — destination device of each slot (ignored for
               dead slots)
    cap      : per-round packed-buffer capacity (default L)

    Returns (parts, alive, overflow): rows destined elsewhere are packed
    (up to ``cap`` per round), shipped with lax.ppermute, and merged
    into free slots; ``overflow`` counts particles that could not be
    shipped (buffer or receiver-quota exhaustion) and remain local+alive
    so nothing is lost — a later exchange pass retries them.

    Progress requires slack: a device with zero free slots advertises a
    zero quota and receives nothing, so callers must allocate headroom
    (the sharded-particle path pads each device's slot range; the
    reference analogously grows its particle arrays before the receive,
    bvals_part.cpp).  With per-device load <= L - slack the exchange
    converges in a few passes.
    """
    L = alive.shape[0]
    cap = int(cap or L)
    d = lax.axis_index(axis)
    overflow = jnp.zeros((), jnp.int32)

    for r in range(1, ndev):
        peer = (d + r) % ndev
        fwd = [(s, (s + r) % ndev) for s in range(ndev)]
        rev = [(s, (s - r) % ndev) for s in range(ndev)]

        # the receiver (d+r) advertises its free-slot count so the
        # sender never ships a row that cannot be placed (the
        # analogue of the reference's count handshake before the
        # variable-size particle sends, bvals_part.cpp)
        nfree = jnp.sum(~alive).astype(jnp.int32)
        peer_free = lax.ppermute(nfree.reshape((1,)), axis, rev)[0]
        quota = jnp.minimum(peer_free, cap)

        send = alive & (dest_dev == peer)
        order = jnp.argsort(~send)          # senders first, stable
        rows = order[:cap]
        valid = send[rows] & (jnp.arange(cap) < quota)
        overflow = overflow + (jnp.sum(send)
                               - jnp.sum(valid)).astype(jnp.int32)

        buf = {k: lax.ppermute(jnp.take(v, rows, axis=0), axis, fwd)
               for k, v in parts.items()}
        rvalid = lax.ppermute(valid, axis, fwd)

        # retire shipped rows
        shipped = jnp.zeros_like(alive).at[rows].set(valid)
        alive = alive & ~shipped

        # merge received rows into free slots (guaranteed to fit)
        free = ~alive
        slots = jnp.argsort(~free)[:cap]    # free slots first
        can_place = rvalid & free[slots]
        for k, v in parts.items():
            upd = jnp.where(
                can_place.reshape((-1,) + (1,) * (v.ndim - 1)),
                buf[k], jnp.take(v, slots, axis=0))
            parts[k] = v.at[slots].set(upd)
        dest_dev = dest_dev.at[slots].set(
            jnp.where(can_place, d, jnp.take(dest_dev, slots)))
        alive = alive.at[slots].set(can_place | alive[slots])

    return parts, alive, overflow
