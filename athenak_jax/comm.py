"""Trace-time communication context for halo exchange.

The boundary-values code asks this module how to move donor slabs between
blocks.  Outside any context (the default), the exchange is a whole-axis
gather ``jnp.take(slab, nbr, 0)`` — correct on one device and under plain
NamedSharding.  Inside ``use_comm(ShardComm(...))`` (see
``parallel/shard_comm.py``), the same call becomes an explicit
per-neighbor-slab ``jax.lax.ppermute`` exchange running inside
``shard_map`` — the JAX equivalent of the reference's rank-packed
MPI messages (reference: src/bvals/bvals_cc.cpp:42-255).

The context is consulted at *trace* time only; the jitted cycle bakes in
whichever exchange was active when it was traced.
"""

from __future__ import annotations

from contextlib import contextmanager

_CURRENT = None


def current_comm():
    return _CURRENT


def gather_blocks(slab, idx):
    """Donor-slab movement along the block axis: out[i] = slab[idx[i]].

    ``idx`` is an arbitrary host gid map (not necessarily a bijection —
    mixed-level donor maps duplicate and skip slabs).  Default: whole-axis
    gather.  Inside ``use_comm``: per-peer ppermute routing built from the
    map (parallel/shard_comm.py), the rank-packed MPI analogue
    (reference: src/bvals/bvals_cc.cpp:42-255)."""
    import numpy as np

    if _CURRENT is None:
        import jax.numpy as jnp
        if isinstance(idx, np.ndarray):
            idx = np.asarray(idx)  # host table baked as an HLO literal
        return jnp.take(slab, idx, axis=0)
    return _CURRENT.gather(slab, np.asarray(idx))


def local_blocks(tab, pad_edge: bool = False):
    """Per-block host table [nmb_total, ...] -> the rows owned locally.

    Outside ``use_comm`` this is the identity.  Inside a shard_map region
    it returns the calling device's [L, ...] rows, padding the pool tail
    with zeros (masks: pad blocks take no physical BCs / overrides) or,
    with ``pad_edge``, with row 0 (geometry: pad blocks clone block 0,
    matching parallel/shard_comm.pad_state).  Scalars and arrays without
    a block axis pass through unchanged."""
    import numpy as np

    if _CURRENT is None or tab is None:
        return tab
    if not hasattr(tab, "ndim") or tab.ndim == 0:
        return tab
    if not isinstance(tab, np.ndarray):
        return tab  # traced table (AMR block pool): already pool-shaped
    return _CURRENT.local_rows(np.asarray(tab), pad_edge)


def global_sum(x):
    """All-block reduction of a per-block partial sum.

    Outside ``use_comm`` this is the identity (a jnp reduction already
    sees every block).  Inside the shard cycle the calling device holds
    only its own blocks, so the partial is ``lax.psum``-reduced over the
    block axis — the analogue of the reference's
    ``MPI_Allreduce`` in the turbulence normalization
    (reference: src/srcterms/turb_driver.cpp:742)."""
    if _CURRENT is None:
        return x
    return _CURRENT.psum(x)


@contextmanager
def use_comm(comm):
    global _CURRENT
    prev = _CURRENT
    _CURRENT = comm
    try:
        yield comm
    finally:
        _CURRENT = prev
