"""Distributed execution: block-axis sharding over a device mesh.

Replaces the reference's MPI rank decomposition (reference:
src/mesh/load_balance.cpp:38-90, src/bvals/bvals_cc.cpp:42-289) with its
JAX equivalent: every state array has leading axis ``nmb`` (the
MeshBlockPack batch axis), and we shard that axis over a 1-D
``jax.sharding.Mesh``.  Blocks are Z-ordered (mesh.py), so a contiguous
shard is spatially compact — the same locality property the reference's
cost-list partitioner exploits.

Two execution paths:

  * **Explicit shard_map cycle** (``shard_comm.py``, the production
    multi-chip path): the whole cycle runs under ``jax.shard_map``; halo
    exchange ships only the ng-thick neighbor slabs that cross shard
    boundaries via per-peer ``lax.ppermute`` rounds (the rank-packed MPI
    analogue); dt is a ``lax.pmin``; non-divisible block counts run via
    block-pool padding.  A test asserts the compiled HLO contains
    collective-permutes and no all-gathers (tests/test_shard_comm.py).
  * **NamedSharding gather fallback** for configurations the shard_map
    cycle does not cover yet (SMR/AMR, GR, global-FFT gravity, particles):
    the ``jnp.take(u, nbr, 0)`` gathers are partitioned by XLA SPMD —
    correct everywhere, but with all-gather-class communication volume.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh as DeviceMesh
from jax.sharding import NamedSharding, PartitionSpec as P

BLOCK_AXIS = "mb"


def make_device_mesh(n_devices: Optional[int] = None,
                     devices=None) -> DeviceMesh:
    """1-D device mesh over the MeshBlock axis.

    The reference's only inter-node parallelism is data-parallel domain
    decomposition over blocks (SURVEY.md §2); a 1-D logical mesh is the
    native mapping.  The GPUs of one host are joined all to all by
    NVLink, so the order of the devices along the mesh does not matter.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return DeviceMesh(np.array(devices), (BLOCK_AXIS,))


def block_sharding(dmesh: DeviceMesh) -> NamedSharding:
    """Sharding that splits the leading (block) axis."""
    return NamedSharding(dmesh, P(BLOCK_AXIS))


def replicated(dmesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(dmesh, P())


def shard_state(state, dmesh: DeviceMesh):
    """Place a physics state pytree on the mesh, block axis sharded.

    Leaves whose leading axis is not divisible by the mesh (tiny
    replicated state like tracker positions [nco, 3] or RNG keys) are
    replicated instead.
    """
    sh = block_sharding(dmesh)
    rep = replicated(dmesh)
    n = dmesh.devices.size

    def place(a):
        ok = hasattr(a, "shape") and a.ndim >= 1 and a.shape[0] % n == 0
        return jax.device_put(a, sh if ok else rep)

    return jax.tree_util.tree_map(place, state)


def check_divisible(nmb_total: int, dmesh: DeviceMesh) -> None:
    n = dmesh.devices.size
    if nmb_total % n != 0:
        raise ValueError(
            f"nmb_total={nmb_total} not divisible by {n} devices; choose "
            f"meshblock sizes so the block count is a multiple of the mesh "
            f"(the reference imposes nmb >= nranks the same way, "
            f"reference: src/mesh/load_balance.cpp:55-63)")
