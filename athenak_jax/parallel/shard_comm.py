"""Explicit multi-chip block communication: shard_map + per-slab ppermute.

The replacement for the reference's rank-packed aggregated MPI
messages (reference: src/bvals/bvals_cc.cpp:42-255, bvals.hpp:104-172).
Design:

  * Blocks are Z-ordered and assigned contiguously: device ``d`` owns gids
    ``[d*L, (d+1)*L)`` (the reference's ``Mesh::LoadBalance`` contiguous
    ranges, reference: src/mesh/load_balance.cpp:38-90).  Non-divisible
    block counts are padded with inactive clone blocks (the reference's
    any-nmb>=nranks balancing maps here to capacity padding).
  * Every block-axis data movement in the frameworks is expressed as a
    *gather with a host gid map* — same-level halo donors, mixed-level
    fine/coarse donor quadruples, EMF edge donors, flux-correction
    partners (see comm.gather_blocks).  Under shard_map each distinct map
    compiles to per-peer packed buffers moved with one
    ``jax.lax.ppermute`` round per participating device offset — slabs
    packed per peer exactly like the reference's rank-packed buffers.
    The maps need not be bijections: duplicated donors are packed twice,
    unused slabs are never sent.
  * Per-block host constants (physical-BC masks, prolongation parity
    tables, per-block dx, GR coordinate arrays) are consumed through
    ``comm.local_blocks``, which hands each device its own rows.
  * All tables are computed once on host and cached per gid map; inside
    ``shard_map`` each device picks its row with ``lax.axis_index``.

Communication volume per sweep is one ng-thick face slab per block-face
that crosses a shard boundary — identical to the reference's MPI traffic —
instead of the all-gather a whole-axis ``jnp.take`` would lower to.
"""

from __future__ import annotations

import math
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh as DeviceMesh, PartitionSpec as P

from ..comm import use_comm

BLOCK_AXIS = "mb"


def padded_nmb(nmb_total: int, ndev: int) -> int:
    """Block-pool capacity: smallest multiple of ndev >= nmb_total."""
    return ndev * math.ceil(nmb_total / ndev)


class ShardLayout:
    """gid <-> block-pool-slot mapping for one device count.

    With uniform block costs this is the identity layout (gids in order,
    pads at the pool tail).  With non-uniform ``mesh.cost_eachmb`` the
    reference's cost-weighted contiguous assignment
    (reference: src/mesh/load_balance.cpp:38-90) decides how many blocks
    each device owns; every device's range is padded to the common
    capacity L = max(nmb_eachrank) so shard_map keeps equal shards.
    """

    def __init__(self, mesh, ndev: int) -> None:
        from ..mesh import load_balance

        nmb = mesh.nmb_total
        cost = np.asarray(getattr(mesh, "cost_eachmb",
                                  np.ones(nmb, np.float32)),
                          dtype=np.float64)
        self.nmb = nmb
        self.ndev = ndev
        uniform = bool(np.all(cost == cost[0]))
        if uniform:
            self.rank_eachmb = np.minimum(
                np.arange(nmb) // math.ceil(nmb / ndev), ndev - 1)
            self.L = math.ceil(nmb / ndev)
            self.nmb_pad = self.L * ndev
            # identity layout: gids in order, pads at the global tail
            self.slot_of_gid = np.arange(nmb, dtype=np.int64)
            self.identity = True
        else:
            self.rank_eachmb, gids_each, nmb_each = load_balance(cost, ndev)
            self.L = int(nmb_each.max())
            self.nmb_pad = self.L * ndev
            self.slot_of_gid = (self.rank_eachmb * self.L
                                + np.arange(nmb, dtype=np.int64)
                                - gids_each[self.rank_eachmb])
            self.identity = False
        self.gid_of_slot = np.full(self.nmb_pad, -1, dtype=np.int64)
        self.gid_of_slot[self.slot_of_gid] = np.arange(nmb)
        self.nmb_eachrank = np.bincount(self.rank_eachmb, minlength=ndev)
        self.cost_eachrank = np.bincount(
            self.rank_eachmb, weights=cost, minlength=ndev)
        # reference lb-efficiency figure (driver.cpp:425-432): fraction
        # of ideal throughput set by the heaviest rank
        total = float(self.cost_eachrank.sum())
        self.lb_efficiency = total / (ndev * float(
            self.cost_eachrank.max())) if total > 0 else 1.0


def shard_layout(mesh, ndev: int) -> ShardLayout:
    """Cached per-mesh layout (the driver and ShardComm must agree)."""
    cache = getattr(mesh, "_shard_layouts", None)
    if cache is None:
        cache = mesh._shard_layouts = {}
    lay = cache.get(ndev)
    if lay is None:
        lay = cache[ndev] = ShardLayout(mesh, ndev)
    return lay


def pad_state(state, layout: ShardLayout):
    """Arrange every [nmb, ...] leaf into the [nmb_pad] block pool.

    Pad slots are clones of block 0: pad blocks evolve as isolated
    periodic boxes (their wrapped neighbor map is the identity), so they
    stay finite and contribute the same dt as the real block 0 — no
    active-mask plumbing needed in the kernels.
    """
    if layout.nmb_pad == layout.nmb and layout.identity:
        return state
    rows = np.where(layout.gid_of_slot >= 0, layout.gid_of_slot, 0)

    def pad(a):
        if not hasattr(a, "shape") or a.ndim < 1 \
                or a.shape[0] != layout.nmb:
            return a
        if layout.identity:
            reps = jnp.broadcast_to(
                a[:1], (layout.nmb_pad - layout.nmb,) + a.shape[1:])
            return jnp.concatenate([a, reps], axis=0)
        return jnp.take(a, jnp.asarray(rows), axis=0)

    return jax.tree_util.tree_map(pad, state)


def unpad_state(state, layout_or_nmb):
    """Strip pool padding back to gid order."""
    if isinstance(layout_or_nmb, ShardLayout):
        lay = layout_or_nmb
        if lay.identity:
            return jax.tree_util.tree_map(
                lambda a: a[:lay.nmb]
                if hasattr(a, "shape") and a.ndim >= 1
                and a.shape[0] == lay.nmb_pad else a, state)
        idx = jnp.asarray(lay.slot_of_gid)
        return jax.tree_util.tree_map(
            lambda a: jnp.take(a, idx, axis=0)
            if hasattr(a, "shape") and a.ndim >= 1
            and a.shape[0] == lay.nmb_pad else a, state)
    nmb_total = layout_or_nmb
    return jax.tree_util.tree_map(
        lambda a: a[:nmb_total] if hasattr(a, "shape") and a.ndim >= 1
        else a, state)


class _Route:
    """Packed ppermute routing for one gid map ``idx`` (out[g] = in[idx[g]]).

    send_idx[r]    int [ndev, max_r]: local slab indices device d packs
                   for peer (d+r) % ndev in ppermute round r
    src_slot       int [ndev, L]: where receiver slot i finds its donor
                   in concat([local_slabs] + recv_bufs)
    rounds         device offsets with any traffic
    """

    def __init__(self, idx: np.ndarray, layout: ShardLayout) -> None:
        nmb_pad, ndev = layout.nmb_pad, layout.ndev
        L = nmb_pad // ndev
        # gid-space donor map -> slot-space; pads self-donate
        perm = np.arange(nmb_pad, dtype=np.int64)
        real = layout.gid_of_slot >= 0
        perm[real] = layout.slot_of_gid[idx[layout.gid_of_slot[real]]]

        dest_dev = perm // L       # owner device of the donor slab
        owner_of = perm % L
        sends: Dict[int, Dict[int, list]] = {d: {} for d in range(ndev)}
        for g in range(nmb_pad):
            d = g // L             # receiver device
            o = int(dest_dev[g])
            if o == d:
                continue
            r = (d - o) % ndev
            sends[o].setdefault(r, []).append(int(owner_of[g]))
        rounds = sorted({r for m in sends.values() for r in m})
        max_r = {r: max((len(m.get(r, ())) for m in sends.values()),
                        default=0) for r in rounds}
        send_tables = []
        offsets = {}
        off = L
        for r in rounds:
            t = np.zeros((ndev, max_r[r]), dtype=np.int32)
            for o in range(ndev):
                lst = sends[o].get(r, [])
                t[o, : len(lst)] = lst
            send_tables.append(t)
            offsets[r] = off
            off += max_r[r]

        # receiver gather slots: receivers enumerate each sender's packed
        # list in the same ascending-gid order the senders built it
        slot = np.zeros((ndev, L), dtype=np.int32)
        pos_in_round: Dict[tuple, int] = {}
        for g in range(nmb_pad):
            d = g // L
            i = g % L
            o = int(dest_dev[g])
            if o == d:
                slot[d, i] = int(owner_of[g])
            else:
                r = (d - o) % ndev
                m = pos_in_round.get((o, r), 0)
                pos_in_round[(o, r)] = m + 1
                slot[d, i] = offsets[r] + m
        self.rounds = rounds
        self.send_idx = send_tables
        self.src_slot = slot
        self.ndev = ndev


class ShardComm:
    """The communication implementation consulted by bvals/physics at
    trace time inside a shard_map region (see athenak_jax/comm.py)."""

    def __init__(self, mesh, ndev: int, axis: str = BLOCK_AXIS) -> None:
        self.layout = shard_layout(mesh, ndev)
        self.nmb = mesh.nmb_total
        self.ndev = ndev
        self.nmb_pad = self.layout.nmb_pad
        self.L = self.nmb_pad // ndev
        self.axis = axis
        self._routes: Dict[bytes, _Route] = {}

    # -- arbitrary block gather -----------------------------------------
    def gather(self, slab, idx: np.ndarray):
        """slab: local donor slabs [L, ...]; returns [L, ...] where
        out[local i of gid g] = global_slab[idx[g]]."""
        key = idx.tobytes()
        route = self._routes.get(key)
        if route is None:
            route = _Route(idx.astype(np.int64), self.layout)
            self._routes[key] = route
        d = lax.axis_index(self.axis)
        parts = [slab]
        for r, table in zip(route.rounds, route.send_idx):
            if table.shape[1] == 0:
                continue
            send = jnp.take(jnp.asarray(table), d, axis=0)
            buf = jnp.take(slab, send, axis=0)
            perm = [(s, (s + r) % self.ndev) for s in range(self.ndev)]
            parts.append(lax.ppermute(buf, self.axis, perm))
        allbuf = parts[0] if len(parts) == 1 \
            else jnp.concatenate(parts, axis=0)
        slot = jnp.take(jnp.asarray(route.src_slot), d, axis=0)
        return jnp.take(allbuf, slot, axis=0)

    # -- per-block host tables ------------------------------------------
    def local_rows(self, tab: np.ndarray, pad_edge: bool):
        if tab.ndim < 1 or tab.shape[0] not in (self.nmb, self.nmb_pad):
            return tab
        if tab.shape[0] == self.nmb and self.nmb_pad > self.nmb:
            gos = self.layout.gid_of_slot
            rows = np.where(gos >= 0, gos, 0)
            tab = tab[rows]
            if not pad_edge:
                tab = np.where(
                    (gos >= 0).reshape((-1,) + (1,) * (tab.ndim - 1)),
                    tab, np.zeros_like(tab))
        elif tab.shape[0] == self.nmb and not self.layout.identity:
            tab = tab[self.layout.gid_of_slot]
        d = lax.axis_index(self.axis)
        full = jnp.asarray(tab.reshape((self.ndev, self.L)
                                       + tab.shape[1:]))
        return jnp.take(full, d, axis=0)

    # -- reductions ------------------------------------------------------
    def pmin(self, x):
        return lax.pmin(x, self.axis)

    def psum(self, x):
        return lax.psum(x, self.axis)


def supports_shard_cycle(driver, state) -> bool:
    """Whether the explicit shard_map cycle covers this configuration.

    Covered: uniform, statically-refined (SMR), and adaptive (AMR)
    Newtonian/SR/GR hydro and MHD, with diffusion/srcterms/FOFC.  An
    adaptive tree is an SMR tree between refinement epochs: the AMR
    driver redistributes blocks to the cost-weighted layout and rebuilds
    the ppermute routes after every tree update (amr.py step; the
    reference analogue is RedistAndRefineMeshBlocks over the AMR
    communicator, mesh_refinement.hpp:26-99).  The fixed-capacity block
    pool rides the gather path with bounded compiles (amr.py
    _put_tables).  Excluded configurations fall back to the
    NamedSharding gather path (still multi-device-correct, higher comm
    volume): modules with global-array state (FFT/multigrid gravity,
    shearing box — the sheared ring remap reads the whole opposite
    boundary column).  Turbulence driving rides the cycle (psum volume
    integrals, replicated OU key); so do two-fluid ImEx, Radiation and
    RadiationFluid: the angle axis stays on-device (SURVEY §5) and the
    block halo is the same CC exchange hydro uses (reference:
    src/bvals/bvals_cc.cpp:42-289); per-block tetrad tables localize
    via radiation._lb.
    """
    phys = driver.phys
    if type(phys).__name__ not in ("Hydro", "MHD", "Z4c", "DynGRMHD",
                                   "Radiation", "RadiationFluid",
                                   "IonNeutral"):
        return False
    if getattr(driver.mesh, "adaptive", False) \
            and getattr(driver, "pamr", None) is not None \
            and driver.pamr.use_pool:
        return False
    # IonNeutral two-fluid ImEx rides the cycle: both fluids' halos run
    # the same per-peer ppermute exchange and the implicit drag solve is
    # pointwise (reference: the ImEx task list reuses the rank-packed
    # bvals, ion-neutral_tasks.cpp:95-295)
    # turbulence driving rides the cycle: its volume integrals psum via
    # comm.global_sum (the MPI_Allreduce analogue, turb_driver.cpp:742)
    # and the OU PRNG key replicates across devices
    for mod in ("psbox", "pgrav"):
        if getattr(phys, mod, None) is not None:
            return False
    if getattr(phys, "bvals", None) is None:
        return False
    ubc = phys.bvals.user_bc_func
    if ubc is not None and not getattr(ubc, "shard_safe", False):
        # user BCs closing over [nmb_total] arrays break under shard_map
        # unless they localize their tables (comm.local_blocks) and
        # declare it with `fn.shard_safe = True` (e.g. pgen/gr_bondi.py)
        return False
    nmb = driver.mesh.nmb_total
    ok_dims = {nmb}
    ndev = driver.dmesh.devices.size if driver.dmesh is not None else 1
    if driver.dmesh is not None:
        ok_dims.add(shard_layout(driver.mesh, ndev).nmb_pad)
    ppart = getattr(phys, "ppart", None)
    if ppart is not None:
        # drift particles shard over the particle axis (the pusher never
        # reads grid data, reference: particles_pushers.cpp:19-59;
        # grid-coupled pushers would add part_comm.exchange_particles);
        # require an evenly divisible count for equal shards
        if ppart.nprtcl % ndev != 0 or ppart.nprtcl in ok_dims:
            return False  # ambiguous with the block axis: gather path
        ok_dims.add(ppart.nprtcl)
    rep_dims = _replicated_dims(phys, ok_dims)
    return all(_is_replicated_leaf(path, leaf, rep_dims)
               or (hasattr(leaf, "shape") and leaf.ndim >= 1
                   and leaf.shape[0] in ok_dims)
               for path, leaf in
               jax.tree_util.tree_flatten_with_path(state)[0])


#: state keys replicated (identical) on every device rather than
#: block-sharded: the turbulence OU PRNG key (every device draws the
#: same modes; the reference broadcasts the same amplitudes to all
#: ranks, turb_driver.cpp:500-560)
_REPLICATED_KEYS = frozenset({"turb_key"})


def _is_replicated_leaf(path, leaf, rep_dims) -> bool:
    if not hasattr(leaf, "shape") or leaf.ndim < 1:
        return False
    name = getattr(path[-1], "key", None) if path else None
    if name in _REPLICATED_KEYS:
        return True
    return leaf.shape[0] in rep_dims


def _replicated_dims(phys, ok_dims):
    """Leading dims of state leaves that are REPLICATED (not block-
    sharded) in the shard cycle: compact-object tracker positions
    [nco, 3] (kept identical on every device via the psum in
    z4c_amr.device_interp)."""
    nco = getattr(phys, "nco", 0)
    return {nco} - ok_dims if nco else set()


def build_shard_cycle(driver, dmesh: DeviceMesh, state_template):
    """shard_map-wrapped cycle: explicit ppermute halo + pmin dt + psum
    counters.  Returns (fn(state, dt) -> (state, dtnew, counters), comm).
    """
    ndev = dmesh.devices.size
    comm = ShardComm(driver.mesh, ndev, BLOCK_AXIS)
    inner = driver.make_cycle_fn()

    def local_cycle(state, dt):
        with use_comm(comm):
            state, dtnew, counters = inner(state, dt)
        dtnew = lax.pmin(dtnew, BLOCK_AXIS)
        if counters is not None:
            counters = {k: lax.psum(v, BLOCK_AXIS)
                        for k, v in counters.items()}
        return state, dtnew, counters

    # per-leaf specs: block/particle-axis leaves shard over the mesh,
    # tracker positions (and other tiny replicated leaves) stay P()
    rep_dims = _replicated_dims(driver.phys, {comm.nmb, comm.nmb_pad})
    pleaves, treedef = jax.tree_util.tree_flatten_with_path(
        state_template)
    state_spec = jax.tree_util.tree_unflatten(
        treedef, [P() if _is_replicated_leaf(path, lf, rep_dims)
                  else P(BLOCK_AXIS) for path, lf in pleaves])

    fn = jax.shard_map(
        local_cycle, mesh=dmesh,
        in_specs=(state_spec, P()),
        out_specs=(state_spec, P(), P()),
        check_vma=False)
    return fn, comm
