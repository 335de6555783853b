"""Ghost-zone filling: block-to-block halo exchange + physical BCs.

Replaces the reference's MPI pack/send/recv/unpack machinery
(reference: src/bvals/bvals_cc.cpp:42-289, src/bvals/physics/hydro_bcs.cpp)
with a dense-array design:

  * Same-level neighbor exchange is a static gather along the block axis
    (``u[nbr_gid]``).  Under block-axis sharding, XLA lowers this gather to
    device-to-device collectives automatically — the collective schedule
    the reference hand-builds with rank-packed MPI messages.
  * The three axes are swept sequentially (x1 then x2 then x3), each sweep
    copying the *full current extent* of the transverse axes.  Because sweep
    N copies ghosts filled by sweep N-1, edge and corner ghosts are filled
    transitively — the standard dimensional-sweep trick, replacing the
    reference's 56-neighbor buffer enumeration (reference: src/bvals/bvals.hpp:61-101).
  * Physical boundaries are applied afterwards on masked blocks with
    jnp.where selects, so the whole fill is one fused, shape-static program.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax.numpy as jnp
import numpy as np

from .comm import gather_blocks, local_blocks
from .indices import IVX, IVY, IVZ
from .mesh import Mesh

# cell-axis position of each mesh axis in [nmb, nvar, x3, x2, x1] arrays
_AXIS_OF = {"x1": 4, "x2": 3, "x3": 2}
_NORMAL_VEL = {"x1": IVX, "x2": IVY, "x3": IVZ}


class BoundaryValues:
    """Precomputed gather tables + BC appliers for cell-centered arrays."""

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh
        mbi = mesh.mb_indcs
        self.ng = mbi.ng
        # which axes actually have ghost zones
        self.active_axes = []
        if mbi.nx1 > 1:
            self.active_axes.append("x1")
        if mbi.nx2 > 1:
            self.active_axes.append("x2")
        if mbi.nx3 > 1:
            self.active_axes.append("x3")

        # Keep index tables as HOST numpy arrays: jit tracing embeds numpy
        # closures as HLO literals directly, whereas device-array closures
        # force a device->host readback at trace time.
        self.nbr = {k: np.asarray(v) for k, v in mesh.nbr_gid.items()}
        self.mask = {k: np.asarray(v) for k, v in mesh.phys_bc_mask.items()}
        self.any_phys = {k: bool(v.any()) for k, v in mesh.phys_bc_mask.items()}
        self.multilevel = bool(getattr(mesh, "multilevel", False))
        # boundary flag per mesh face ("m" side key ix*, "p" side key ox*)
        self.flag = {
            "x1m": mesh.mesh_bcs["ix1"], "x1p": mesh.mesh_bcs["ox1"],
            "x2m": mesh.mesh_bcs["ix2"], "x2p": mesh.mesh_bcs["ox2"],
            "x3m": mesh.mesh_bcs["ix3"], "x3p": mesh.mesh_bcs["ox3"],
        }
        # fixed inflow states, set by problem generators that use inflow BCs:
        # dict face-key -> [nvar] array
        self.inflow_state: Dict[str, jnp.ndarray] = {}
        # user BC hook: fn(u, bvals) -> u
        self.user_bc_func = None
        # mixed-level prolongation order: 2 (min-mod, default) or 4
        # (Lagrange; required by Z4c/dyngr on refined meshes, reference:
        # prolongation.hpp HighOrderProlongCC)
        self.prolong_order = 2
        # <mesh_refinement>/prolong_primitives: prolongate primitive
        # instead of conserved variables at fine/coarse boundaries
        # (reference: mesh_refinement.cpp:52-69, prolong_prims.cpp);
        # set by the physics module constructors
        self.prolong_prims = False
        self._ghost_mask_cache = None

    # ------------------------------------------------------------------
    def _exchange(self, slab, key: str):
        """Move donor slabs to their receivers along the block axis.

        Default: whole-axis gather (single device / NamedSharding).  Inside
        a ``use_comm(ShardComm(...))`` region (parallel/shard_comm.py) this
        becomes the explicit per-peer ppermute exchange — the rank-packed
        MPI analogue (reference: src/bvals/bvals_cc.cpp:42-255)."""
        from .comm import gather_blocks
        return gather_blocks(slab, self.nbr[key])

    def _local_mask(self, key: str):
        from .comm import local_blocks
        return local_blocks(self.mask[key])

    # ------------------------------------------------------------------
    def fill_ghosts(self, u):
        """Fill all ghost zones of a cell-centered array [nmb, nvar, n3, n2, n1].

        The normal-velocity channel for reflect/diode BCs is taken from the
        conserved/primitive index convention (IVX/IVY/IVZ == IM1/IM2/IM3).
        """
        # Mixed-level meshes run the sweeps twice: round 1 establishes
        # face ghosts everywhere, round 2 re-restricts/re-prolongates with
        # donors whose own ghosts are now valid, completing edge ghosts
        # (replaces the reference's explicit 56-neighbor edge/corner
        # buffers, reference: src/bvals/bvals.hpp:61-101).
        for _ in range(2 if self.multilevel else 1):
            for ax in self.active_axes:
                u = self._sweep_axis(u, ax)
        if self.multilevel:
            u = self._fill_corners(u)
        if self.user_bc_func is not None:
            u = self.user_bc_func(u, self)
        return u

    # ------------------------------------------------------------------
    def _ghost_mask(self):
        """[1, 1, n3, n2, n1] bool, True in ghost cells (cached)."""
        if self._ghost_mask_cache is None:
            mbi = self.mesh.mb_indcs
            m = np.ones((mbi.ncells3, mbi.ncells2, mbi.ncells1), bool)
            sl = [slice(None)] * 3
            if mbi.nx3 > 1:
                sl[0] = slice(mbi.ks, mbi.ke + 1)
            if mbi.nx2 > 1:
                sl[1] = slice(mbi.js, mbi.je + 1)
            sl[2] = slice(mbi.is_, mbi.ie + 1)
            m[tuple(sl)] = False
            self._ghost_mask_cache = m[None, None]
        return self._ghost_mask_cache

    def prolong_prims_fixup(self, u, w, p2c):
        """Prolongation in primitive variables: refill w's ghosts (so the
        mixed-level strips are prolonged from donor primitives) and
        overwrite u's ghost cells with p2c(w) (reference:
        prolong_prims.cpp ConsToPrimCoarseBndry/PrimToConsFineBndry).
        Returns (u, w)."""
        import jax.numpy as jnp

        w = self.fill_ghosts(w)
        ug = p2c(w)
        m = jnp.asarray(self._ghost_mask())
        return jnp.where(m, ug, u), w

    # ------------------------------------------------------------------
    def _fill_corners(self, u):
        """Direct diagonal-donor fill of the edge/corner ghost patches.

        The axis sweeps fill corners transitively via same-level copies,
        but at mixed-level junctions the restriction/prolongation write
        regions leave corner holes (restriction covers only the donor
        array's footprint; prolongation is guarded off strips whose
        diagonal is same-or-finer).  This pass copies/restricts the
        ng-deep corner patches straight from the diagonal donors — the
        reference's explicit edge/corner buffers
        (reference: src/bvals/bvals.hpp:61-101 neighbor enumeration)."""
        from .refinement import restrict_cc

        mesh = self.mesh
        mbi = mesh.mb_indcs
        ng, h = self.ng, self.ng // 2
        nx_of = {"x1": mbi.nx1, "x2": mbi.nx2, "x3": mbi.nx3}
        act = self.active_axes
        three_d = len(act) == 3

        def side_slices(ax, s, n):
            """(my ghost slice, same-donor slice, fine-donor slice)."""
            if s == "m":
                return (slice(0, ng), slice(n - 2 * ng, n - ng),
                        slice(n - ng - 2 * ng, n - ng))
            return (slice(n - ng, n), slice(ng, 2 * ng),
                    slice(ng, 3 * ng))

        pairs = [(d1, d2) for i, d1 in enumerate(act)
                 for d2 in act[i + 1:]]
        for d1, d2 in pairs:
            a1, a2 = _AXIS_OF[d1], _AXIS_OF[d2]
            n1, n2 = u.shape[a1], u.shape[a2]
            # edge direction (3D) / absent (2D)
            rest = [a for a in act if a not in (d1, d2)]
            for s1 in ("m", "p"):
                for s2 in ("m", "p"):
                    t = mesh.ml.get(f"e_{d1}{s1}{d2}{s2}")
                    if t is None or not (t.get("any_same")
                                         or t.get("any")):
                        continue
                    my1, dn1, fn1 = side_slices(d1, s1, n1)
                    my2, dn2, fn2 = side_slices(d2, s2, n2)
                    if t.get("any_same"):
                        region = [slice(None)] * 5
                        region[a1], region[a2] = my1, my2
                        region = tuple(region)
                        drg = [slice(None)] * 5
                        drg[a1], drg[a2] = dn1, dn2
                        donor = gather_blocks(u[tuple(drg)],
                                              t["same_gid"])
                        mb = local_blocks(
                            t["same_mask"]).reshape((-1,) + (1,) * 4)
                        u = u.at[region].set(
                            jnp.where(mb, donor, u[region]))
                    if t.get("any"):
                        drg = [slice(None)] * 5
                        drg[a1], drg[a2] = fn1, fn2
                        caxes = [a1 - 5, a2 - 5]
                        if rest:
                            caxes.append(_AXIS_OF[rest[0]] - 5)
                        parts = [restrict_cc(
                            gather_blocks(u[tuple(drg)], t["fine"][:, q]),
                            caxes)
                            for q in range(t["fine"].shape[1])]
                        region = [slice(None)] * 5
                        region[a1], region[a2] = my1, my2
                        if rest:
                            # assemble the two edge-axis donors over the
                            # transverse core (vertex cubes via v_ pass)
                            ar = _AXIS_OF[rest[0]]
                            nxt = nx_of[rest[0]]
                            keep = nxt // 2 + h
                            lo = jnp.take(parts[0], np.arange(keep),
                                          axis=ar)
                            nh = parts[1].shape[ar]
                            hi = jnp.take(parts[1], np.arange(h, nh),
                                          axis=ar)
                            assembled = jnp.concatenate([lo, hi],
                                                        axis=ar)
                            region[ar] = slice(h, u.shape[ar] - h)
                        else:
                            assembled = parts[0]
                        region = tuple(region)
                        mb = local_blocks(
                            t["mask"]).reshape((-1,) + (1,) * 4)
                        u = u.at[region].set(
                            jnp.where(mb, assembled, u[region]))
        if three_d:
            for s1 in ("m", "p"):
                for s2 in ("m", "p"):
                    for s3 in ("m", "p"):
                        t = mesh.ml.get(f"v_{s1}{s2}{s3}")
                        if t is None or not (t["any_same"]
                                             or t["any_fine"]):
                            continue
                        a1, a2, a3 = (_AXIS_OF["x1"], _AXIS_OF["x2"],
                                      _AXIS_OF["x3"])
                        my1, dn1, fn1 = side_slices("x1", s1,
                                                    u.shape[a1])
                        my2, dn2, fn2 = side_slices("x2", s2,
                                                    u.shape[a2])
                        my3, dn3, fn3 = side_slices("x3", s3,
                                                    u.shape[a3])
                        region = [slice(None)] * 5
                        region[a1], region[a2], region[a3] = my1, my2, my3
                        region = tuple(region)
                        if t["any_same"]:
                            drg = [slice(None)] * 5
                            drg[a1], drg[a2], drg[a3] = dn1, dn2, dn3
                            donor = gather_blocks(u[tuple(drg)],
                                                  t["same_gid"])
                            mb = local_blocks(
                                t["same_mask"]).reshape((-1,) + (1,) * 4)
                            u = u.at[region].set(
                                jnp.where(mb, donor, u[region]))
                        if t["any_fine"]:
                            drg = [slice(None)] * 5
                            drg[a1], drg[a2], drg[a3] = fn1, fn2, fn3
                            donor = restrict_cc(
                                gather_blocks(u[tuple(drg)],
                                              t["fine_gid"]),
                                [a1 - 5, a2 - 5, a3 - 5])
                            mb = local_blocks(
                                t["fine_mask"]).reshape((-1,) + (1,) * 4)
                            u = u.at[region].set(
                                jnp.where(mb, donor, u[region]))
        return u

    # ------------------------------------------------------------------
    def _sweep_axis(self, u, ax: str):
        ng = self.ng
        axis = _AXIS_OF[ax]
        n = u.shape[axis]

        def slc(lo, hi):
            idx = [slice(None)] * 5
            idx[axis] = slice(lo, hi)
            return tuple(idx)

        # ---- minus side: ghosts [0:ng] from neighbor's last ng active cells
        # (slice the donor slab BEFORE the block gather so the gather moves
        # only ng-thick slabs, not whole arrays)
        donor_m = self._exchange(u[slc(n - 2 * ng, n - ng)], f"{ax}m")
        ghost_m = donor_m
        if self.multilevel:
            ghost_m = self._ml_override(u, ax, "m", slc, n, ghost_m)
        if self.any_phys[f"{ax}m"]:
            ghost_m = self._phys_bc(u, ax, "m", slc, n, ghost_m)

        # ---- plus side: ghosts [n-ng:n] from neighbor's first ng active cells
        donor_p = self._exchange(u[slc(ng, 2 * ng)], f"{ax}p")
        ghost_p = donor_p
        if self.multilevel:
            ghost_p = self._ml_override(u, ax, "p", slc, n, ghost_p)
        if self.any_phys[f"{ax}p"]:
            ghost_p = self._phys_bc(u, ax, "p", slc, n, ghost_p)

        # Rebuild via one contiguous concatenate instead of two slab
        # .at[].set writes (one fused copy instead of two in-place
        # updates; not measured on the GPU).  Both ghost slabs read only
        # interior cells, so order is immaterial.
        return jnp.concatenate([ghost_m, u[slc(ng, n - ng)], ghost_p],
                               axis=axis)

    # ------------------------------------------------------------------
    def _ml_override(self, u, ax: str, side: str, slc, n, ghost):
        """Replace the same-level ghost candidate with restriction (finer
        donors) / prolongation (coarser donor) where the face is a level
        boundary (reference: bvals_cc.cpp pack/unpack with coarse buffers
        + ProlongCC/HighOrderProlongCC; here: masked selects over
        statically gathered slabs)."""
        from .refinement import (prolong_cc_order, prolong_guard,
                                 restrict_cc)

        t = self.mesh.ml[f"{ax}{side}"]
        if not (t["any_fine"] or t["any_coarse"]):
            return ghost
        # mixed-level blocks have no same-level donor: their gathered
        # candidate is self-garbage.  Start from the CURRENT ghost content
        # instead, so slab parts outside the restriction/prolongation write
        # regions (corner rings) retain what earlier sweeps copied there.
        mlm = local_blocks(
            t["fine_mask"] | t["coarse_mask"]).reshape((-1,) + (1,) * 4)
        cur = u[slc(0, self.ng)] if side == "m" \
            else u[slc(n - self.ng, n)]
        ghost = jnp.where(mlm, cur, ghost)
        mbi = self.mesh.mb_indcs
        ng, h = self.ng, self.ng // 2
        nx_of = {"x1": mbi.nx1, "x2": mbi.nx2, "x3": mbi.nx3}
        nc_of = {"x1": mbi.ncells1, "x2": mbi.ncells2, "x3": mbi.ncells3}
        tn = t["t_names"]
        cell_axes = [_AXIS_OF[a] - 5 for a in self.active_axes]

        # ---- finer donors: 2x cell-average restriction, quadrant assembly
        if t["any_fine"]:
            slab = u[slc(n - 3 * ng, n - ng)] if side == "m" \
                else u[slc(ng, 3 * ng)]
            parts = [restrict_cc(gather_blocks(slab, t["fine"][:, q]),
                                 cell_axes)
                     for q in range(t["fine"].shape[1])]
            # pair-merge along each transverse axis (fastest quadrant bit
            # first); each restricted slab covers my transverse cells
            # [h, mid+h) / [mid-h, nc-h), overlapping by 2h donor-ghost
            # cells that both donors agree on
            for a2 in tn:
                t_axis = _AXIS_OF[a2]
                keep = nx_of[a2] // 2 + h
                merged = []
                for b in range(0, len(parts), 2):
                    lo = jnp.take(parts[b], np.arange(keep), axis=t_axis)
                    nh = parts[b + 1].shape[t_axis]
                    hi = jnp.take(parts[b + 1], np.arange(h, nh),
                                  axis=t_axis)
                    merged.append(jnp.concatenate([lo, hi], axis=t_axis))
                parts = merged
            assembled = parts[0]
            # write into the transverse-core region [h, nc-h) of the slab
            region = [slice(None)] * 5
            for a2 in tn:
                region[_AXIS_OF[a2]] = slice(h, nc_of[a2] - h)
            region = tuple(region)
            fmask = local_blocks(t["fine_mask"]).reshape((-1,) + (1,) * 4)
            ghost = ghost.at[region].set(
                jnp.where(fmask, assembled, ghost[region]))

        # ---- coarser donor: min-mod (or 4th-order Lagrange) prolongation
        # over a per-block parity-selected window of the donor face
        if t["any_coarse"]:
            g = prolong_guard(self.prolong_order)
            slab = u[slc(n - ng - h - g, n - ng + g)] if side == "m" \
                else u[slc(ng - g, ng + h + g)]
            d = gather_blocks(slab, t["coarse"])
            for a2 in tn:
                t_axis = _AXIS_OF[a2]
                half = nx_of[a2] // 2
                ln = half + ng + 2 * g
                # two static parity windows + per-block select (static
                # slices instead of take_along_axis gathers)
                s0 = ng - h - g
                d0 = jnp.take(d, np.arange(s0, s0 + ln), axis=t_axis)
                d1 = jnp.take(d, np.arange(s0 + half, s0 + half + ln),
                              axis=t_axis)
                sel = local_blocks(t["par"][a2].astype(bool)).reshape(
                    (-1,) + (1,) * 4)
                d = jnp.where(sel, d1, d0)
            pro = prolong_cc_order(d, cell_axes, self.prolong_order)
            wmask = local_blocks(
                t["coarse_mask"]).reshape((-1,) + (1,) * 4)
            # guard the transverse corner strips: where the diagonal
            # neighbor is same-level or finer, the sweeps already placed
            # the correct (copied/restricted) values there — the prolonged
            # candidate would de-synchronize the corner EMF stencils of
            # adjacent fine blocks (concave trees; see refinement.pkeep)
            for a2 in tn:
                t_axis = _AXIS_OF[a2]
                ncc = nc_of[a2]
                shp = [1] * 5
                shp[t_axis] = ncc
                pos = np.arange(ncc).reshape(shp)
                km = local_blocks(
                    t["pkeep"][a2]["m"]).reshape((-1,) + (1,) * 4)
                kp = local_blocks(
                    t["pkeep"][a2]["p"]).reshape((-1,) + (1,) * 4)
                wmask = wmask & ((pos >= ng) | km) \
                    & ((pos < ncc - ng) | kp)
            ghost = jnp.where(wmask, pro, ghost)
        return ghost

    # ------------------------------------------------------------------
    def _phys_bc(self, u, ax: str, side: str, slc, n, gathered):
        """Compute physical-BC ghost values and select them on masked blocks.

        Ghost slabs are ordered by increasing cell index along the axis, so on
        the minus side slot g (g=0 outermost) corresponds to ghost index
        ng-1-g... careful index maps below mirror the reference loops
        (reference: src/bvals/physics/hydro_bcs.cpp:85-130).
        """
        ng = self.ng
        axis = _AXIS_OF[ax]
        key = f"{ax}{side}"
        flag = self.flag[key]
        nvel = _NORMAL_VEL[ax]
        mask = self._local_mask(key)
        maskb = mask.reshape((-1,) + (1,) * 4)

        if side == "m":
            active_edge = u[slc(ng, 2 * ng)]     # cells is..is+ng-1 (increasing)
            edge_cell = u[slc(ng, ng + 1)]       # cell is
            mirrored = jnp.flip(active_edge, axis=axis)
        else:
            active_edge = u[slc(n - 2 * ng, n - ng)]  # cells ie-ng+1..ie
            edge_cell = u[slc(n - ng - 1, n - ng)]    # cell ie
            mirrored = jnp.flip(active_edge, axis=axis)

        if flag == "reflect":
            bc = mirrored.at[:, nvel].multiply(-1.0)
        elif flag == "outflow":
            bc = jnp.broadcast_to(edge_cell, gathered.shape)
        elif flag == "diode":
            # outflow, but the normal velocity/momentum cannot point inward
            v = edge_cell[:, nvel]
            v = jnp.minimum(v, 0.0) if side == "m" else jnp.maximum(v, 0.0)
            bc = jnp.broadcast_to(edge_cell.at[:, nvel].set(v), gathered.shape)
        elif flag == "inflow":
            state = self.inflow_state.get(key)
            if state is None:
                bc = jnp.broadcast_to(edge_cell, gathered.shape)  # pre-pgen
            else:
                bc = jnp.broadcast_to(
                    state.reshape(1, -1, 1, 1, 1), gathered.shape)
        elif flag == "vacuum":
            bc = jnp.zeros_like(gathered)
        elif flag in ("periodic", "shear_periodic", "user"):
            return gathered  # periodic via gather; user hook runs afterwards
        else:
            raise ValueError(f"unhandled boundary flag '{flag}'")

        return jnp.where(maskb, bc, gathered)
