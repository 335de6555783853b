"""Mesh: global grid + MeshBlock decomposition (host-side geometry).

Parity target: the reference ``Mesh`` / ``MeshBlockTree`` / ``MeshBlock``
machinery (reference: src/mesh/mesh.hpp:92-185, meshblock_tree.cpp,
build_tree.cpp).  Design choices:

  * All geometry (logical locations, neighbor tables, block extents) is
    computed once on host with numpy; the per-cycle compute path only sees
    static gather-index arrays baked into the jitted step function.
  * Blocks are ordered by Z-order (Morton) curve exactly like the reference's
    tree traversal, so a contiguous shard of the block axis is spatially
    compact — the property the reference's MPI LoadBalance exploits
    (reference: src/mesh/load_balance.cpp:38-90) and that keeps block-axis
    shards' halo traffic mostly between neighbouring devices.
  * Uniform-level meshes are the fast path (single static gather for halo
    exchange); SMR/AMR extends the same index tables with
    prolongation/restriction stencils.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from .athinput import ParameterInput

BOUNDARY_FLAGS = ("undef", "periodic", "outflow", "reflect", "inflow",
                  "diode", "user", "vacuum", "shear_periodic")


def _interleave_bits3(x: int, y: int, z: int, nbits: int) -> int:
    """Morton key with x fastest: bit order (z_i, y_i, x_i)."""
    key = 0
    for i in range(nbits):
        key |= ((x >> i) & 1) << (3 * i)
        key |= ((y >> i) & 1) << (3 * i + 1)
        key |= ((z >> i) & 1) << (3 * i + 2)
    return key


@dataclass
class RegionSize:
    x1min: float
    x1max: float
    x2min: float
    x2max: float
    x3min: float
    x3max: float
    dx1: float = 0.0
    dx2: float = 0.0
    dx3: float = 0.0


@dataclass
class RegionIndcs:
    """Cell index ranges, mirroring the reference ``RegionIndcs``
    (reference: src/athena.hpp:166-176)."""
    ng: int
    nx1: int
    nx2: int
    nx3: int
    is_: int
    ie: int
    js: int
    je: int
    ks: int
    ke: int
    cnx1: int = 0  # coarse-array extents (used with SMR/AMR)
    cnx2: int = 0
    cnx3: int = 0

    @property
    def ncells1(self) -> int:
        return self.nx1 + 2 * self.ng if self.nx1 > 1 else 1

    @property
    def ncells2(self) -> int:
        return self.nx2 + 2 * self.ng if self.nx2 > 1 else 1

    @property
    def ncells3(self) -> int:
        return self.nx3 + 2 * self.ng if self.nx3 > 1 else 1


def load_balance(clist: np.ndarray, nranks: int):
    """Cost-weighted contiguous block assignment (reference:
    src/mesh/load_balance.cpp:38-90 Mesh::LoadBalance).

    Walks the Z-ordered cost list from the end assigning blocks to ranks
    against a running per-rank cost target, so rank 0 (the reference's
    master rank) ends up with the lightest load.  Returns
    (rank_eachmb [nmb], gids_eachrank [nranks], nmb_eachrank [nranks]).
    """
    clist = np.asarray(clist, dtype=np.float64)
    nb = len(clist)
    if nb < nranks:
        raise ValueError(f"{nb} blocks cannot cover {nranks} ranks; "
                         "use smaller meshblocks")
    rank = np.empty(nb, dtype=np.int64)
    total = float(clist.sum())
    j = nranks - 1
    target = total / nranks
    mycost = 0.0
    for i in range(nb - 1, -1, -1):
        if target <= 0.0:
            raise ValueError("load_balance: a rank received no blocks")
        mycost += clist[i]
        rank[i] = j
        # close rank j when its target is met — or force-close once only
        # j blocks remain, so no rank is left without a block (the
        # reference instead aborts in that case, load_balance.cpp:55-60)
        if j > 0 and (mycost >= target or i == j):
            j -= 1
            total -= mycost
            mycost = 0.0
            target = total / (j + 1)
    nmb_eachrank = np.bincount(rank, minlength=nranks).astype(np.int64)
    gids_eachrank = np.concatenate([[0], np.cumsum(nmb_eachrank)[:-1]])
    return rank, gids_eachrank, nmb_eachrank


class Mesh:
    """Global uniform(-level) Cartesian mesh decomposed into MeshBlocks.

    Round-1 scope: a single refinement level (the reference calls this a
    uniform mesh even when the tree is deep); SMR/AMR layers extend this
    class with per-level neighbor/prolongation tables.
    """

    def __init__(self, pin: ParameterInput, leaves=None) -> None:
        """``leaves``: explicit leaf list [(l1,l2,l3,lev)] — used by the
        adaptive-AMR rebuild path (amr.py) to reconstruct the mesh after a
        tree update (reference: RedistAndRefineMeshBlocks,
        src/mesh/mesh_refinement.cpp:427-560)."""
        self.pin = pin

        ms = RegionSize(
            x1min=pin.get_real("mesh", "x1min"),
            x1max=pin.get_real("mesh", "x1max"),
            x2min=pin.get_real("mesh", "x2min"),
            x2max=pin.get_real("mesh", "x2max"),
            x3min=pin.get_real("mesh", "x3min"),
            x3max=pin.get_real("mesh", "x3max"),
        )
        nx1 = pin.get_integer("mesh", "nx1")
        nx2 = pin.get_integer("mesh", "nx2")
        nx3 = pin.get_integer("mesh", "nx3")
        ng = pin.get_or_add_integer("mesh", "nghost", 2)
        ms.dx1 = (ms.x1max - ms.x1min) / nx1
        ms.dx2 = (ms.x2max - ms.x2min) / nx2
        ms.dx3 = (ms.x3max - ms.x3min) / nx3
        self.mesh_size = ms

        self.one_d = (nx2 == 1) and (nx3 == 1)
        self.two_d = (nx2 > 1) and (nx3 == 1)
        self.three_d = nx3 > 1
        self.multi_d = not self.one_d

        if nx2 == 1 and nx3 > 1:
            raise ValueError("mesh with nx2=1 but nx3>1 is not supported")

        # global active-cell index struct
        self.mesh_indcs = RegionIndcs(
            ng=ng, nx1=nx1, nx2=nx2, nx3=nx3,
            is_=0, ie=nx1 - 1, js=0, je=nx2 - 1, ks=0, ke=nx3 - 1)

        # meshblock sizes (default: one block spans the mesh)
        mbnx1 = pin.get_or_add_integer("meshblock", "nx1", nx1)
        mbnx2 = pin.get_or_add_integer("meshblock", "nx2", nx2)
        mbnx3 = pin.get_or_add_integer("meshblock", "nx3", nx3)
        for tot, mb, ax in ((nx1, mbnx1, 1), (nx2, mbnx2, 2), (nx3, mbnx3, 3)):
            if tot % mb != 0:
                raise ValueError(
                    f"mesh/nx{ax}={tot} not divisible by meshblock/nx{ax}={mb}")

        is1 = ng if mbnx1 > 1 else 0
        is2 = ng if mbnx2 > 1 else 0
        is3 = ng if mbnx3 > 1 else 0
        self.mb_indcs = RegionIndcs(
            ng=ng, nx1=mbnx1, nx2=mbnx2, nx3=mbnx3,
            is_=is1, ie=is1 + mbnx1 - 1,
            js=is2, je=is2 + mbnx2 - 1,
            ks=is3, ke=is3 + mbnx3 - 1,
            cnx1=max(mbnx1 // 2, 1), cnx2=max(mbnx2 // 2, 1),
            cnx3=max(mbnx3 // 2, 1))

        # block grid dimensions
        self.nmb_x1 = nx1 // mbnx1
        self.nmb_x2 = nx2 // mbnx2
        self.nmb_x3 = nx3 // mbnx3
        self.nmb_total = self.nmb_x1 * self.nmb_x2 * self.nmb_x3

        # boundary flags for the 6 mesh faces
        def bflag(key: str, default: str) -> str:
            v = pin.get_or_add_string("mesh", key, default)
            if v not in BOUNDARY_FLAGS:
                raise ValueError(f"unknown boundary flag mesh/{key}={v}")
            return v

        self.mesh_bcs = {
            "ix1": bflag("ix1_bc", "periodic"),
            "ox1": bflag("ox1_bc", "periodic"),
            "ix2": bflag("ix2_bc", "periodic"),
            "ox2": bflag("ox2_bc", "periodic"),
            "ix3": bflag("ix3_bc", "periodic"),
            "ox3": bflag("ox3_bc", "periodic"),
        }
        for (a, b) in (("ix1", "ox1"), ("ix2", "ox2"), ("ix3", "ox3")):
            pa, pb = self.mesh_bcs[a] == "periodic", self.mesh_bcs[b] == "periodic"
            if pa != pb:
                raise ValueError(f"{a}/{b} must both be periodic or neither")

        # mesh refinement (reference: build_tree.cpp:62-229)
        self.multilevel = False
        self.adaptive = False
        if pin.does_block_exist("mesh_refinement"):
            ref = pin.get_string("mesh_refinement", "refinement")
            if ref == "adaptive":
                self.adaptive = True
            elif ref == "static":
                self.multilevel = True
            elif ref != "none":
                raise ValueError(f"mesh_refinement/refinement={ref}")
        # finest allowed level relative to root (reference:
        # build_tree.cpp:53 num_levels)
        self.max_allowed_level = pin.get_or_add_integer(
            "mesh_refinement", "num_levels", 1) - 1 \
            if (self.adaptive or self.multilevel) else 0

        if self.multilevel or self.adaptive:
            if ng % 2 != 0:
                raise ValueError("SMR/AMR requires an even nghost")
            for mb, act in ((mbnx1, True), (mbnx2, nx2 > 1),
                            (mbnx3, nx3 > 1)):
                if act and mb % 2 != 0:
                    raise ValueError("SMR/AMR requires even meshblock extents")
            self._build_blocks_ml(leaves)
            # adaptive meshes take the uniform fast path while the tree is
            # still flat; the AMR rebuild re-evaluates this per tree update
            self.multilevel = self.max_level > 0
            # fixed-capacity block pool (amr_pool.py): trace the general
            # mixed-level cycle once so tree updates never recompile —
            # the reference's nmb_maxperrank design (mesh.hpp:121)
            self.amr_pool = False
            if self.adaptive:
                from .amr_pool import supports_pool
                self.amr_pool = pin.get_or_add_boolean(
                    "mesh_refinement", "block_pool", supports_pool(pin))
                if self.amr_pool:
                    self.multilevel = True
        else:
            self._build_blocks()
            self.mb_lev = np.zeros(self.nmb_total, dtype=np.int64)
            self.ml = None
            self.amr_pool = False

        # per-block cost for device load balancing (reference:
        # build_tree.cpp:236-258 cost_eachmb; weighted by
        # <mesh>/lb_level_cost^level when set, else uniform like the
        # reference default)
        lb_base = pin.get_or_add_real("mesh", "lb_level_cost", 1.0)
        self.cost_eachmb = np.asarray(
            lb_base ** self.mb_lev.astype(np.float64), dtype=np.float32) \
            if lb_base != 1.0 else np.ones(self.nmb_total, dtype=np.float32)

        # time/cycle state (host mirrors; device copies live in the State)
        self.time = 0.0
        self.dt = float(np.finfo(np.float32).max)
        self.dtold = 0.0
        self.ncycle = 0
        self.cfl_no = pin.get_or_add_real("time", "cfl_number", 0.8) \
            if pin.does_block_exist("time") else 0.8

    # ------------------------------------------------------------------
    def _build_blocks(self) -> None:
        """Create Z-ordered block list, per-block extents, neighbor tables."""
        n1, n2, n3 = self.nmb_x1, self.nmb_x2, self.nmb_x3
        nbits = max(1, max(n1 - 1, n2 - 1, n3 - 1).bit_length())

        # Z-order (Morton) sort of block logical locations, matching the
        # reference tree traversal order (reference: src/mesh/build_tree.cpp:242)
        locs = [(lx1, lx2, lx3)
                for lx3 in range(n3) for lx2 in range(n2) for lx1 in range(n1)]
        locs.sort(key=lambda t: _interleave_bits3(t[0], t[1], t[2], nbits))
        self.lloc_eachmb = np.array(locs, dtype=np.int64)  # [nmb, 3]

        # map (lx1,lx2,lx3) -> gid
        self._loc2gid: Dict[Tuple[int, int, int], int] = {
            tuple(loc): gid for gid, loc in enumerate(locs)}

        ms = self.mesh_size
        mb1 = self.mb_indcs.nx1 * ms.dx1
        mb2 = self.mb_indcs.nx2 * ms.dx2
        mb3 = self.mb_indcs.nx3 * ms.dx3
        nmb = self.nmb_total
        self.mb_size = {
            "x1min": np.array([ms.x1min + loc[0] * mb1 for loc in locs]),
            "x1max": np.array([ms.x1min + (loc[0] + 1) * mb1 for loc in locs]),
            "x2min": np.array([ms.x2min + loc[1] * mb2 for loc in locs]),
            "x2max": np.array([ms.x2min + (loc[1] + 1) * mb2 for loc in locs]),
            "x3min": np.array([ms.x3min + loc[2] * mb3 for loc in locs]),
            "x3max": np.array([ms.x3min + (loc[2] + 1) * mb3 for loc in locs]),
            "dx1": np.full(nmb, ms.dx1),
            "dx2": np.full(nmb, ms.dx2),
            "dx3": np.full(nmb, ms.dx3),
        }

        # Face-neighbor gather tables.  nbr[d][s] is an int array [nmb]: the
        # gid whose interior supplies this block's ghost zones on side s of
        # axis d.  Blocks on a non-periodic physical boundary point at
        # themselves; the physical-BC pass overwrites those ghosts afterwards
        # (mask arrays below say which blocks those are).
        self.nbr_gid: Dict[str, np.ndarray] = {}
        self.phys_bc_mask: Dict[str, np.ndarray] = {}
        # always-wrapped (torus) neighbor maps: a bijection on gids per
        # (axis, side), used by the explicit shard_map halo exchange where
        # a permutation (not a gather) is required.  On non-periodic faces
        # the wrapped donor's data is garbage but the physical-BC pass
        # overwrites those ghosts, exactly as with the self-pointer.
        self.nbr_gid_wrap: Dict[str, np.ndarray] = {}
        axes = (("x1", 0, n1), ("x2", 1, n2), ("x3", 2, n3))
        for name, ax, nax in axes:
            for side, delta in (("m", -1), ("p", +1)):
                key = f"{name}{side}"
                flag = self.mesh_bcs[f"i{name}" if side == "m"
                                     else f"o{name}"]
                # shear_periodic gathers from the wraparound donor like
                # periodic, but stays flagged so the y-remap can find the
                # boundary blocks (reference: shear-periodic uses its own
                # comm path, src/shearing_box/shearing_box_cc.cpp)
                wraps = flag in ("periodic", "shear_periodic")
                gids = np.empty(nmb, dtype=np.int32)
                wgids = np.empty(nmb, dtype=np.int32)
                mask = np.zeros(nmb, dtype=bool)
                for gid, loc in enumerate(locs):
                    tgt = list(loc)
                    tgt[ax] += delta
                    wtgt = list(loc)
                    wtgt[ax] = (loc[ax] + delta) % nax
                    wgids[gid] = self._loc2gid[tuple(wtgt)]
                    if 0 <= tgt[ax] < nax:
                        gids[gid] = self._loc2gid[tuple(tgt)]
                    else:
                        if wraps:
                            tgt[ax] %= nax
                            gids[gid] = self._loc2gid[tuple(tgt)]
                        else:
                            gids[gid] = gid
                        mask[gid] = (flag != "periodic")
                self.nbr_gid[key] = gids
                self.nbr_gid_wrap[key] = wgids
                self.phys_bc_mask[key] = mask

    # ------------------------------------------------------------------
    def _build_blocks_ml(self, leaves=None) -> None:
        """Refined tree: leaves, per-block (level-dependent) extents, and
        mixed-level donor tables (reference: build_tree.cpp:62-229 + bvals
        neighbor enumeration).  ``leaves`` overrides tree construction
        (AMR rebuild path)."""
        from .refinement import build_ml_tables, build_static_tree

        ms = self.mesh_size
        active = (True, self.mesh_indcs.nx2 > 1, self.mesh_indcs.nx3 > 1)
        nrbx = (self.nmb_x1, self.nmb_x2, self.nmb_x3)
        domain = (ms.x1min, ms.x1max, ms.x2min, ms.x2max,
                  ms.x3min, ms.x3max)
        self.tree_active = active
        self.tree_nrbx = nrbx
        if leaves is None:
            has_regions = any(b.startswith("refined_region")
                              for b in self.pin.blocks)
            if has_regions:
                leaves = build_static_tree(self.pin, nrbx, active, domain)
            elif self.adaptive:
                # adaptive runs may start from the flat root tree
                # (reference: the AMR tests refine from criteria alone)
                locs = [(l1, l2, l3)
                        for l3 in range(nrbx[2]) for l2 in range(nrbx[1])
                        for l1 in range(nrbx[0])]
                nbits = max(1, (max(nrbx) - 1).bit_length())
                locs.sort(key=lambda t: _interleave_bits3(*t, nbits))
                leaves = [(l1, l2, l3, 0) for (l1, l2, l3) in locs]
            else:
                leaves = build_static_tree(self.pin, nrbx, active, domain)
        self.leaves = list(leaves)
        self.nmb_total = len(leaves)
        self.lloc_eachmb = np.array([[l1, l2, l3] for l1, l2, l3, _ in
                                     leaves], dtype=np.int64)
        self.mb_lev = np.array([lev for _, _, _, lev in leaves],
                               dtype=np.int64)
        self.max_level = int(self.mb_lev.max())
        self._loc2gid = {(l1, l2, l3): gid
                         for gid, (l1, l2, l3, _) in enumerate(leaves)}

        two = 2.0 ** self.mb_lev
        one = np.ones_like(two)
        w1 = (ms.x1max - ms.x1min) / (nrbx[0] * two)
        w2 = (ms.x2max - ms.x2min) / (nrbx[1] * (two if active[1] else one))
        w3 = (ms.x3max - ms.x3min) / (nrbx[2] * (two if active[2] else one))
        l1 = self.lloc_eachmb[:, 0]
        l2 = self.lloc_eachmb[:, 1]
        l3 = self.lloc_eachmb[:, 2]
        self.mb_size = {
            "x1min": ms.x1min + l1 * w1, "x1max": ms.x1min + (l1 + 1) * w1,
            "x2min": ms.x2min + l2 * w2, "x2max": ms.x2min + (l2 + 1) * w2,
            "x3min": ms.x3min + l3 * w3, "x3max": ms.x3min + (l3 + 1) * w3,
            "dx1": w1 / self.mb_indcs.nx1,
            "dx2": w2 / self.mb_indcs.nx2,
            "dx3": w3 / self.mb_indcs.nx3,
        }

        wraps = {ax: self.mesh_bcs[f"i{ax}"] in ("periodic", "shear_periodic")
                 for ax in ("x1", "x2", "x3")}
        self.ml = build_ml_tables(leaves, nrbx, active, wraps)
        face_keys = [k for k, v in self.ml.items()
                     if isinstance(v, dict) and "same" in v]
        self.nbr_gid = {k: self.ml[k]["same"] for k in face_keys}
        self.phys_bc_mask = {k: self.ml[k]["phys"] for k in face_keys}
        # shear_periodic x1: the ml tables wrap like periodic (the ghost
        # fill uses the wraparound donors), but the boundary blocks must
        # stay FLAGGED so the sheared y-remap can find and overwrite
        # them — same convention as the uniform path above (reference:
        # shear-periodic runs its own comm pass after the periodic fill,
        # src/shearing_box/shearing_box_cc.cpp:63-140)
        if self.mesh_bcs.get("ix1") == "shear_periodic":
            nrbx1 = self.tree_nrbx[0]
            for side in ("m", "p"):
                mask = np.array(self.phys_bc_mask[f"x1{side}"],
                                dtype=bool, copy=True)
                for g, l in enumerate(self.lloc_eachmb):
                    lev = int(self.mb_lev[g])
                    edge = 0 if side == "m" else (nrbx1 << lev) - 1
                    if int(l[0]) == edge:
                        mask[g] = True
                self.phys_bc_mask[f"x1{side}"] = mask

    # ------------------------------------------------------------------
    def cell_centers(self, gid: int):
        """Cell-center coordinate arrays (active + ghost cells) for block gid.

        Uses the symmetrized linear map of the reference ``CellCenterX``
        (reference: src/coordinates/cell_locations.hpp:36-40) so roundoff
        matches bit-for-bit.
        """
        mbi = self.mb_indcs

        def centers(n, ncells, istart, xmin, xmax):
            ith = np.arange(ncells, dtype=np.float64) - istart
            x = (ith + 0.5) / n
            return (x * xmax - x * xmin) - (0.5 * xmax - 0.5 * xmin) \
                + (0.5 * xmin + 0.5 * xmax)

        x1v = centers(mbi.nx1, mbi.ncells1, mbi.is_,
                      self.mb_size["x1min"][gid], self.mb_size["x1max"][gid])
        x2v = centers(mbi.nx2, mbi.ncells2, mbi.js,
                      self.mb_size["x2min"][gid], self.mb_size["x2max"][gid])
        x3v = centers(mbi.nx3, mbi.ncells3, mbi.ks,
                      self.mb_size["x3min"][gid], self.mb_size["x3max"][gid])
        return x1v, x2v, x3v

    def face_edges(self, gid: int):
        """Left-edge coordinate arrays (reference ``LeftEdgeX``)."""
        mbi = self.mb_indcs

        def edges(n, ncells, istart, xmin, xmax):
            ith = np.arange(ncells + 1, dtype=np.float64) - istart
            x = ith / n
            return (x * xmax - x * xmin) - (0.5 * xmax - 0.5 * xmin) \
                + (0.5 * xmin + 0.5 * xmax)

        x1f = edges(mbi.nx1, mbi.ncells1, mbi.is_,
                    self.mb_size["x1min"][gid], self.mb_size["x1max"][gid])
        x2f = edges(mbi.nx2, mbi.ncells2, mbi.js,
                    self.mb_size["x2min"][gid], self.mb_size["x2max"][gid])
        x3f = edges(mbi.nx3, mbi.ncells3, mbi.ks,
                    self.mb_size["x3min"][gid], self.mb_size["x3max"][gid])
        return x1f, x2f, x3f
