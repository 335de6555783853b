"""Block coalescing: run a uniform multi-block mesh as one superblock.

The reference batches MeshBlocks into a MeshBlockPack so one kernel
launch covers every block on a rank (reference:
src/mesh/meshblock_pack.hpp:44-97).  Here the analogous — and
stronger — transform is to *physically merge* the blocks: a uniform
mesh on one device is globally contiguous, so the `[nmb, ...]` block
pool can be repacked into a single `[1, ...]` superblock whose interior
is the whole domain.  Halo traffic between co-resident blocks
disappears entirely (interior cells are their own neighbors) and the
minor axis grows to the whole domain's x1 extent.

The transform is exact: the same finite-volume stencils run on the same
global cell values, so a coalesced run bit-matches the block-wise run
(verified in tests/test_coalesce.py).

Blocks remain the unit of distribution and refinement: coalescing
applies only to single-device, single-level, non-adaptive meshes with
no per-block user callbacks; everything else keeps the block pool.

Partial coalescing ("pencil packing"): merging blocks along x1 ONLY
(factors (1, 1, nbx1)) re-blocks the pool into x1-pencils whose lane
extent is nbx1*nx1 + 2*ng — e.g. the 8 x 62^3 pool becomes 4 blocks of
66 x 66 x 128, so the minor axis fills whole 128-element tiles while the
pool ghost-exchange machinery still runs between pencils in x2/x3.  The
128-element tile is a constraint of the earlier target hardware, not
of the GPU; whether either transform pays on the GPU is not measured
yet.  The transform is the same exact re-blocking, so results
bit-match the unpacked pool.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class Coalescer:
    """Pack/unpack between the block pool and a coarser re-blocking.

    ``factors`` = (f3, f2, f1) blocks merged per superblock along each
    axis; default merges everything into one superblock.
    """

    def __init__(self, pin, mesh, phys,
                 factors: Optional[Tuple[int, int, int]] = None) -> None:
        from ..athinput import ParameterInput
        from ..bvals import BoundaryValues
        from ..main import make_physics
        from ..mesh import Mesh

        self.mesh = mesh
        pin2 = ParameterInput.from_string(pin.dump())
        ms = mesh.mesh_indcs
        mbi = mesh.mb_indcs
        nb = (ms.nx3 // mbi.nx3 if ms.nx3 > 1 else 1,
              ms.nx2 // mbi.nx2 if ms.nx2 > 1 else 1,
              ms.nx1 // mbi.nx1)
        if factors is None:
            factors = nb
        if any(nb[d] % factors[d] for d in range(3)):
            raise ValueError(f"factors {factors} do not divide the "
                             f"block grid {nb}")
        self.factors = factors
        pin2.set_value("meshblock", "nx1", mbi.nx1 * factors[2])
        if ms.nx2 > 1:
            pin2.set_value("meshblock", "nx2", mbi.nx2 * factors[1])
        if ms.nx3 > 1:
            pin2.set_value("meshblock", "nx3", mbi.nx3 * factors[0])
        self.mesh2 = Mesh(pin2)
        bvals2 = BoundaryValues(self.mesh2)
        self.phys2 = make_physics(pin2, self.mesh2, bvals2)
        # block-independent pgen state carried over
        bvals2.inflow_state = dict(phys.bvals.inflow_state)

        self.ng = mbi.ng
        self.nx = (mbi.nx3, mbi.nx2, mbi.nx1)
        self.ncell = (mbi.ncells3, mbi.ncells2, mbi.ncells1)
        # collapsed dimensions carry no ghost zones
        self.ngs = tuple(self.ng if self.nx[d] > 1 else 0
                         for d in range(3))
        sup = self.mesh2.mb_indcs
        self.sup_ncell = (sup.ncells3, sup.ncells2, sup.ncells1)
        # per-block destination superblock + interior offsets within it
        loc = mesh.lloc_eachmb          # columns (lx1, lx2, lx3)
        f3, f2, f1 = factors
        loc2 = mesh.lloc_eachmb.copy()
        loc2[:, 0] //= f1
        loc2[:, 1] //= f2
        loc2[:, 2] //= f3
        gid2 = {tuple(ll[:3]): g
                for g, ll in enumerate(self.mesh2.lloc_eachmb)}
        self.dst = np.asarray([gid2[tuple(ll[:3])] for ll in loc2],
                              dtype=np.int64)
        self.offs = np.stack([(loc[:, 2] % f3) * mbi.nx3,
                              (loc[:, 1] % f2) * mbi.nx2,
                              (loc[:, 0] % f1) * mbi.nx1], axis=1)

    # ------------------------------------------------------------------
    def _leaf_axes(self, shape):
        """Classify the trailing 3 dims of a [nmb, ..., c3, c2, c1] leaf:
        returns per-axis 'c' (cell), 'f' (face, +1 extent) or None if the
        leaf is not a block-pool field array."""
        if len(shape) < 4 or shape[0] != self.mesh.nmb_total:
            return None
        kinds = []
        for d in range(3):
            n = shape[-3 + d]
            if n == self.ncell[d]:
                kinds.append("c")
            elif n == self.ncell[d] + 1:
                kinds.append("f")
            else:
                return None
        return kinds

    def _pack_leaf(self, a):
        kinds = self._leaf_axes(a.shape)
        if kinds is None:
            return a
        ngs = self.ngs
        out_shape = (self.mesh2.nmb_total,) + a.shape[1:-3] + tuple(
            self.sup_ncell[d] + (1 if kinds[d] == "f" else 0)
            for d in range(3))
        out = jnp.zeros(out_shape, a.dtype)
        for g in range(self.mesh.nmb_total):
            src = [g, ...] + [
                slice(ngs[d],
                      ngs[d] + self.nx[d] + (1 if kinds[d] == "f" else 0))
                for d in range(3)]
            o = self.offs[g]
            dst = [int(self.dst[g]), ...] + [
                slice(ngs[d] + int(o[d]),
                      ngs[d] + int(o[d]) + self.nx[d]
                      + (1 if kinds[d] == "f" else 0))
                for d in range(3)]
            out = out.at[tuple(dst)].set(a[tuple(src)])
        return out

    def _unpack_leaf(self, a):
        # superblock leaf -> block pool; ghost zones come for free from
        # the adjacent interior (or the superblock's own filled ghosts)
        kinds = None
        if a.ndim >= 4 and a.shape[0] == self.mesh2.nmb_total:
            kinds = []
            for d in range(3):
                n = a.shape[-3 + d]
                if n == self.sup_ncell[d]:
                    kinds.append("c")
                elif n == self.sup_ncell[d] + 1:
                    kinds.append("f")
                else:
                    kinds = None
                    break
        if kinds is None:
            return a
        blocks = []
        for g in range(self.mesh.nmb_total):
            o = self.offs[g]
            idx = [int(self.dst[g]), ...] + [
                slice(int(o[d]),
                      int(o[d]) + self.ncell[d]
                      + (1 if kinds[d] == "f" else 0))
                for d in range(3)]
            blocks.append(a[tuple(idx)])
        return jnp.stack(blocks, axis=0)

    # ------------------------------------------------------------------
    def pack(self, state):
        return jax.tree_util.tree_map(self._pack_leaf, state)

    def unpack(self, state):
        return jax.tree_util.tree_map(self._unpack_leaf, state)


def maybe_coalesce(pin, mesh, phys, dmesh=None,
                   pencil: bool = False) -> Optional[Coalescer]:
    """Build a Coalescer when the configuration allows exact merging.

    ``pencil``: merge along x1 only (lane packing for the block pool);
    returns None when that would degenerate to a full coalesce (i.e.
    the mesh is multi-block only along x1) so a user's coalesce=false
    keeps meaning "no single superblock".
    """
    if pin is None or dmesh is not None:
        return None
    if mesh.nmb_total <= 1:
        return None
    if getattr(mesh, "multilevel", False) or getattr(mesh, "adaptive",
                                                    False):
        return None
    if type(phys).__name__ not in ("Hydro", "MHD"):
        # Z4c/DynGRMHD/Radiation/IonNeutral carry per-block module
        # tables (wave-extraction spheres, tetrads, two-fluid pairing)
        # that the superblock repack does not rewrite
        return None
    if getattr(phys, "ppart", None) is not None:
        return None
    bv = getattr(phys, "bvals", None)
    if bv is None or bv.user_bc_func is not None:
        return None
    if getattr(phys, "srcterms_func", None) is not None:
        return None
    if getattr(phys, "user_refine_func", None) is not None:
        return None
    # shear-periodic BCs key block lookups off the original block grid
    if any(f == "shear_periodic" for f in mesh.mesh_bcs.values()):
        return None
    factors = None
    if pencil:
        ms = mesh.mesh_indcs
        mbi = mesh.mb_indcs
        nbx1 = ms.nx1 // mbi.nx1
        nb_yz = ((ms.nx2 // mbi.nx2 if ms.nx2 > 1 else 1)
                 * (ms.nx3 // mbi.nx3 if ms.nx3 > 1 else 1))
        if nbx1 <= 1 or nb_yz <= 1:
            return None     # nothing to pack / would be a full coalesce
        # only pack when it improves tiling of the minor axis by 128
        pad = -(-mbi.ncells1 // 128) * 128
        pad2 = -(-(nbx1 * mbi.nx1 + 2 * mbi.ng) // 128) * 128
        if pad2 * mbi.ncells1 >= pad * (nbx1 * mbi.nx1 + 2 * mbi.ng):
            return None     # per-cell lane waste would not shrink
        factors = (1, 1, nbx1)
    try:
        return Coalescer(pin, mesh, phys, factors=factors)
    except Exception:
        return None
