"""Multigrid Poisson solver for self-gravity.

Parity target: the reference FAS multigrid driver
(reference: src/multigrid/multigrid_driver.cpp:129-567, 731-860;
src/gravity/mg_gravity.cpp).  Same <gravity> parameter surface
(threshold / niteration / npresmooth / npostsmooth / omega /
full_multigrid / fmg_ncycle / show_defect / subtract_average) and the
same volume-weighted L2 defect norm and stdout format
("MG initial defect = ...", "MG iteration N: defect = ...",
multigrid_driver.cpp:788-860).

Design — two dense-array regimes instead of the reference's
per-block octet machinery:

  * **Global levels**: the root grid and everything below it, assembled
    into one dense array (Z-order block permutation); standard geometric
    multigrid with red-black SOR on global arrays down to ~2 cells/dim.
    A uniform mesh solves entirely here.
  * **Box levels** for SMR meshes (FAS/MLAT): each refinement level l>0
    becomes ONE dense array over the bounding box of the cells covered
    by leaves of level >= l, with a static active mask and a 1-cell
    Dirichlet border interpolated from the coarser level.  Smoothing,
    residuals and level transfers are masked elementwise ops — no block
    bookkeeping, no ragged gathers, tiny XLA traces.  This is the
    MLAT form of the reference's octet levels (multigrid.hpp:77-96).

The solve is jittable end-to-end: threshold mode runs a
``lax.while_loop`` over V-cycles; fixed ``niteration`` unrolls.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from jax import lax



def _repeat(n, fn, x):
    """Apply ``fn`` n times via fori_loop (one trace of fn, not n)."""
    if n <= 0:
        return x
    if n == 1:
        return fn(x)
    return lax.fori_loop(0, n, lambda i, v: fn(v), x)

class _BoxLevel:
    """One refinement level as a dense masked box.

    Host data (all numpy / static):
      lo:     global level-l cell index of box cell (0,0,0), (z,y,x)
      shape:  box shape (z,y,x) including the 1-cell border ring
      active: bool mask of cells covered by leaves of level >= l
      owned:  bool mask of cells owned by level-l leaves exactly
      dxs:    (d3, d2, d1) cell sizes at this level
      leaf_gids / leaf_off: per level-l leaf, block gid and the (z,y,x)
              offset of its first interior cell inside the box
    """

    def __init__(self, mesh, lev, active_dims):
        mbi = mesh.mb_indcs
        self.lev = lev
        self.adim = active_dims
        nx = (mbi.nx3, mbi.nx2, mbi.nx1)
        # leaf cell-extents at level lev (global index space of level lev)
        cells = []
        gids = []
        for gid, (l1, l2, l3, lv) in enumerate(mesh.leaves):
            if lv < lev:
                continue
            # project the leaf's region to level-`lev` cells
            f = 2 ** (lv - lev)
            lo = np.array([l3 * nx[0], l2 * nx[1], l1 * nx[2]])
            sz = np.array([nx[0], nx[1], nx[2]])
            lo_p = lo // np.array([f if active_dims[2] else 1,
                                   f if active_dims[1] else 1, f])
            sz_p = np.maximum(sz // np.array(
                [f if active_dims[2] else 1,
                 f if active_dims[1] else 1, f]), 1)
            cells.append((lo_p, lo_p + sz_p, lv == lev, gid, lo, sz))
            if lv == lev:
                gids.append(gid)
        los = np.array([c[0] for c in cells])
        his = np.array([c[1] for c in cells])
        bb_lo = los.min(axis=0)
        bb_hi = his.max(axis=0)
        g = np.array([1 if active_dims[2] else 0,
                      1 if active_dims[1] else 0, 1])
        self.lo = bb_lo - g          # border ring
        self.shape = tuple(bb_hi - bb_lo + 2 * g)
        self.active = np.zeros(self.shape, dtype=bool)
        self.owned = np.zeros(self.shape, dtype=bool)
        for lo_p, hi_p, is_own, gid, _, _ in cells:
            sl = tuple(slice(int(a - o), int(b - o))
                       for a, b, o in zip(lo_p, hi_p, self.lo))
            self.active[sl] = True
            if is_own:
                self.owned[sl] = True
        # border = ring around active (6-neighborhood dilation)
        dil = np.zeros_like(self.active)
        ax_list = [2] + ([1] if active_dims[1] else []) \
            + ([0] if active_dims[2] else [])
        for ax in ax_list:
            dil |= np.roll(self.active, 1, axis=ax)
            dil |= np.roll(self.active, -1, axis=ax)
        self.border = dil & ~self.active

        ms = mesh.mesh_size
        gi = mesh.mesh_indcs
        f = 2 ** lev
        self.dxs = ((ms.x3max - ms.x3min) / (max(gi.nx3, 1)
                                             * (f if active_dims[2] else 1)),
                    (ms.x2max - ms.x2min) / (max(gi.nx2, 1)
                                             * (f if active_dims[1] else 1)),
                    (ms.x1max - ms.x1min) / (gi.nx1 * f))
        # red-black parity aligned to the global level grid
        kk, jj, ii = np.meshgrid(*[np.arange(s) for s in self.shape],
                                 indexing="ij")
        gk = kk + self.lo[0]
        gj = jj + self.lo[1]
        gi_ = ii + self.lo[2]
        self.red = ((gi_ + (gj if active_dims[1] else 0)
                     + (gk if active_dims[2] else 0)) % 2 == 0)

        # per level-l leaf: offset of its interior in the box
        self.leaf_gids = np.array(gids, dtype=np.int64)
        offs = []
        for lo_p, hi_p, is_own, gid, _, _ in cells:
            if is_own:
                offs.append(lo_p - self.lo)
        self.leaf_off = np.array(offs, dtype=np.int64) \
            if offs else np.zeros((0, 3), dtype=np.int64)
        self.nx = nx


class MGPoisson:
    """Multigrid Poisson solver: lap(phi) = four_pi_G * (rho - <rho>).

    Duck-types gravity.SelfGravity: ``solve(u, bvals) -> phi`` with
    ghosts filled (reference: MGGravityDriver::Solve per RK stage,
    driver.cpp:406-408).
    """

    def __init__(self, pin, mesh) -> None:
        self.mesh = mesh
        self.pin = pin
        self.four_pi_G = pin.get_or_add_real("gravity", "four_pi_G", -1.0)
        if self.four_pi_G <= 0.0:
            raise ValueError("gravity/four_pi_G must be set")
        self.omega = pin.get_or_add_real("gravity", "omega", 1.15)
        self.eps = pin.get_or_add_real("gravity", "threshold", -1.0)
        self.niter = pin.get_or_add_integer("gravity", "niteration", -1)
        self.npre = int(pin.get_or_add_real("gravity", "npresmooth", 1))
        self.npost = int(pin.get_or_add_real("gravity", "npostsmooth", 1))
        self.fmg = pin.get_or_add_boolean("gravity", "full_multigrid",
                                          False)
        self.fmg_ncycle = pin.get_or_add_integer("gravity", "fmg_ncycle", 1)
        self.show_defect = pin.get_or_add_integer("gravity",
                                                  "show_defect", 0)
        self.subtract_average = pin.get_or_add_boolean(
            "gravity", "subtract_average", True)
        self.nbottom = pin.get_or_add_integer("gravity",
                                              "bottom_smooth", 30)
        if self.eps < 0.0 and self.niter < 0:
            raise ValueError("Either gravity/threshold or "
                             "gravity/niteration must be set "
                             "(reference: mg_gravity.cpp:52-59)")
        # isolated boundary conditions (reference: mg_gravity.cpp:68-121,
        # multigrid_driver.cpp:1827-2120 multipole/zerofixed/zerograd):
        # mg_bc applies to every non-periodic mesh face; periodic faces
        # stay periodic.
        self.periodic = all(v == "periodic" for v in mesh.mesh_bcs.values())
        mg_bc = pin.get_or_add_string("gravity", "mg_bc", "none")
        if mg_bc not in ("none", "zerofixed", "zerograd", "multipole"):
            raise ValueError(f"gravity/mg_bc = '{mg_bc}' unknown "
                             "(none/zerofixed/zerograd/multipole)")
        if mg_bc == "none" and not self.periodic:
            raise NotImplementedError(
                "multigrid gravity on non-periodic meshes requires "
                "gravity/mg_bc = zerofixed | zerograd | multipole "
                "(reference: mg_gravity.cpp:68-88)")
        # per-axis (lo, hi) BC flags in array-axis order (x3, x2, x1)
        def _flag(face):
            bc = mesh.mesh_bcs.get(face, "periodic")
            return "periodic" if bc == "periodic" else mg_bc
        self.mg_bc = mg_bc
        self.bc_flags = ((_flag("ix3"), _flag("ox3")),
                         (_flag("ix2"), _flag("ox2")),
                         (_flag("ix1"), _flag("ox1")))
        self.isolated = any(f != "periodic" for lh in self.bc_flags
                            for f in lh)
        self.mporder = 0
        self._mp = None
        if mg_bc == "multipole":
            if not (mesh.mesh_indcs.nx2 > 1 and mesh.mesh_indcs.nx3 > 1):
                raise ValueError("gravity/mg_bc = multipole requires a "
                                 "3D mesh")
            self.mporder = pin.get_or_add_integer("gravity", "mporder", 4)
            if self.mporder not in (2, 4):
                raise ValueError("gravity/mporder must be 2 or 4")
            self.autompo = pin.get_or_add_boolean(
                "gravity", "auto_mporigin", True)
            self.nodipole = pin.get_or_add_boolean(
                "gravity", "nodipole", False)
            if self.autompo and self.nodipole:
                raise ValueError("auto_mporigin and nodipole cannot be "
                                 "used together")
            if not self.autompo:
                self.mpo = (pin.get_real("gravity", "mporigin_x1"),
                            pin.get_real("gravity", "mporigin_x2"),
                            pin.get_real("gravity", "mporigin_x3"))
        if self.isolated:
            # the isolated problem is non-singular: never shift the mean
            self.subtract_average = False

        # source masking: zero the Poisson source outside mask_radius
        # (reference: Multigrid::ApplyMask, multigrid.cpp:355-385 +
        # mg_gravity.cpp:123-126 — keeps outflow-boundary inflow from
        # polluting the multipole source in collapse runs)
        self.mask_radius = pin.get_or_add_real("gravity",
                                               "mask_radius", -1.0)
        self.mask_origin = (
            pin.get_or_add_real("gravity", "mask_origin_x1", 0.0),
            pin.get_or_add_real("gravity", "mask_origin_x2", 0.0),
            pin.get_or_add_real("gravity", "mask_origin_x3", 0.0))

        ms = mesh.mesh_size
        self.total_vol = ((ms.x1max - ms.x1min) * (ms.x2max - ms.x2min)
                          * (ms.x3max - ms.x3min))
        gi = mesh.mesh_indcs
        mbi = mesh.mb_indcs
        self.active = [True, gi.nx2 > 1, gi.nx3 > 1]
        self.act_in = (slice(mbi.ks, mbi.ke + 1),
                       slice(mbi.js, mbi.je + 1),
                       slice(mbi.is_, mbi.ie + 1))
        self._nxb = (mbi.nx3, mbi.nx2, mbi.nx1)

        # --- box levels 1..max_level (SMR), each a masked dense array
        self.boxes: List[_BoxLevel] = []
        max_level = int(getattr(mesh, "max_level", 0))
        if max_level > 0:
            for lev in range(1, max_level + 1):
                bl = _BoxLevel(mesh, lev, self.active)
                if bl.border.any():
                    # border cells must be interior to the domain (a
                    # refined region touching a periodic boundary would
                    # need wrap-around border interpolation)
                    k0, j0, i0 = bl.lo
                    ksz = np.array(bl.shape)
                    glob = np.array([max(gi.nx3, 1), max(gi.nx2, 1),
                                     gi.nx1]) * 2 ** lev
                    if (np.any(bl.lo < 0)
                            or np.any(bl.lo + ksz > glob)):
                        raise NotImplementedError(
                            "refined region touches the domain boundary "
                            "(periodic box-border wrap not implemented)")
                self.boxes.append(bl)

        # root-level leaves (level 0) scatter/gather maps
        self.root_gids = np.array(
            [g for g, (_, _, _, lv) in enumerate(mesh.leaves)
             if lv == 0], dtype=np.int64) \
            if getattr(mesh, "leaves", None) is not None \
            else np.arange(mesh.nmb_total)
        if getattr(mesh, "leaves", None) is not None:
            self.root_off = np.array(
                [(l3 * mbi.nx3, l2 * mbi.nx2, l1 * mbi.nx1)
                 for (l1, l2, l3, lv) in mesh.leaves if lv == 0],
                dtype=np.int64)
        else:
            self.root_off = np.array(
                [(int(l[2]) * mbi.nx3, int(l[1]) * mbi.nx2,
                  int(l[0]) * mbi.nx1) for l in mesh.lloc_eachmb],
                dtype=np.int64)

        # --- global levels: root resolution downward
        n1, n2, n3 = gi.nx1, max(gi.nx2, 1), max(gi.nx3, 1)
        d1 = (ms.x1max - ms.x1min) / n1
        d2 = (ms.x2max - ms.x2min) / n2
        d3 = (ms.x3max - ms.x3min) / n3

        def can_halve(n1, n2, n3):
            dims = [n1] + ([n2] if self.active[1] else []) \
                + ([n3] if self.active[2] else [])
            return all(d % 2 == 0 and d > 2 for d in dims)

        self.glevels = []  # list of (shape(z,y,x), (d3,d2,d1))
        while True:
            self.glevels.append(((n3, n2, n1), (d3, d2, d1)))
            if not can_halve(n1, n2, n3):
                break
            n1 //= 2
            d1 *= 2.0
            if self.active[1]:
                n2 //= 2
                d2 *= 2.0
            if self.active[2]:
                n3 //= 2
                d3 *= 2.0

    # ------------------------------------------------------------------
    # dense-array primitives (shared by box and global levels)
    # ------------------------------------------------------------------
    def _axes(self):
        return [2] + ([1] if self.active[1] else []) \
            + ([0] if self.active[2] else [])

    def _nbrs(self, g, ax, gi=None, homog=False):
        """(left, right) neighbor arrays along ``ax``; on isolated
        global levels the wrap values are replaced by boundary ghosts
        (reference: ApplyPhysicalBoundaries, multigrid_driver.cpp:
        1732-2030): zerofixed ghost = -interior, zerograd = +interior,
        multipole = 2*phi_mp(face) - interior.  ``homog`` selects the
        homogeneous variant (corrections): multipole -> zerofixed."""
        gm = jnp.roll(g, 1, ax)
        gp = jnp.roll(g, -1, ax)
        if gi is None or not self.isolated:
            return gm, gp
        lo, hi = self.bc_flags[ax]
        n = g.shape[ax]

        def ghost(side, flag):
            edge = jax.lax.slice_in_dim(g, 0, 1, axis=ax) if side == 0 \
                else jax.lax.slice_in_dim(g, n - 1, n, axis=ax)
            if flag == "zerograd":
                return edge
            if flag == "multipole" and not homog and self._mp is not None:
                return 2.0 * self._mp[gi][(ax, side)] - edge
            return -edge        # zerofixed / homogeneous multipole

        if lo != "periodic":
            gm = jnp.concatenate(
                [ghost(0, lo), jax.lax.slice_in_dim(g, 0, n - 1, axis=ax)],
                axis=ax)
        if hi != "periodic":
            gp = jnp.concatenate(
                [jax.lax.slice_in_dim(g, 1, n, axis=ax), ghost(1, hi)],
                axis=ax)
        return gm, gp

    def _lap(self, g, dxs, gi=None):
        gm, gp = self._nbrs(g, 2, gi)
        out = (gm - 2.0 * g + gp) / dxs[2] ** 2
        if self.active[1]:
            gm, gp = self._nbrs(g, 1, gi)
            out = out + (gm - 2.0 * g + gp) / dxs[1] ** 2
        if self.active[2]:
            gm, gp = self._nbrs(g, 0, gi)
            out = out + (gm - 2.0 * g + gp) / dxs[0] ** 2
        return out

    def _diag(self, dxs):
        d = 2.0 / dxs[2] ** 2
        if self.active[1]:
            d = d + 2.0 / dxs[1] ** 2
        if self.active[2]:
            d = d + 2.0 / dxs[0] ** 2
        return d

    def _smooth(self, g, rhs, dxs, red, omega, update_mask=None,
                gi=None):
        diag = self._diag(dxs)
        for color in (True, False):
            gm, gp = self._nbrs(g, 2, gi)
            num = (gm + gp) / dxs[2] ** 2
            if self.active[1]:
                gm, gp = self._nbrs(g, 1, gi)
                num = num + (gm + gp) / dxs[1] ** 2
            if self.active[2]:
                gm, gp = self._nbrs(g, 0, gi)
                num = num + (gm + gp) / dxs[0] ** 2
            gs = (num - rhs) / diag
            mask = red if color else ~red
            if update_mask is not None:
                mask = mask & update_mask
            g = jnp.where(mask, g + omega * (gs - g), g)
        return g

    def _restrict(self, g):
        if self.active[2]:
            g = g.reshape(g.shape[0] // 2, 2, g.shape[1],
                          g.shape[2]).mean(axis=1)
        if self.active[1]:
            g = g.reshape(g.shape[0], g.shape[1] // 2, 2,
                          g.shape[2]).mean(axis=2)
        g = g.reshape(g.shape[0], g.shape[1],
                      g.shape[2] // 2, 2).mean(axis=3)
        return g

    def _prolong(self, c, gi=None, homog=True):
        """Linear cell-centered 2x prolongation.  On isolated global
        levels the edge neighbors come from the boundary ghosts of the
        COARSE level ``gi`` (homog=True for corrections); elsewhere it
        wraps at array edges — callers mask out the edge ring when wrap
        is not meaningful."""
        for ax in self._axes():
            cm, cp = self._nbrs(c, ax, gi, homog=homog)
            lo = 0.75 * c + 0.25 * cm
            hi = 0.75 * c + 0.25 * cp
            st = jnp.stack([lo, hi], axis=ax + 1)
            sh = list(c.shape)
            sh[ax] *= 2
            c = st.reshape(sh)
        return c

    def _g_red(self, shape):
        kk, jj, ii = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                                 np.arange(shape[2]), indexing="ij")
        return ((ii + (jj if self.active[1] else 0)
                 + (kk if self.active[2] else 0)) % 2 == 0)

    # ------------------------------------------------------------------
    # blocks <-> dense levels
    # ------------------------------------------------------------------
    def _leaf_gather_idx(self, gids, offs):
        """Index grids to gather/scatter leaf interiors from/to a dense
        array: returns (Z, Y, X) each [nleaf, n3, n2, n1]."""
        n3, n2, n1 = self._nxb
        z = offs[:, 0, None, None, None] + np.arange(n3)[None, :, None,
                                                         None]
        y = offs[:, 1, None, None, None] + np.arange(n2)[None, None, :,
                                                         None]
        x = offs[:, 2, None, None, None] + np.arange(n1)[None, None, None,
                                                         :]
        zz = np.broadcast_to(z, (len(gids), n3, n2, n1))
        yy = np.broadcast_to(y, (len(gids), n3, n2, n1))
        xx = np.broadcast_to(x, (len(gids), n3, n2, n1))
        return zz, yy, xx

    def _blocks_to_levels(self, f):
        """Block field [nmb, n3, n2, n1] (interior cell values) -> dense
        per-level arrays [root, box_1, ..., box_L]."""
        gi = self.mesh.mesh_indcs
        shape0 = (max(gi.nx3, 1), max(gi.nx2, 1), gi.nx1)
        out = []
        g0 = jnp.zeros(shape0, f.dtype)
        zz, yy, xx = self._leaf_gather_idx(self.root_gids, self.root_off)
        g0 = g0.at[zz, yy, xx].set(f[self.root_gids])
        out.append(g0)
        for bl in self.boxes:
            g = jnp.zeros(bl.shape, f.dtype)
            if bl.leaf_gids.size:
                zz, yy, xx = self._leaf_gather_idx(bl.leaf_gids,
                                                   bl.leaf_off)
                g = g.at[zz, yy, xx].set(f[bl.leaf_gids])
            out.append(g)
        return out

    def _levels_to_blocks(self, levels, dtype):
        """Dense per-level arrays -> block field [nmb, 1, nc3, nc2, nc1]
        (interior only; ghosts zero)."""
        mesh = self.mesh
        mbi = mesh.mb_indcs
        out = jnp.zeros((mesh.nmb_total, 1, mbi.ncells3, mbi.ncells2,
                         mbi.ncells1), dtype)
        zz, yy, xx = self._leaf_gather_idx(self.root_gids, self.root_off)
        vals = levels[0][zz, yy, xx]
        out = out.at[(self.root_gids, 0) + self.act_in].set(vals)
        for bl, g in zip(self.boxes, levels[1:]):
            if bl.leaf_gids.size:
                zz, yy, xx = self._leaf_gather_idx(bl.leaf_gids,
                                                   bl.leaf_off)
                vals = g[zz, yy, xx]
                out = out.at[(bl.leaf_gids, 0) + self.act_in].set(vals)
        return out

    # ------------------------------------------------------------------
    # box-level helpers
    # ------------------------------------------------------------------
    def _box_set_border(self, li, g, coarse):
        """Fill the Dirichlet border of box level li (1-based) by linear
        interpolation from the coarser level (global root for li==1)."""
        bl = self.boxes[li - 1]
        # coarse region covering the box: coarse cells [lo//2, (lo+sz)//2)
        clo, csl = self._coarse_window(li)
        cw = coarse[csl]
        fine_full = self._prolong(cw)
        # offset of the box inside the prolonged window
        off = bl.lo - self._scale_up(clo)
        sl = tuple(slice(int(o), int(o + s))
                   for o, s in zip(off, bl.shape))
        fine = fine_full[sl]
        return jnp.where(jnp.asarray(bl.border), fine, g)

    def _act_vec(self):
        return np.array([1 if self.active[2] else 0,
                         1 if self.active[1] else 0, 1])

    def _scale_up(self, idx):
        v = self._act_vec()
        return idx * (1 + v)  # *2 on active dims, *1 on inactive

    def _coarse_window(self, li):
        """Coarse-level index window covering box li (with margin for
        the prolongation stencil's roll wrap)."""
        bl = self.boxes[li - 1]
        if li == 1:
            cshape = self.glevels[0][0]
        else:
            cshape = self.boxes[li - 2].shape
        v = self._act_vec()
        lo = bl.lo.copy()
        hi = bl.lo + np.array(bl.shape)
        clo = np.where(v > 0, np.floor_divide(lo - 1, 2), lo)
        chi = np.where(v > 0, -np.floor_divide(-(hi + 1), 2), hi)
        if li == 1:
            clo = np.maximum(clo, 0)
            chi = np.minimum(chi, np.array(cshape))
        else:
            coff = self.boxes[li - 2].lo
            clo = np.maximum(clo, coff) - coff
            chi = np.minimum(chi, coff + np.array(cshape)) - coff
        csl = tuple(slice(int(a), int(b)) for a, b in zip(clo, chi))
        return clo if li == 1 else clo + self.boxes[li - 2].lo, csl

    # ------------------------------------------------------------------
    # FAS/MLAT V-cycle over [boxes L..1] + [global stack]
    # ------------------------------------------------------------------
    def _vcycle_glob(self, gi, g, rhs):
        shape, dxs = self.glevels[gi]
        red = self._g_red(shape)
        if gi + 1 >= len(self.glevels):
            return _repeat(self.nbottom,
                           lambda v: self._smooth(v, rhs, dxs, red, 1.0,
                                                  gi=gi),
                           g)
        g = _repeat(self.npre,
                    lambda v: self._smooth(v, rhs, dxs, red, self.omega,
                                           gi=gi),
                    g)
        res = rhs - self._lap(g, dxs, gi)
        g0c = self._restrict(g)
        rhsc = self._lap(g0c, self.glevels[gi + 1][1], gi + 1) \
            + self._restrict(res)
        gc = self._vcycle_glob(gi + 1, g0c, rhsc)
        g = g + self._prolong(gc - g0c, gi=gi + 1)
        g = _repeat(self.npost,
                    lambda v: self._smooth(v, rhs, dxs, red, self.omega,
                                           gi=gi),
                    g)
        return g

    def _coarse_sl(self, li, shape_r):
        """Slice placing the restricted box core into the coarse array."""
        bl = self.boxes[li - 1]
        v = self._act_vec()
        lo_c = (bl.lo + v) // (1 + v)
        if li == 1:
            coff = np.zeros(3, dtype=np.int64)
        else:
            coff = self.boxes[li - 2].lo
        return tuple(slice(int(a - o), int(a - o + s))
                     for a, o, s in zip(lo_c, coff, shape_r))

    def _interface_corr(self, li, phi_b, phi_c, cov_np, sl):
        """Conservative interface (reflux) correction to the coarse rhs
        at uncovered cells adjacent to the covered region: replace the
        naive coarse face gradient (phi_D - phi_C)/h_c by the restricted
        fine-face gradient mean (the reference's mass-conservation
        coupling at octet boundaries).  Returns the correction field
        (zero away from the interface)."""
        bl = self.boxes[li - 1]
        v = self._act_vec()
        core = tuple(slice(int(a), int(s - a))
                     for a, s in zip(v, bl.shape))
        dxs_c = self.glevels[0][1] if li == 1 else self.boxes[li - 2].dxs
        act = jnp.asarray(bl.active)
        bord = jnp.asarray(bl.border)
        corr = jnp.zeros_like(phi_c)
        axdx = [(2, bl.dxs[2], dxs_c[2])]
        if self.active[1]:
            axdx.append((1, bl.dxs[1], dxs_c[1]))
        if self.active[2]:
            axdx.append((0, bl.dxs[0], dxs_c[0]))
        cov = jnp.asarray(cov_np)
        for ax, hf, hc in axdx:
            for side in ("lo", "hi"):
                sh = 1 if side == "lo" else -1
                m = act & jnp.roll(bord, sh, axis=ax)
                phi_bd = jnp.roll(phi_b, sh, axis=ax)
                # fine gradient towards the covered region owner D
                val = jnp.where(m, (phi_b - phi_bd) / hf, 0.0)
                fhat = 2.0 * self._restrict(val[core])  # face mean, at D
                fld = jnp.zeros_like(phi_c).at[sl].set(fhat)
                # move to C (one coarse cell outward: -sh along ax)
                fhat_c = jnp.roll(fld, -sh, axis=ax)
                c_mask = (~cov) & jnp.roll(cov, -sh, axis=ax) \
                    & (jnp.roll(fhat_c, 0, axis=ax) != 0.0)
                phi_d = jnp.roll(phi_c, sh * -1, axis=ax)
                naive = (phi_d - phi_c) / hc ** 2
                corr = corr + jnp.where(c_mask,
                                        naive - fhat_c / hc, 0.0)
        return corr

    def _box_coarsen(self, li, phi_l, res_l, coarse_phi, coarse_rhs):
        """Inject restrict(phi_l) + tau-corrected rhs into the coarser
        level on the covered region; reflux-correct the uncovered cells
        adjacent to the interface.  Returns (phi_c, rhs_c, cov)."""
        bl = self.boxes[li - 1]
        v = self._act_vec()
        # interior (non-border) region of the box is alignment-safe:
        # strip the 1-cell ring, restrict, place into coarse
        core = tuple(slice(int(a), int(s - a))
                     for a, s in zip(v, bl.shape))
        phi_r = self._restrict(phi_l[core])
        res_r = self._restrict(res_l[core])
        act_r = jnp.asarray(
            self._restrict_mask(bl.active[core]))
        sl = self._coarse_sl(li, phi_r.shape)
        phi_c = coarse_phi.at[sl].set(
            jnp.where(act_r, phi_r, coarse_phi[sl]))
        # tau correction: rhs_c = A_c(phi_c) + R(res) on covered cells
        dxs_c = self.glevels[0][1] if li == 1 else self.boxes[li - 2].dxs
        lap_c = self._lap(phi_c, dxs_c, 0 if li == 1 else None)
        pad = jnp.zeros_like(coarse_rhs)
        pad = pad.at[sl].set(jnp.where(act_r, res_r, 0.0))
        cov = self._cov_mask(li)
        rhs_c = jnp.where(jnp.asarray(cov), lap_c + pad, coarse_rhs)
        rhs_c = rhs_c + self._interface_corr(li, phi_l, phi_c, cov, sl)
        if li == 1 and self.periodic:
            # level-wise solvability: project out the mean (the composite
            # rhs is compatible; the root subproblem needs its own
            # compatibility enforced)
            rhs_c = rhs_c - jnp.mean(rhs_c)
        return phi_c, rhs_c, cov

    def _cov_mask(self, li):
        """Static coarse-grid mask of cells covered by box level li."""
        key = f"_covm_{li}"
        m = getattr(self, key, None)
        if m is None:
            bl = self.boxes[li - 1]
            v = self._act_vec()
            core = tuple(slice(int(a), int(s - a))
                         for a, s in zip(v, bl.shape))
            act_r = self._restrict_mask(bl.active[core])
            shape = self.glevels[0][0] if li == 1 \
                else self.boxes[li - 2].shape
            m = np.zeros(shape, dtype=bool)
            m[self._coarse_sl(li, act_r.shape)] = act_r
            setattr(self, key, m)
        return m

    def _restrict_mask(self, m):
        x = m.astype(np.float64)
        if self.active[2]:
            x = x.reshape(x.shape[0] // 2, 2, x.shape[1],
                          x.shape[2]).mean(axis=1)
        if self.active[1]:
            x = x.reshape(x.shape[0], x.shape[1] // 2, 2,
                          x.shape[2]).mean(axis=2)
        x = x.reshape(x.shape[0], x.shape[1],
                      x.shape[2] // 2, 2).mean(axis=3)
        return x > 0.5

    def _box_correct(self, li, phi_l, phi_c, phi_c0):
        """Prolong the coarse correction into box li (active + border)."""
        bl = self.boxes[li - 1]
        clo, csl = self._coarse_window(li)
        dw = (phi_c - phi_c0)[csl]
        fine_full = self._prolong(dw)
        off = bl.lo - self._scale_up(clo)
        sl = tuple(slice(int(o), int(o + s))
                   for o, s in zip(off, bl.shape))
        corr = fine_full[sl]
        upd = jnp.asarray(bl.active | bl.border)
        return jnp.where(upd, phi_l + corr, phi_l)

    def _vcycle_box(self, li, levels, rhs_levels):
        """V-cycle starting at box level li (li=len(boxes) is finest).
        ``levels``/``rhs_levels`` are the full per-level lists; returns
        updated levels list."""
        if li == 0:
            g = self._vcycle_glob(0, levels[0], rhs_levels[0])
            return [g] + levels[1:]
        bl = self.boxes[li - 1]
        phi = levels[li]
        rhs = rhs_levels[li]
        coarse = levels[li - 1]
        phi = self._box_set_border(li, phi, coarse)
        red = jnp.asarray(bl.red)
        am = jnp.asarray(bl.active)
        phi = _repeat(self.npre,
                      lambda v: self._smooth(v, rhs, bl.dxs, red,
                                             self.omega, update_mask=am),
                      phi)
        res = jnp.where(am, rhs - self._lap(phi, bl.dxs, None), 0.0)
        phi_c0, rhs_c, cov = self._box_coarsen(
            li, phi, res, coarse, rhs_levels[li - 1])
        levels2 = levels[:li - 1] + [phi_c0] + levels[li:]
        rhs2 = rhs_levels[:li - 1] + [rhs_c] + rhs_levels[li:]
        levels3 = self._vcycle_box(li - 1, levels2, rhs2)
        phi = self._box_correct(li, phi, levels3[li - 1], phi_c0)
        phi = self._box_set_border(li, phi, levels3[li - 1])
        phi = _repeat(self.npost,
                      lambda v: self._smooth(v, rhs, bl.dxs, red,
                                             self.omega, update_mask=am),
                      phi)
        return levels3[:li] + [phi] + levels3[li + 1:]

    # ------------------------------------------------------------------
    def _make_rhs_levels(self, u):
        """four_pi_G*(rho - <rho>) injected into the per-level arrays."""
        mbi = self.mesh.mb_indcs
        rho = u[:, 0][(slice(None),) + self.act_in]
        if self.mask_radius > 0.0:
            # zero the source outside the mask sphere (ApplyMask,
            # reference: multigrid.cpp:355-385); host mask baked at
            # trace time from the current tree's cell centers
            nmb = rho.shape[0]
            m = np.ones((nmb,) + rho.shape[1:], dtype=bool)
            ox, oy, oz = self.mask_origin
            r2m = self.mask_radius ** 2
            for g in range(min(nmb, self.mesh.nmb_total)):
                c1, c2, c3 = self.mesh.cell_centers(g)
                c1 = c1[mbi.is_:mbi.ie + 1] - ox
                c2 = c2[mbi.js:mbi.je + 1] - oy
                c3 = c3[mbi.ks:mbi.ke + 1] - oz
                m[g] = (c1[None, None, :] ** 2 + c2[None, :, None] ** 2
                        + c3[:, None, None] ** 2) <= r2m
            rho = jnp.where(jnp.asarray(m), rho, 0.0)
        # volume-weighted mean over the composite mesh
        if self.subtract_average:
            vol = (np.asarray(self.mesh.mb_size["dx1"])
                   * np.asarray(self.mesh.mb_size["dx2"])
                   * np.asarray(self.mesh.mb_size["dx3"]))
            v = jnp.asarray(vol.reshape(-1, 1, 1, 1))
            mean = jnp.sum(rho * v) / self.total_vol
            rho = rho - mean
        rho = self.four_pi_G * rho
        return self._blocks_to_levels(rho)

    def _composite_defect(self, levels, rhs_levels):
        """Volume-weighted L2 defect over owned cells of every level
        (reference: CalculateDefectNorm, multigrid_driver.cpp:905-937).

        Measured with the *conservative* composite operator: fine levels
        see Dirichlet borders interpolated from the coarse solution;
        coarse levels see freshly injected fine values on covered cells
        plus the reflux correction at interface cells."""
        acc = 0.0
        top = len(self.boxes)
        # walk finest -> root, measuring each level and preparing the
        # coarser level's injected state + reflux correction
        phi_cur = None
        corr_next = None
        for li in range(top, 0, -1):
            bl = self.boxes[li - 1]
            phi = levels[li] if phi_cur is None else phi_cur
            phi = self._box_set_border(li, phi, levels[li - 1])
            rhs_eff = rhs_levels[li]
            if corr_next is not None:
                rhs_eff = rhs_eff + corr_next
            r = rhs_eff - self._lap(phi, bl.dxs, None)
            dv = float(np.prod(bl.dxs))
            acc = acc + jnp.sum(
                jnp.where(jnp.asarray(bl.owned), r ** 2, 0.0)) * dv
            # inject into the coarser level + reflux correction there
            v = self._act_vec()
            core = tuple(slice(int(a), int(s - a))
                         for a, s in zip(v, bl.shape))
            phi_r = self._restrict(phi[core])
            act_r = jnp.asarray(self._restrict_mask(bl.active[core]))
            sl = self._coarse_sl(li, phi_r.shape)
            coarse = levels[li - 1].at[sl].set(
                jnp.where(act_r, phi_r, levels[li - 1][sl]))
            cov = self._cov_mask(li)
            corr_next = self._interface_corr(li, phi, coarse, cov, sl)
            phi_cur = coarse
        # root level
        g = levels[0] if phi_cur is None else phi_cur
        dxs = self.glevels[0][1]
        rhs0 = rhs_levels[0]
        if corr_next is not None:
            rhs0 = rhs0 + corr_next
        r = rhs0 - self._lap(g, dxs, 0)
        own0 = np.ones(self.glevels[0][0], dtype=bool)
        if self.boxes:
            own0 &= ~self._cov_mask(1)
        dv = float(np.prod(dxs))
        acc = acc + jnp.sum(jnp.where(jnp.asarray(own0), r ** 2, 0.0)) * dv
        return jnp.sqrt(acc / self.total_vol)

    # ------------------------------------------------------------------
    def _fmg_start(self, rhs_levels):
        """Full-multigrid initial guess (reference: SolveFMG,
        multigrid_driver.cpp:739-747)."""
        # fold fine-level rhs down (plain restriction: zero initial u)
        rhs_eff = list(rhs_levels)
        for li in range(len(self.boxes), 0, -1):
            bl = self.boxes[li - 1]
            v = self._act_vec()
            core = tuple(slice(int(a), int(s - a))
                         for a, s in zip(v, bl.shape))
            r = self._restrict(rhs_eff[li][core])
            act_r = jnp.asarray(self._restrict_mask(bl.active[core]))
            lo_c = (bl.lo + v) // (1 + v)
            coff = np.zeros(3, dtype=np.int64) if li == 1 \
                else self.boxes[li - 2].lo
            sl = tuple(slice(int(a - o), int(a - o + s))
                       for a, o, s in zip(lo_c, coff, r.shape))
            rhs_eff[li - 1] = rhs_eff[li - 1].at[sl].set(
                jnp.where(act_r, r, rhs_eff[li - 1][sl]))
        rhs_g = [rhs_eff[0]]
        for gi in range(len(self.glevels) - 1):
            rhs_g.append(self._restrict(rhs_g[-1]))
        shape, dxs = self.glevels[-1]
        g = jnp.zeros(shape, rhs_g[-1].dtype)
        red = self._g_red(shape)
        g = _repeat(self.nbottom,
                    lambda v: self._smooth(v, rhs_g[-1], dxs, red, 1.0,
                                           gi=len(self.glevels) - 1),
                    g)
        for gi in range(len(self.glevels) - 2, -1, -1):
            g = self._prolong(g, gi=gi + 1)
            for _ in range(self.fmg_ncycle):
                g = self._vcycle_glob(gi, g, rhs_g[gi])
        levels = [g]
        # climb the box stack: initialize each level by interpolation
        for li in range(1, len(self.boxes) + 1):
            bl = self.boxes[li - 1]
            clo, csl = self._coarse_window(li)
            fine_full = self._prolong(levels[li - 1][csl])
            off = bl.lo - self._scale_up(clo)
            sl = tuple(slice(int(o), int(o + s))
                       for o, s in zip(off, bl.shape))
            phi = fine_full[sl]
            levels.append(phi)
            for _ in range(self.fmg_ncycle):
                levels = self._vcycle_box(li, levels, rhs_eff[:li + 1]
                                          + rhs_levels[li + 1:])
        return levels

    # ------------------------------------------------------------------
    def _iterate(self, levels, rhs_levels):
        top = len(self.boxes)
        if self.eps >= 0.0:
            max_it = self.niter if self.niter > 0 else 40

            def cond(carry):
                _, d, it = carry
                return (d > self.eps) & (it < max_it)

            def body(carry):
                lv, _, it = carry
                lv = list(lv)
                lv = self._vcycle_box(top, lv, rhs_levels)
                return (tuple(lv),
                        self._composite_defect(lv, rhs_levels), it + 1)

            d0 = self._composite_defect(levels, rhs_levels)
            out, _, _ = lax.while_loop(cond, body, (tuple(levels), d0, 0))
            return list(out)
        levels = _repeat(
            max(self.niter, 1),
            lambda lv: tuple(self._vcycle_box(top, list(lv),
                                              rhs_levels)),
            tuple(levels))
        return list(levels)

    # ------------------------------------------------------------------
    # multipole boundary values (reference: multigrid_driver.cpp:
    # 2210-2366 CalculateMultipoleCoefficients/Scale, multigrid.hpp:
    # 679-708 EvalMultipolePhi, 2371-2434 CalculateCenterOfMass)
    # ------------------------------------------------------------------
    def _block_coords(self):
        """Cell-center coordinate arrays (x, y, z), each [nmb, n3, n2,
        n1] over block interiors (numpy, static)."""
        mbi = self.mesh.mb_indcs
        mbs = self.mesh.mb_size

        def ax(name, n):
            lo = np.asarray(mbs[f"{name}min"], np.float64)[:, None]
            d = np.asarray(mbs["d" + name], np.float64)[:, None]
            return lo + (np.arange(n)[None, :] + 0.5) * d
        x = ax("x1", mbi.nx1)[:, None, None, :]
        y = ax("x2", max(mbi.nx2, 1))[:, None, :, None]
        z = ax("x3", max(mbi.nx3, 1))[:, :, None, None]
        return x, y, z

    def _mp_harmonics(self, x, y, z, s):
        """Raw multipole moments: sum of s * solid harmonics (the
        reference's per-cell accumulation, multigrid_driver.cpp:
        2244-2300).  Returns [25] (unused entries zero)."""
        x2, y2, z2 = x * x, y * y, z * z
        xy, yz, zx = x * y, y * z, z * x
        r2 = x2 + y2 + z2
        hx2my2 = 0.5 * (x2 - y2)
        mp = [None] * 25
        one = jnp.ones_like(s)
        mp[0] = one
        if self.nodipole:
            mp[1] = mp[2] = mp[3] = jnp.zeros_like(s)
        else:
            mp[1], mp[2], mp[3] = y, z, x
        mp[4], mp[5] = xy, yz
        mp[6] = 3.0 * z2 - r2
        mp[7], mp[8] = zx, hx2my2
        if self.mporder == 4:
            tx2my2 = 3.0 * x2 - y2
            x2mty2 = x2 - 3.0 * y2
            fz2mr2 = 5.0 * z2 - r2
            sz2mr2 = 7.0 * z2 - r2
            sz2mtr2 = 7.0 * z2 - 3.0 * r2
            mp[9] = y * tx2my2
            mp[10] = xy * z
            mp[11] = y * fz2mr2
            mp[12] = z * (z2 - 3.0 * r2)
            mp[13] = x * fz2mr2
            mp[14] = z * hx2my2
            mp[15] = x * x2mty2
            mp[16] = xy * hx2my2
            mp[17] = yz * tx2my2
            mp[18] = xy * sz2mr2
            mp[19] = yz * sz2mtr2
            mp[20] = 35.0 * z2 * z2 - 30.0 * z2 * r2 + 3.0 * r2 * r2
            mp[21] = zx * sz2mtr2
            mp[22] = hx2my2 * sz2mr2
            mp[23] = zx * x2mty2
            mp[24] = 0.125 * (x2 * x2mty2 - y2 * tx2my2)
        else:
            for c in range(9, 25):
                mp[c] = jnp.zeros_like(s)
        return jnp.stack([jnp.sum(s * h) for h in mp])

    _MP_SCALE = None  # class-level cache of the 25 scaling constants

    @classmethod
    def _mp_scale(cls):
        """Normalization constants (reference:
        ScaleMultipoleCoefficients, multigrid_driver.cpp:2320-2366)."""
        if cls._MP_SCALE is None:
            pi = np.pi
            c0 = c1 = 0.25 / pi
            c2 = 0.0625 / pi
            c2a = 0.75 / pi
            c30 = 0.0625 / pi
            c31 = 0.0625 * 1.5 / pi
            c32 = 0.25 * 15.0 / pi
            c33 = 0.0625 * 2.5 / pi
            c40 = 0.0625 * 0.0625 / pi
            c41 = 0.0625 * 2.5 / pi
            c42 = 0.0625 * 5.0 / pi
            c43 = 0.0625 * 17.5 / pi
            c44 = 0.25 * 35.0 / pi
            cls._MP_SCALE = np.array(
                [c0, c1, c1, c1, c2a, c2a, c2, c2a, c2a,
                 c33, c32, c31, c30, c31, c32, c33,
                 c44, c43, c42, c41, c40, c41, c42, c43, c44])
        return cls._MP_SCALE

    def _eval_mp_phi(self, mpc, x, y, z):
        """phi_mp at (x, y, z) relative to the expansion origin
        (reference: EvalMultipolePhi, multigrid.hpp:679-708)."""
        x2, y2, z2 = x * x, y * y, z * z
        xy, yz, zx = x * y, y * z, z * x
        r2 = x2 + y2 + z2
        ir2 = 1.0 / r2
        ir1 = jnp.sqrt(ir2)
        ir3 = ir2 * ir1
        ir5 = ir3 * ir2
        hx2my2 = 0.5 * (x2 - y2)
        phis = (ir1 * mpc[0]
                + ir3 * (mpc[1] * y + mpc[2] * z + mpc[3] * x)
                + ir5 * (mpc[4] * xy + mpc[5] * yz
                         + (3.0 * z2 - r2) * mpc[6]
                         + mpc[7] * zx + mpc[8] * hx2my2))
        if self.mporder == 4:
            ir7 = ir5 * ir2
            ir9 = ir7 * ir2
            x2mty2 = x2 - 3.0 * y2
            tx2my2 = 3.0 * x2 - y2
            phis = phis + ir7 * (
                y * tx2my2 * mpc[9] + x * x2mty2 * mpc[15]
                + xy * z * mpc[10] + z * hx2my2 * mpc[14]
                + (5.0 * z2 - r2) * (y * mpc[11] + x * mpc[13])
                + z * (z2 - 3.0 * r2) * mpc[12]) + ir9 * (
                xy * hx2my2 * mpc[16]
                + 0.125 * (x2 * x2mty2 - y2 * tx2my2) * mpc[24]
                + yz * tx2my2 * mpc[17] + zx * x2mty2 * mpc[23]
                + (7.0 * z2 - r2) * (xy * mpc[18] + hx2my2 * mpc[22])
                + (7.0 * z2 - 3.0 * r2) * (yz * mpc[19] + zx * mpc[21])
                + (35.0 * z2 * z2 - 30.0 * z2 * r2
                   + 3.0 * r2 * r2) * mpc[20])
        return phis

    def _multipole_setup(self, u):
        """Compute multipole coefficients from the block source and
        evaluate boundary-face phi_mp slabs for every global level."""
        if self.mporder == 0:
            self._mp = None
            return
        mbi = self.mesh.mb_indcs
        rho = u[:, 0][(slice(None),) + self.act_in]
        # reference convention: moments of src = -4 pi G rho, positive
        # scaling constants -> negative (attractive) potential
        vol = (np.asarray(self.mesh.mb_size["dx1"])
               * np.asarray(self.mesh.mb_size["dx2"])
               * np.asarray(self.mesh.mb_size["dx3"]))
        s = -self.four_pi_G * rho * jnp.asarray(
            vol.reshape(-1, 1, 1, 1), rho.dtype)
        xs, ys, zs = self._block_coords()
        xs = jnp.asarray(xs, rho.dtype)
        ys = jnp.asarray(ys, rho.dtype)
        zs = jnp.asarray(zs, rho.dtype)
        if getattr(self, "autompo", False):
            tot = jnp.sum(s)
            xo = jnp.sum(s * xs) / tot
            yo = jnp.sum(s * ys) / tot
            zo = jnp.sum(s * zs) / tot
        else:
            xo, yo, zo = [jnp.asarray(v, rho.dtype) for v in self.mpo]
        mpc = self._mp_harmonics(xs - xo, ys - yo, zs - zo, s)
        mpc = mpc * jnp.asarray(self._mp_scale(), mpc.dtype)

        ms = self.mesh.mesh_size
        lims = ((ms.x3min, ms.x3max), (ms.x2min, ms.x2max),
                (ms.x1min, ms.x1max))
        self._mp = []
        for shape, dxs in self.glevels:
            slabs = {}
            # cell-center coords per axis at this level
            cc = [lims[a][0] + (np.arange(shape[a]) + 0.5) * dxs[a]
                  for a in range(3)]
            for ax in range(3):
                lo_f, hi_f = self.bc_flags[ax]
                for side, flag in ((0, lo_f), (1, hi_f)):
                    if flag != "multipole":
                        continue
                    # face-plane position along ax, cell centers across
                    face = lims[ax][side]
                    oth = [a for a in range(3) if a != ax]
                    g0, g1 = np.meshgrid(cc[oth[0]], cc[oth[1]],
                                         indexing="ij")
                    vals = [None, None, None]
                    vals[oth[0]] = jnp.asarray(g0, u.dtype)
                    vals[oth[1]] = jnp.asarray(g1, u.dtype)
                    vals[ax] = jnp.full(g0.shape, face, u.dtype)
                    z, y, x = vals  # array axes (0,1,2) = (x3,x2,x1)
                    phi = self._eval_mp_phi(mpc, x - xo, y - yo, z - zo)
                    # shape with a singleton along ax for concatenation
                    slabs[(ax, side)] = jnp.expand_dims(phi, ax)
            self._mp.append(slabs)

    def solve(self, u, bvals, phi0=None):
        """phi with ghosts filled, [nmb, 1, n3, n2, n1].

        ``phi0`` warm-starts the V-cycles from a previous solution (the
        driver carries state["phi"] across stages), replacing the FMG
        start — the dominant trace cost inside a jitted cycle."""
        if self.mg_bc == "multipole":
            self._multipole_setup(u)
        rhs_levels = self._make_rhs_levels(u)
        if phi0 is not None:
            levels = self._blocks_to_levels(
                phi0[:, 0][(slice(None),) + self.act_in])
        elif self.fmg:
            levels = self._fmg_start(rhs_levels)
        else:
            levels = [jnp.zeros(self.glevels[0][0], u.dtype)] \
                + [jnp.zeros(bl.shape, u.dtype) for bl in self.boxes]
        levels = self._iterate(levels, rhs_levels)
        phi = self._levels_to_blocks(levels, u.dtype)
        if self.subtract_average:
            vol = (np.asarray(self.mesh.mb_size["dx1"])
                   * np.asarray(self.mesh.mb_size["dx2"])
                   * np.asarray(self.mesh.mb_size["dx3"]))
            v = jnp.asarray(vol.reshape(-1, 1, 1, 1, 1))
            act = (slice(None), slice(None)) + self.act_in
            mean = jnp.sum(phi[act] * v) / self.total_vol
            phi = phi - mean
        return bvals.fill_ghosts(phi)

    # ------------------------------------------------------------------
    def solve_verbose(self, u) -> List[float]:
        """Host-side solve printing the reference's defect diagnostics
        (reference: SolveIterative, multigrid_driver.cpp:788-860).
        Returns the defect history."""
        if self.mg_bc == "multipole":
            self._multipole_setup(u)
        rhs_levels = jax.jit(self._make_rhs_levels)(u)
        if self.fmg:
            levels = jax.jit(self._fmg_start)(rhs_levels)
        else:
            levels = [jnp.zeros(self.glevels[0][0], u.dtype)] \
                + [jnp.zeros(bl.shape, u.dtype) for bl in self.boxes]
        top = len(self.boxes)
        step = jax.jit(lambda lv, rl: tuple(
            self._vcycle_box(top, list(lv), list(rl))))
        dfn = jax.jit(lambda lv, rl: self._composite_defect(
            list(lv), list(rl)))
        levels = tuple(levels)
        rhs_t = tuple(rhs_levels)
        d = float(dfn(levels, rhs_t))
        hist = [d]
        print(f"MG initial defect = {d:.15e}")
        n = 0
        max_it = self.niter if self.niter > 0 else 40
        while n < max_it:
            levels = step(levels, rhs_t)
            d = float(dfn(levels, rhs_t))
            hist.append(d)
            if self.show_defect >= 2:
                print(f"MG iteration {n}: defect = {d:.15e}")
            n += 1
            if self.eps >= 0.0 and d <= self.eps:
                break
        print(f"MGGravityDriver::Solve: Final defect norm = {d:.15e}")
        # stash the solution in block form (ghosts unfilled) so callers
        # can reuse it without recompiling a second solve
        self._last_phi = self._levels_to_blocks(list(levels), u.dtype)
        return hist
