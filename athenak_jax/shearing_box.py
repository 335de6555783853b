"""Shearing box: local-frame source terms, orbital advection (CC + FC),
and shear-periodic radial boundaries.

Parity target: the reference ``ShearingBox``/``OrbitalAdvection`` modules
(reference: src/shearing_box/shearing_box.cpp:24-68,
shearing_box_srcterms.cpp:30-150, orbital_advection_cc.cpp:244-290,
orbital_advection_fc.cpp:180-361, shearing_box_cc.cpp:63-140,
shearing_box_fc.cpp:60-140, remap_fluxes.hpp:15-69).  Like the
reference, the evolved azimuthal velocity is the DEVIATION from the
orbital shear flow vy_orb = -q Omega0 x1:

  * source terms: dM1 += 2 Om M2 bdt; dM2 -= (2-q) Om M1 bdt;
    dE += q Om (M1 M2/rho - Bx By) bdt (+ stratified vertical gravity)
  * orbital advection: once per cycle every x1-column is remapped in y by
    dy = -q Om x1 dt.  Cell-centered variables use a conservative remap
    (integer modular gather + upwind PLM fractional flux); face fields
    use the EMF form of Stone & Gardiner (2010): the remap fluxes are
    accumulated into effective EMFs and applied through a CT update so
    div(B) is preserved to round-off.
  * shear-periodic x1 BCs: ghost slabs are assembled from the OPPOSITE
    x1-boundary column's full azimuthal ring, shifted by
    +/- yshear(t) = q Om Lx t with the same conservative remap.

Design: all neighbor motion is static gathers along the block
axis (ring tables built host-side) plus ``take_along_axis`` with traced
integer shifts; cumulative sums turn the reference's per-cell
integer-offset loops into two gathers; everything is shape-static inside
the jitted cycle.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .indices import IDN, IEN, IM1, IM2, IM3, IVX, IVY, IVZ

_JA = 3  # y axis in [nmb, nvar, n3, n2, n1]


def _mc_slope(g, axis):
    gm = jnp.roll(g, 1, axis=axis)
    gp = jnp.roll(g, -1, axis=axis)
    dl = g - gm
    dr = gp - g
    return jnp.where(dl * dr > 0.0,
                     2.0 * dl * dr / (dl + dr + 1.0e-300), 0.0)


def _plm_remap(f, s, axis):
    """Conservative periodic remap of f by a (traced, per-element) shift
    ``s`` in cells along ``axis``.  Positive s moves the profile toward
    +axis.  PLM with monotonized-central slopes (reference:
    remap_fluxes.hpp PLM branch)."""
    n = f.shape[axis]
    jo = jnp.floor(s).astype(jnp.int32)
    eps = s - jo  # in [0, 1)

    # integer shift: out_j = f_{j - jo} via modular gather
    jgrid = jnp.arange(n)
    shape = [1] * f.ndim
    shape[axis] = n
    jgrid = jgrid.reshape(shape)
    idx = jnp.mod(jgrid - jo, n)
    idx = jnp.broadcast_to(idx, f.shape)
    g = jnp.take_along_axis(f, idx, axis=axis)

    # fractional shift by eps in [0,1): upwind PLM flux through j-1/2
    gm = jnp.roll(g, 1, axis=axis)
    sig_m = jnp.roll(_mc_slope(g, axis), 1, axis=axis)
    flux = eps * (gm + 0.5 * (1.0 - eps) * sig_m)  # through j-1/2
    flux_p = jnp.roll(flux, -1, axis=axis)         # through j+1/2
    return g - (flux_p - flux)


def _remap_flux(ext, eps, axis):
    """Signed-eps upwind PLM remap flux through face j (between cells
    j-1 and j) for every position of ``ext`` (reference:
    remap_fluxes.hpp PLM_RemapFlx, both branches)."""
    sig = _mc_slope(ext, axis)
    um = jnp.roll(ext, 1, axis=axis)
    sm = jnp.roll(sig, 1, axis=axis)
    f_pos = eps * (um + 0.5 * (1.0 - eps) * sm)
    f_neg = eps * (ext - 0.5 * (1.0 + eps) * sig)
    return jnp.where(eps > 0.0, f_pos, f_neg)


class ShearingBox:
    def __init__(self, pin, mesh, nvar: int) -> None:
        self.mesh = mesh
        self.qshear = pin.get_real("shearing_box", "qshear")
        self.omega0 = pin.get_real("shearing_box", "omega0")
        self.is_stratified = pin.get_or_add_boolean(
            "shearing_box", "stratified", False)
        ms = mesh.mesh_size
        self.lx = ms.x1max - ms.x1min
        self.ly = ms.x2max - ms.x2min
        mbi = mesh.mb_indcs
        if mbi.nx2 == 1:
            raise NotImplementedError(
                "1D shearing box is not a supported configuration")
        # 2D (nx3=1) is the r-z box: the toroidal direction maps to
        # component 3, there is no orbital advection / sheared remap
        # (shear_periodic reduces to periodic), and the background
        # orbital EMF enters as an FC source (reference: mhd_tasks.cpp
        # gates PackAndSendCC/FC + orbital advection on three_d||r_phi;
        # shearing_box_srcterms.cpp:159-200 SourceTermsFC)
        self.r_phi = False          # 2D r-phi: not in the reference either
        self.oa_active = mbi.nx3 > 1 or self.r_phi

        # maximum integer shift per cycle for orbital advection
        # (reference: orbital_advection.cpp:41-43)
        cfl = pin.get_or_add_real("time", "cfl_number", 0.8) \
            if pin.does_block_exist("time") else 0.8
        self.maxjshift = int(cfl * max(abs(ms.x1min), abs(ms.x1max))) + 1
        if self.oa_active and self.maxjshift > mbi.nx2:
            raise ValueError(
                f"orbital advection shift bound {self.maxjshift} exceeds "
                f"meshblock nx2={mbi.nx2}; use larger y-blocks")

        # x1 cell centers / faces per block, broadcastable
        nmb = mesh.nmb_total
        xc = np.empty((nmb, 1, 1, 1, mbi.ncells1))
        xf = np.empty((nmb, 1, 1, 1, mbi.ncells1 + 1))
        zc = np.empty((nmb, 1, mbi.ncells3, 1, 1))
        for gid in range(nmb):
            x1v, _, x3v = mesh.cell_centers(gid)
            x1f, _, _ = mesh.face_edges(gid)
            xc[gid, 0, 0, 0, :] = x1v
            xf[gid, 0, 0, 0, :] = x1f
            zc[gid, 0, :, 0, 0] = x3v
        self.xc = xc
        self.xf = xf
        self.zc = zc
        self.dy = ms.dx2
        self.multilevel = bool(getattr(mesh, "multilevel", False))
        # per-block level + y spacing: the sheared remap works in block-
        # local cell units, so every shift divides by the block's own dy
        # (reference: FindTargetMB resolves targets per level,
        # shearing_box.hpp:77; remap_fluxes.hpp works in local cells)
        self.mb_lev = np.asarray(getattr(
            mesh, "mb_lev", np.zeros(nmb, dtype=np.int64)))
        self.dyb = (ms.dx2 / (2.0 ** self.mb_lev)).reshape(-1, 1, 1, 1)
        if self.multilevel and self.oa_active:
            self._check_zslab(mesh)

        # ---- shear-periodic ring tables: for each x1-boundary block, the
        # gids of the OPPOSITE boundary column ordered by y (reference:
        # the sheared-overlap target search of shearing_box_cc.cpp:63-100).
        # On refined meshes the rings are built per level (z-slab
        # refinement keeps every x-row and its sheared partner at one
        # level), so each ring concatenates same-level blocks only.
        self.ring = {}
        maskm = mesh.phys_bc_mask.get("x1m")
        if maskm is not None and mesh.mesh_bcs["ix1"] == "shear_periodic":
            nrbx1, nrbx2 = self._nrbx(mesh)
            loc2gid = {(int(self.mb_lev[g]), int(l[0]), int(l[1]),
                        int(l[2])): g
                       for g, l in enumerate(mesh.lloc_eachmb)}
            levels = sorted(set(int(v) for v in self.mb_lev))
            for side in ("m", "p"):
                bmask = mesh.phys_bc_mask[f"x1{side}"]
                groups = []
                for lv in levels:
                    lmask = bmask & (self.mb_lev == lv)
                    if not lmask.any():
                        continue
                    n2b = nrbx2 << lv
                    src_lx1 = ((nrbx1 << lv) - 1) if side == "m" else 0
                    ring = np.zeros((nmb, n2b), dtype=np.int32)
                    for g in np.where(lmask)[0]:
                        _l1, _l2, l3 = mesh.lloc_eachmb[g]
                        for yi in range(n2b):
                            ring[g, yi] = loc2gid[(lv, src_lx1, yi,
                                                   int(l3))]
                    groups.append((lv, ring, lmask))
                if groups:
                    self.ring[side] = groups

    # ------------------------------------------------------------------
    @staticmethod
    def _nrbx(mesh):
        """Root-grid block counts (nrbx1, nrbx2): the tree's on refined
        meshes, the uniform decomposition otherwise."""
        t = getattr(mesh, "tree_nrbx", None)
        if t is not None:
            return int(t[0]), int(t[1])
        return int(mesh.nmb_x1), int(mesh.nmb_x2)

    def _check_zslab(self, mesh) -> None:
        """Refined shearing boxes must refine z-slabs spanning the full
        x and y extent: the sheared x1 rings then pair same-level
        columns and every x2 neighbor is same-level (the reference's
        general sheared-overlap search, shearing_box_cc.cpp:63-100,
        also only exercises this layout in its MRI decks)."""
        nrbx1, nrbx2 = mesh.tree_nrbx[0], mesh.tree_nrbx[1]
        have = {(int(self.mb_lev[g]), int(l[0]), int(l[1]), int(l[2]))
                for g, l in enumerate(mesh.lloc_eachmb)}
        for g, l in enumerate(mesh.lloc_eachmb):
            lv = int(self.mb_lev[g])
            l3 = int(l[2])
            for l1 in range(nrbx1 << lv):
                for l2 in range(nrbx2 << lv):
                    if (lv, l1, l2, l3) not in have:
                        raise NotImplementedError(
                            "shearing box with mesh refinement requires "
                            "z-slab refinement regions spanning the "
                            "full x1/x2 extent (block at level "
                            f"{lv}, lloc {tuple(int(v) for v in l)} has "
                            "a mixed-level x-row)")

    # ------------------------------------------------------------------
    def src_terms(self, u, w, beta_dt, is_ideal: bool, three_d: bool,
                  bcc=None):
        """(reference: shearing_box_srcterms.cpp:30-150; the MHD energy
        source subtracts the Maxwell stress q Om Bx By)."""
        om = self.omega0
        q = self.qshear
        den = w[:, IDN]
        mom1 = den * w[:, IVX]
        if not self.oa_active:
            # 2D r-z branch: the toroidal momentum is component 3
            # (reference: shearing_box_srcterms.cpp:66-81, 132-150)
            mom3 = den * w[:, IVZ]
            u = u.at[:, IM1].add(2.0 * beta_dt * om * mom3)
            u = u.at[:, IM3].add(-(2.0 - q) * beta_dt * om * mom1)
            if is_ideal:
                src = mom1 * mom3 / den
                if bcc is not None:
                    src = src - bcc[:, 0] * bcc[:, 2]
                u = u.at[:, IEN].add(beta_dt * q * om * src)
            return u
        mom2 = den * w[:, IVY]
        u = u.at[:, IM1].add(2.0 * beta_dt * om * mom2)
        u = u.at[:, IM2].add(-(2.0 - q) * beta_dt * om * mom1)
        if self.is_stratified:
            u = u.at[:, IM3].add(
                -beta_dt * om * om * den * self.zc[:, 0])
        if is_ideal:
            src = mom1 * mom2 / den
            if bcc is not None:
                src = src - bcc[:, 0] * bcc[:, 1]
            u = u.at[:, IEN].add(beta_dt * q * om * src)
        return u

    def src_terms_fc(self, e1, e2, bfc):
        """2D r-z orbital-flow EMF, E = -(v_K x B) with
        v_K = -q Omega x e_3: E1 -= q Om x1v B2, E2 += q Om x1f B1 on
        the cell-indexed edge arrays (reference: SourceTermsFC,
        shearing_box_srcterms.cpp:159-200; only needed in 2D)."""
        qo = self.qshear * self.omega0
        b1 = bfc["x1f"][..., :-1]      # face i-1/2 at cell index i
        b2 = bfc["x2f"][..., :-1, :]
        xv = self.xc[:, 0]             # [nmb, 1, 1, ncells1]
        xf = self.xf[:, 0][..., :-1]   # left edge of each cell
        e1 = e1 - qo * xv * b2
        e2 = e2 + qo * xf * b1
        return e1, e2

    # ------------------------------------------------------------------
    def _y_extended(self, arr, pad: int, face_normal_x1: bool = False):
        """Extend the active-y range of a 4D/5D array by ``pad`` cells on
        each side with neighbor data along x2 (periodic wrap).

        ``arr`` carries its own y-cell layout [.., ncells2(, ..)] with
        axis _JA-1 for 4D FC arrays handled by the caller."""
        mesh = self.mesh
        mbi = mesh.mb_indcs
        ng = mbi.ng
        js, je = mbi.js, mbi.je
        ja = arr.ndim - 2  # y axis for [..., n3, n2, n1] layouts
        n2 = arr.shape[ja]

        def yslc(lo, hi):
            idx = [slice(None)] * arr.ndim
            idx[ja] = slice(lo, hi)
            return tuple(idx)

        nbr_m = mesh.nbr_gid["x2m"]
        nbr_p = mesh.nbr_gid["x2p"]
        lo = jnp.take(arr[yslc(n2 - ng - pad, n2 - ng)], nbr_m, axis=0)
        hi = jnp.take(arr[yslc(ng, ng + pad)], nbr_p, axis=0)
        mid = arr[yslc(js, je + 1)]
        return jnp.concatenate([lo, mid, hi], axis=ja)

    # ------------------------------------------------------------------
    def orbital_advect(self, u, dt):
        """Advect every x1-column by the orbital shear displacement
        dy = -q Om x1 dt (reference: orbital_advection_cc.cpp:240-290).
        General in the y block decomposition: the profile is extended by
        ng+maxjshift neighbor cells before the remap."""
        if not self.oa_active:
            return u
        mbi = self.mesh.mb_indcs
        js, je = mbi.js, mbi.je
        nx2 = mbi.nx2
        pad = self.maxjshift + 2  # stencil guard for the PLM flux
        ext = self._y_extended(u, pad)
        shift = (-(self.qshear * self.omega0)
                 * jnp.asarray(self.xc) * dt) \
            / jnp.asarray(self.dyb[:, None])
        jo = jnp.floor(shift).astype(jnp.int32)
        eps = shift - jo

        # integer part: gather within the extended array (no wrap needed)
        ja = u.ndim - 2
        jgrid = jnp.arange(pad, pad + nx2)
        shp = [1] * u.ndim
        shp[ja] = nx2
        jgrid = jgrid.reshape(shp)
        idx = jnp.broadcast_to(jgrid - jo, ext.shape[:ja] + (nx2,)
                               + ext.shape[ja + 1:])
        g = jnp.take_along_axis(ext, idx, axis=ja)
        gm = jnp.take_along_axis(ext, idx - 1, axis=ja)
        gmm = jnp.take_along_axis(ext, idx - 2, axis=ja)
        gp = jnp.take_along_axis(ext, idx + 1, axis=ja)
        # fractional flux through j-1/2 and j+1/2 (eps in [0,1) via floor)
        dl = gm - gmm
        dr = g - gm
        sig_m = jnp.where(dl * dr > 0.0,
                          2.0 * dl * dr / (dl + dr + 1.0e-300), 0.0)
        flux = eps * (gm + 0.5 * (1.0 - eps) * sig_m)
        dl2 = g - gm
        dr2 = gp - g
        sig = jnp.where(dl2 * dr2 > 0.0,
                        2.0 * dl2 * dr2 / (dl2 + dr2 + 1.0e-300), 0.0)
        flux_p = eps * (g + 0.5 * (1.0 - eps) * sig)
        out = g - (flux_p - flux)
        return u.at[(slice(None),) * ja + (slice(js, je + 1),)].set(out)

    # ------------------------------------------------------------------
    def orbital_advect_fc(self, bfc, dt):
        """EMF-form orbital advection of the face fields (reference:
        orbital_advection_fc.cpp:180-361, after Stone & Gardiner 2010
        eqs. 49-52).  The y-remap of B1 and B3 is expressed as effective
        (time-integrated, dy-normalized) EMFs; B is then updated with a
        CT curl so div(B) is preserved exactly."""
        if not self.oa_active:
            return bfc
        mesh = self.mesh
        mbi = mesh.mb_indcs
        ng = mbi.ng
        js, je = mbi.js, mbi.je
        nx2 = mbi.nx2
        three_d = mbi.nx3 > 1
        qo = self.qshear * self.omega0
        pad = self.maxjshift + 2
        dyb4 = jnp.asarray(self.dyb)  # [nmb,1,1,1] block y spacing
        ms = mesh.mesh_size

        def eff_emf(arr, x1):
            """Effective EMF at y-faces j in [js, je+1] for a y-profile
            of B sampled like ``arr`` (4D [nmb, n3c, n2c, nX]):
            emf(j) = flx(j - jo) + sum of the jo cells crossed."""
            yshear = -qo * jnp.asarray(x1[:, 0]) * dt   # [nmb,1,1,nX]
            shift = yshear / dyb4
            jo = jnp.trunc(shift).astype(jnp.int32)
            eps = shift - jo
            ext = self._y_extended(arr, pad)
            ja = 2
            flx = _remap_flux(ext, eps, ja)
            # cumulative sum for the integer-cell transport
            csum = jnp.cumsum(ext, axis=ja)
            jgrid = jnp.arange(pad, pad + nx2 + 1).reshape(1, 1, -1, 1)
            tgt = jnp.broadcast_to(
                jgrid, ext.shape[:ja] + (nx2 + 1,) + ext.shape[ja + 1:])
            f_sh = jnp.take_along_axis(flx, tgt - jo, axis=ja)
            c_hi = jnp.take_along_axis(csum, tgt - 1, axis=ja)
            c_lo = jnp.take_along_axis(csum, tgt - jo - 1, axis=ja)
            # sum_{jj=1..jo} b(jf-jj)  (sign handles jo<0 too)
            cells = c_hi - c_lo
            return f_sh + cells

        x1f, x2f = bfc["x1f"], bfc["x2f"]
        x3f = bfc["x3f"]
        ks, ke = mbi.ks, mbi.ke
        is_, ie = mbi.is_, mbi.ie
        # emfz = +Vy Bx remap at x1-FACES (uses B1 profile);
        # [nmb, n3c, nx2+1, n1+1], y index 0..nx2 <-> faces js..je+1
        emfz = eff_emf(x1f, self.xf)
        # emfx = -Vy Bz remap at x1-CENTERS (uses B3 profile);
        # [nmb, n3c+1, nx2+1, n1], k index = x3-face layout
        emfx = -eff_emf(x3f, self.xc) if three_d else None

        # ---- CT update over the active region (reference:
        # orbital_advection_fc.cpp oaCT-b1/b2/b3 loops)
        # B1: b1 -= d(emfz)/dy
        nb1 = x1f.at[:, ks:ke + 1, js:je + 1, :].add(
            -(emfz[:, ks:ke + 1, 1:nx2 + 1, :]
              - emfz[:, ks:ke + 1, 0:nx2, :]))
        # B2: b2 += (dy/dx)*d(emfz)/dx [- (dy/dz)*d(emfx)/dz]
        dydx = self.dy / ms.dx1  # level-invariant ratio
        d_emfz = emfz[..., 1:] - emfz[..., :-1]   # at x1 cell centers
        nb2 = x2f.at[:, ks:ke + 1, js:je + 2, is_:ie + 1].add(
            dydx * d_emfz[:, ks:ke + 1, :, is_:ie + 1])
        if emfx is not None:
            dydz = self.dy / ms.dx3  # level-invariant ratio
            d_emfx = emfx[:, 1:, :, :] - emfx[:, :-1, :, :]
            nb2 = nb2.at[:, ks:ke + 1, js:je + 2, is_:ie + 1].add(
                -dydz * d_emfx[:, ks:ke + 1, :, is_:ie + 1])
        # B3: b3 += d(emfx)/dy
        nb3 = x3f
        if emfx is not None:
            nb3 = x3f.at[:, ks:ke + 2, js:je + 1, :].add(
                emfx[:, ks:ke + 2, 1:nx2 + 1, :]
                - emfx[:, ks:ke + 2, 0:nx2, :])
        return {"x1f": nb1, "x2f": nb2, "x3f": nb3}

    # ------------------------------------------------------------------
    def _ring_remap_one(self, u, ring_gids, s, slab_idx, ja,
                        win_lo: int, win_hi: int):
        """Assemble the full azimuthal ring of the opposite x1-boundary
        column (one level's gids), shift it by ``s`` cells, and return
        each boundary block's window of global-y samples
        [lx2*nx2 + win_lo, lx2*nx2 + win_hi) (periodic)."""
        mesh = self.mesh
        mbi = mesh.mb_indcs
        nx2 = mbi.nx2
        n2b = ring_gids.shape[1]
        ny = n2b * nx2

        slab = u[slab_idx]   # y extent = nx2 active samples per block
        parts = [jnp.take(slab, ring_gids[:, yi], axis=0)
                 for yi in range(n2b)]
        ring = jnp.concatenate(parts, axis=ja)   # y extent = ny
        shifted = _plm_remap(ring, s, axis=ja)
        lx2 = np.asarray(mesh.lloc_eachmb[:, 1])
        win = (np.arange(win_lo, win_hi)[None, :]
               + (lx2 * nx2)[:, None]) % ny     # [nmb, win_hi-win_lo]
        out = jnp.take_along_axis(
            shifted, jnp.asarray(win).reshape(
                (-1,) + (1,) * (ja - 1) + (win_hi - win_lo,)
                + (1,) * (u.ndim - 1 - ja)), axis=ja)
        return out

    def _ring_remap(self, u, side: str, s_phys, slab_idx, ja,
                    win_lo: int, win_hi: int):
        """Per-level sheared window assembly.  ``s_phys`` is the shift
        in PHYSICAL y units; each level divides by its own dy (cells).
        Returns (win, bmask) with rows valid where bmask — mixing the
        per-level results where each level's boundary mask holds."""
        mbi = self.mesh.mb_indcs
        out = None
        bmask = np.zeros(u.shape[0], dtype=bool)
        for lv, ring_gids, lmask in self.ring[side]:
            dy_lv = self.dy / (2.0 ** lv)
            win = self._ring_remap_one(u, ring_gids, s_phys / dy_lv,
                                       slab_idx, ja, win_lo, win_hi)
            if out is None:
                out = win
            else:
                m = jnp.asarray(lmask).reshape(
                    (-1,) + (1,) * (win.ndim - 1))
                out = jnp.where(m, win, out)
            bmask |= np.asarray(lmask)
        return out, bmask

    # ------------------------------------------------------------------
    def remap_ghosts(self, u, t):
        """y-shift the shear-periodic x1 ghost slabs by +/- yshear(t)
        (reference: shearing_box_cc.cpp:63-140).  Assembles the opposite
        boundary column's full ring, so any y block decomposition works;
        the slab's y-corner rows are refilled too."""
        if not self.oa_active:
            return u
        mesh = self.mesh
        mbi = mesh.mb_indcs
        ng = mbi.ng
        n1 = mbi.ncells1
        n2 = mbi.ncells2
        js, je = mbi.js, mbi.je
        yshear = self.qshear * self.omega0 * self.lx * t
        ja = u.ndim - 2

        if "m" in self.ring:
            slab_idx = (slice(None), slice(None), slice(None),
                        slice(js, je + 1), slice(n1 - 2 * ng, n1 - ng))
            win, bmask = self._ring_remap(u, "m", yshear, slab_idx, ja,
                                          -ng, n2 - ng)
            mb = jnp.asarray(bmask).reshape((-1,) + (1,) * (u.ndim - 1))
            cur = u[:, :, :, :, 0:ng]
            u = u.at[:, :, :, :, 0:ng].set(jnp.where(mb, win, cur))
        if "p" in self.ring:
            slab_idx = (slice(None), slice(None), slice(None),
                        slice(js, je + 1), slice(ng, 2 * ng))
            win, bmask = self._ring_remap(u, "p", -yshear, slab_idx, ja,
                                          -ng, n2 - ng)
            mb = jnp.asarray(bmask).reshape((-1,) + (1,) * (u.ndim - 1))
            cur = u[:, :, :, :, n1 - ng:n1]
            u = u.at[:, :, :, :, n1 - ng:n1].set(jnp.where(mb, win, cur))
        return u

    # ------------------------------------------------------------------
    def remap_ghosts_fc(self, bfc, t):
        """Shear-periodic remap of the face-field x1 ghost slabs
        (reference: shearing_box_fc.cpp:60-140; each component's ghost
        profile is conservatively remapped in y like the CC variables;
        the x1min/x1max shared faces stay locally owned)."""
        if not self.oa_active:
            return bfc
        mesh = self.mesh
        mbi = mesh.mb_indcs
        ng = mbi.ng
        js, je = mbi.js, mbi.je
        yshear = self.qshear * self.omega0 * self.lx * t

        mbi2 = mbi
        n2c = mbi2.ncells2
        out = dict(bfc)
        for comp, arr in bfc.items():
            ja = 2
            nrm_x1 = comp == "x1f"
            n1 = arr.shape[3]
            nxa = mbi.nx1
            # y window length: cell layout for x1f/x3f, face layout
            # (one extra sample) for x2f; the ring itself always holds
            # one sample per y position (x2f drops its duplicated
            # closing face, which the window re-reads periodically)
            extra = 1 if comp == "x2f" else 0
            for side, sgn in (("m", +1.0), ("p", -1.0)):
                if side not in self.ring:
                    continue
                if nrm_x1:
                    # ghost faces strictly beyond the shared face
                    dn = slice(nxa, nxa + ng) if side == "m" \
                        else slice(ng + 1, 2 * ng + 1)
                    my = slice(0, ng) if side == "m" \
                        else slice(nxa + ng + 1, nxa + 2 * ng + 1)
                else:
                    dn = slice(n1 - 2 * ng, n1 - ng) if side == "m" \
                        else slice(ng, 2 * ng)
                    my = slice(0, ng) if side == "m" \
                        else slice(n1 - ng, n1)
                slab_idx = (slice(None), slice(None),
                            slice(js, je + 1), dn)
                win, bmask = self._ring_remap(arr, side, sgn * yshear,
                                              slab_idx, ja,
                                              -ng, n2c - ng + extra)
                mb = jnp.asarray(bmask).reshape((-1, 1, 1, 1))
                cur = arr[:, :, :, my]
                arr = arr.at[:, :, :, my].set(jnp.where(mb, win, cur))
            out[comp] = arr
        return out
