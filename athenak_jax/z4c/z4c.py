"""Z4c evolution system (vacuum) with puncture gauge.

Parity target: the reference Z4c solver
(reference: src/z4c/z4c.hpp:45-186, z4c_calcrhs.cpp:180-590,
z4c_gauge.cpp, z4c.cpp:254-310 AlgConstr, z4c_adm.cpp, z4c_newdt.cpp),
implementing the conformal Z4 formulation of Bernuzzi & Hilditch (2010)
and Hilditch et al. (2013): 22 evolved fields (chi, conformal metric,
Khat = K - 2 Theta, traceless A_ij, Gamma^i, Theta, 1+log lapse,
gamma-driver shift), with Kreiss-Oliger dissipation and algebraic
constraint projection.

Design: one pure vectorized RHS over [nmb, 22, n3, n2, n1];
the tensor loops unroll at trace time into whole-array roll-stencil ops
that XLA fuses (the reference's 591-line per-point kernel becomes a
single fused XLA computation).
"""

from __future__ import annotations

import itertools
import math

import jax.numpy as jnp
import numpy as np

from . import fd

# evolved-variable channel indices (reference: z4c.hpp:46-56)
I_CHI = 0
I_GXX, I_GXY, I_GXZ, I_GYY, I_GYZ, I_GZZ = 1, 2, 3, 4, 5, 6
I_KHAT = 7
I_AXX, I_AXY, I_AXZ, I_AYY, I_AYZ, I_AZZ = 8, 9, 10, 11, 12, 13
I_GAMX, I_GAMY, I_GAMZ = 14, 15, 16
I_THETA = 17
I_ALPHA = 18
I_BETAX, I_BETAY, I_BETAZ = 19, 20, 21
NZ4C = 22

_SYM = {(0, 0): 0, (0, 1): 1, (0, 2): 2, (1, 1): 3, (1, 2): 4, (2, 2): 5}


def sym_idx(a, b):
    return _SYM[(a, b) if a <= b else (b, a)]


def _sym_pairs():
    return [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]


def spatial_det(g):
    """det of a symmetric 3x3 field given as list-of-lists of arrays."""
    return (g[0][0] * (g[1][1] * g[2][2] - g[1][2] * g[1][2])
            - g[0][1] * (g[0][1] * g[2][2] - g[0][2] * g[1][2])
            + g[0][2] * (g[0][1] * g[1][2] - g[0][2] * g[1][1]))


def spatial_inv(g, detg):
    """Inverse of a symmetric 3x3 field (list-of-lists)."""
    i = 1.0 / detg
    gu = [[None] * 3 for _ in range(3)]
    gu[0][0] = (g[1][1] * g[2][2] - g[1][2] * g[1][2]) * i
    gu[0][1] = (g[0][2] * g[1][2] - g[0][1] * g[2][2]) * i
    gu[0][2] = (g[0][1] * g[1][2] - g[0][2] * g[1][1]) * i
    gu[1][1] = (g[0][0] * g[2][2] - g[0][2] * g[0][2]) * i
    gu[1][2] = (g[0][1] * g[0][2] - g[0][0] * g[1][2]) * i
    gu[2][2] = (g[0][0] * g[1][1] - g[0][1] * g[0][1]) * i
    gu[1][0], gu[2][0], gu[2][1] = gu[0][1], gu[0][2], gu[1][2]
    return gu


class Z4cOptions:
    def __init__(self, pin) -> None:
        gor = pin.get_or_add_real
        self.chi_psi_power = gor("z4c", "chi_psi_power", -4.0)
        self.chi_div_floor = gor("z4c", "chi_div_floor", -1000.0)
        self.chi_min_floor = gor("z4c", "chi_min_floor", 1e-12)
        self.diss = gor("z4c", "diss", 0.0)
        self.eps_floor = gor("z4c", "eps_floor", 1e-12)
        self.damp_kappa1 = gor("z4c", "damp_kappa1", 0.0)
        self.damp_kappa2 = gor("z4c", "damp_kappa2", 0.0)
        self.lapse_harmonicf = gor("z4c", "lapse_harmonicf", 1.0)
        self.lapse_harmonic = gor("z4c", "lapse_harmonic", 0.0)
        self.lapse_oplog = gor("z4c", "lapse_oplog", 2.0)
        self.lapse_advect = gor("z4c", "lapse_advect", 1.0)
        self.shift_ggamma = gor("z4c", "shift_Gamma", 1.0)
        self.shift_advect = gor("z4c", "shift_advect", 1.0)
        self.shift_alpha2ggamma = gor("z4c", "shift_alpha2Gamma", 0.0)
        self.shift_hh = gor("z4c", "shift_H", 0.0)
        self.shift_eta = gor("z4c", "shift_eta", 2.0)
        self.use_z4c = 1.0 if pin.get_or_add_boolean(
            "z4c", "use_z4c", True) else 0.0


class Z4c:
    """Vacuum Z4c evolution on the MeshBlockPack layout."""

    is_mhd = False
    nvar = NZ4C

    def __init__(self, pin, mesh, bvals) -> None:
        self.mesh = mesh
        self.bvals = bvals
        self.opt = Z4cOptions(pin)
        self.multilevel = bool(getattr(mesh, "multilevel", False))
        mbi = mesh.mb_indcs
        self.ng = mbi.ng
        if self.ng not in (2, 3, 4, 5):
            raise ValueError("Z4c requires nghost in {2,3,4,5} "
                             "(2nd/4th/6th/8th-order FD)")
        ms = mesh.mesh_size
        if self.multilevel:
            # per-block (level-dependent) inverse spacings, broadcast
            # against the [nmb, n3, n2, n1] channel fields; idx5 is the
            # 5D variant for whole-state ops (KO dissipation)
            self.idx = tuple(
                (1.0 / mesh.mb_size[f"dx{d}"]).reshape(-1, 1, 1, 1)
                for d in (1, 2, 3))
            self.idx5 = tuple(
                (1.0 / mesh.mb_size[f"dx{d}"]).reshape(-1, 1, 1, 1, 1)
                for d in (1, 2, 3))
            if self.ng < 4:
                raise ValueError(
                    "Z4c on refined meshes needs nghost >= 4 (4th-order "
                    "mixed-level prolongation; reference: "
                    "prolongation.hpp:247-283)")
            bvals.prolong_order = 4
        else:
            self.idx = (1.0 / ms.dx1, 1.0 / ms.dx2, 1.0 / ms.dx3)
            self.idx5 = self.idx
        # dissipation scale (reference: z4c.cpp:158)
        self.diss = (self.opt.diss * 2.0 ** (-2.0 * self.ng)
                     * (-1.0 if self.ng % 2 == 0 else 1.0))
        self.shape = (mesh.nmb_total, NZ4C,
                      mbi.ncells3, mbi.ncells2, mbi.ncells1)
        self.time_evolution = "dynamic"
        # hooks absent for this physics
        self.pturb = None
        self.ppart = None
        self.psbox = None
        self.eos = None

        # compact-object (puncture) trackers: positions are DEVICE state
        # (state["co_pos"]) integrated on-device each cycle; radius +
        # reflevel feed the <z4c_amr> tracker criterion (reference:
        # src/z4c/compact_object_tracker.cpp:66-73)
        self.nco = pin.get_or_add_integer("z4c", "nco", 0)
        self.tracker_pos0 = np.array(
            [[pin.get_or_add_real("z4c", f"co_{n}_x", 0.0),
              pin.get_or_add_real("z4c", f"co_{n}_y", 0.0),
              pin.get_or_add_real("z4c", f"co_{n}_z", 0.0)]
             for n in range(self.nco)], dtype=np.float64).reshape(-1, 3)
        self.tracker_radius = np.array(
            [pin.get_or_add_real("z4c", f"co_{n}_radius", 0.0)
             for n in range(self.nco)])
        self.tracker_reflevel = np.array(
            [pin.get_or_add_integer("z4c", f"co_{n}_reflevel", -1)
             for n in range(self.nco)], dtype=np.int64)

        # Sommerfeld boundary mask: outermost active layer of blocks whose
        # mesh face is outflow/diode/vacuum/user (reference:
        # Z4c::Z4cBoundaryRHS, z4c_Sbc.cpp:127-210)
        sbc_flags = ("outflow", "diode", "vacuum", "user")
        mask = np.zeros((mesh.nmb_total, mbi.ncells3, mbi.ncells2,
                         mbi.ncells1), dtype=bool)
        any_sbc = False
        layers = {
            "x1m": (slice(None), slice(None), slice(mbi.is_, mbi.is_ + 1)),
            "x1p": (slice(None), slice(None), slice(mbi.ie, mbi.ie + 1)),
            "x2m": (slice(None), slice(mbi.js, mbi.js + 1), slice(None)),
            "x2p": (slice(None), slice(mbi.je, mbi.je + 1), slice(None)),
            "x3m": (slice(mbi.ks, mbi.ks + 1), slice(None), slice(None)),
            "x3p": (slice(mbi.ke, mbi.ke + 1), slice(None), slice(None)),
        }
        face_of = {"x1m": "ix1", "x1p": "ox1", "x2m": "ix2", "x2p": "ox2",
                   "x3m": "ix3", "x3p": "ox3"}
        for key, sl in layers.items():
            if mesh.mesh_bcs[face_of[key]] in sbc_flags:
                any_sbc = True
                for gid in np.where(mesh.phys_bc_mask[key])[0]:
                    mask[(gid,) + sl] = True
        self.sbc_mask = mask if any_sbc else None
        if self.sbc_mask is not None:
            # pseudo-radial unit vector and radius at cell centers
            nmb = mesh.nmb_total
            xc = np.empty((nmb, 1, 1, mbi.ncells1))
            yc = np.empty((nmb, 1, mbi.ncells2, 1))
            zc = np.empty((nmb, mbi.ncells3, 1, 1))
            for gid in range(nmb):
                x1v, x2v, x3v = mesh.cell_centers(gid)
                xc[gid, 0, 0, :] = x1v
                yc[gid, 0, :, 0] = x2v
                zc[gid, :, 0, 0] = x3v
            self._sbc_xyz = (xc, yc, zc)

    # ------------------------------------------------------------------
    def coords_bcast(self):
        """Per-block cell-center coordinates as broadcastable numpy arrays
        ([nmb,1,1,n1], [nmb,1,n2,1], [nmb,n3,1,1]); built lazily, stays
        host-side so jit embeds them as constants."""
        if getattr(self, "_coords_bcast", None) is None:
            mesh = self.mesh
            mbi = mesh.mb_indcs
            nmb = mesh.nmb_total
            xc = np.empty((nmb, 1, 1, mbi.ncells1))
            yc = np.empty((nmb, 1, mbi.ncells2, 1))
            zc = np.empty((nmb, mbi.ncells3, 1, 1))
            for gid in range(nmb):
                x1v, x2v, x3v = mesh.cell_centers(gid)
                xc[gid, 0, 0, :] = x1v
                yc[gid, 0, :, 0] = x2v
                zc[gid, :, 0, 0] = x3v
            self._coords_bcast = (xc, yc, zc)
        return self._coords_bcast

    # ------------------------------------------------------------------
    @staticmethod
    def unpack(u):
        """Channel views as python structures of 4D arrays."""
        chi = u[:, I_CHI]
        g = [[u[:, I_GXX + sym_idx(a, b)] for b in range(3)]
             for a in range(3)]
        khat = u[:, I_KHAT]
        A = [[u[:, I_AXX + sym_idx(a, b)] for b in range(3)]
             for a in range(3)]
        gam = [u[:, I_GAMX + a] for a in range(3)]
        theta = u[:, I_THETA]
        alpha = u[:, I_ALPHA]
        beta = [u[:, I_BETAX + a] for a in range(3)]
        return chi, g, khat, A, gam, theta, alpha, beta

    # ------------------------------------------------------------------
    def rhs(self, u, time=0.0, tmunu=None):
        """Full Z4c right-hand side (reference: Z4c::CalcRHS,
        z4c_calcrhs.cpp:180-590).  ``tmunu`` adds the matter source
        terms for dynamical GRMHD (reference: z4c/tmunu.hpp).

        The tensor physics lives in rhs_core.rhs_core; this path binds it
        to whole-array jnp.roll stencils."""
        from .rhs_core import rhs_core
        ops = _WholeArrayOps(self, [u[:, I_BETAX + a] for a in range(3)])
        out = rhs_core(lambda c: u[:, c], ops, self.opt, self.diss,
                       tmunu=tmunu)
        return jnp.stack(out, axis=1)

    # ------------------------------------------------------------------
    def alg_constr(self, u):
        """det(conformal g)=1 and tr A=0 projection
        (reference: Z4c::AlgConstr, z4c.cpp:258-310)."""
        chi, g, khat, A, gam, theta, alpha, beta = self.unpack(u)
        detg = spatial_det(g)
        detg = jnp.where(detg > 0.0, detg, 1.0)
        oopsi4 = jnp.cbrt(1.0 / detg)
        gs = [[g[a][b] * oopsi4 for b in range(3)] for a in range(3)]
        gu = spatial_inv(gs, jnp.ones_like(detg))
        trA = sum(gu[a][b] * A[a][b] for a in range(3) for b in range(3))
        for a, b in _sym_pairs():
            u = u.at[:, I_GXX + sym_idx(a, b)].set(gs[a][b])
            u = u.at[:, I_AXX + sym_idx(a, b)].set(
                A[a][b] - (1.0 / 3.0) * gs[a][b] * trA)
        # chi floor
        u = u.at[:, I_CHI].max(self.opt.chi_min_floor)
        return u

    # ------------------------------------------------------------------
    def adm_constraints(self, u, full: bool = False):
        """Hamiltonian and momentum constraint monitors
        (reference: z4c_calculate_adm_constraints.cpp).  Returns (H, M2)
        fields (M2 = norm-squared of the momentum constraint); with
        ``full`` a dict additionally carrying the covariant momentum
        components M_d, the Z violation (z4c_adm.cpp:511-517) and the
        C^2 monitor H^2 + M^2 + Theta^2 + 4Z (z4c_adm.cpp:519-520)."""
        opt = self.opt
        ng = self.ng
        idx = self.idx
        chi, g, khat, A, gam, theta, alpha, beta = self.unpack(u)

        def D1(f, d):
            return fd.d1(f, d, idx, ng)

        K = khat + 2.0 * theta
        detg = spatial_det(g)
        gu = spatial_inv(g, detg)
        dg = [[[D1(g[a][b], d) for b in range(3)] for a in range(3)]
              for d in range(3)]
        dchi = [D1(chi, d) for d in range(3)]
        dkhat = [D1(khat, d) for d in range(3)]
        dtheta = [D1(theta, d) for d in range(3)]
        dgam = [[D1(gam[a], d) for a in range(3)] for d in range(3)]
        Gddd = [[[0.5 * (dg[a][b][c] + dg[b][a][c] - dg[c][a][b])
                  for b in range(3)] for a in range(3)] for c in range(3)]
        Gudd = [[[sum(gu[c][d] * Gddd[d][a][b] for d in range(3))
                  for b in range(3)] for a in range(3)] for c in range(3)]
        gam_c = [sum(gu[b][c] * Gudd[a][b][c]
                     for b in range(3) for c in range(3)) for a in range(3)]

        chi_g = jnp.maximum(chi, opt.chi_min_floor)
        oopsi4 = chi_g ** (-4.0 / opt.chi_psi_power)
        npow = opt.chi_psi_power
        dphi = [dchi[a] / (chi_g * npow) for a in range(3)]

        # Ricci as in rhs
        ddg = {}
        for a, b in itertools.combinations_with_replacement(range(3), 2):
            for c, d in _sym_pairs():
                if a == b:
                    ddg[(a, b, c, d)] = fd.d2(g[c][d], a, idx, ng)
                else:
                    ddg[(a, b, c, d)] = fd.d1d1(g[c][d], a, b, idx, ng)

        def DDg(a, b, c, d):
            a, b = (a, b) if a <= b else (b, a)
            c, d = (c, d) if c <= d else (d, c)
            return ddg[(a, b, c, d)]

        ddchi = [[fd.d2(chi, a, idx, ng) if a == b
                  else fd.d1d1(chi, min(a, b), max(a, b), idx, ng)
                  for b in range(3)] for a in range(3)]

        Rdd = [[None] * 3 for _ in range(3)]
        for a, b in _sym_pairs():
            # Gam^c (Gamma_{a,bc} + Gamma_{b,ac}) — see rhs_core.py /
            # reference z4c_calcrhs.cpp:309-311 for the index placement
            r = sum(0.5 * (g[c][a] * dgam[b][c] + g[c][b] * dgam[a][c]
                           + gam_c[c] * (Gddd[a][b][c] + Gddd[b][a][c]))
                    for c in range(3))
            r = r - sum(0.5 * gu[c][d] * DDg(c, d, a, b)
                        for c in range(3) for d in range(3))
            r = r + sum(gu[c][d] * (Gudd[e][c][a] * Gddd[b][e][d]
                                    + Gudd[e][c][b] * Gddd[a][e][d]
                                    + Gudd[e][a][d] * Gddd[e][c][b])
                        for c in range(3) for d in range(3)
                        for e in range(3))
            Rdd[a][b] = r
            Rdd[b][a] = r
        Ddphi = [[None] * 3 for _ in range(3)]
        for a, b in _sym_pairs():
            v = (ddchi[a][b] / (chi_g * npow) - npow * dphi[a] * dphi[b]
                 - sum(Gudd[c][a][b] * dphi[c] for c in range(3)))
            Ddphi[a][b] = v
            Ddphi[b][a] = v
        trDdphi = sum(gu[c][d] * (Ddphi[c][d] + 2.0 * dphi[c] * dphi[d])
                      for c in range(3) for d in range(3))
        Rphi = [[4.0 * dphi[a] * dphi[b] - 2.0 * Ddphi[a][b]
                 - 2.0 * g[a][b] * trDdphi for b in range(3)]
                for a in range(3)]

        AA = sum(gu[a][c] * gu[b][d] * A[a][b] * A[c][d]
                 for a in range(3) for b in range(3)
                 for c in range(3) for d in range(3))
        R = sum(oopsi4 * gu[a][b] * (Rdd[a][b] + Rphi[a][b])
                for a in range(3) for b in range(3))
        H = R + (2.0 / 3.0) * K * K - AA

        # momentum constraint: M^a = D_b A^{ab} - (3/2) A^{ab} dphi... use
        # M_d = d_b A^b_d - Gamma terms - (2/3) d_d K + conformal terms
        dA = [[[fd.d1(A[a][b], d, idx, ng) for b in range(3)]
               for a in range(3)] for d in range(3)]
        M = []
        for a in range(3):
            v = sum(gu[b][c] * (dA[b][c][a]
                                - sum(Gudd[e][b][c] * A[e][a]
                                      + Gudd[e][b][a] * A[c][e]
                                      for e in range(3)))
                    for b in range(3) for c in range(3))
            v = v - (3.0 / 2.0) * sum(
                gu[b][c] * A[c][a] * dchi[b] / chi_g for b in range(3)
                for c in range(3))
            v = v - (2.0 / 3.0) * (dkhat[a] + 2.0 * dtheta[a])
            M.append(v)
        M2 = sum(gu[a][b] * M[a] * M[b] for a in range(3) for b in range(3))
        if not full:
            return H, M2
        Z = 0.25 * sum(g[a][b] * (gam[a] - gam_c[a]) * (gam[b] - gam_c[b])
                       for a in range(3) for b in range(3))
        C = H * H + M2 + theta * theta + 4.0 * Z
        return {"H": H, "M2": M2, "M_d": M, "Z": Z, "C": C}

    # ------------------------------------------------- state-dict interface
    def make_state(self, u):
        state = {"u": u, "w": u}
        if self.nco > 0:
            state["co_pos"] = jnp.asarray(self.tracker_pos0, u.dtype)
        return state

    def post_cycle(self, state, dt):
        """After-timeintegrator tasks: advance the puncture trackers,
        dx/dt = -beta(x), Euler with the post-cycle shift (reference:
        CompactObjectTracker::InterpolateShift + EvolveTracker,
        compact_object_tracker.cpp:100-150) — on device, inside the
        jitted cycle."""
        if self.nco == 0 or "co_pos" not in state:
            return state
        from .z4c_amr import device_interp
        pos = state["co_pos"]
        u = state["u"]
        beta = device_interp(self.mesh, u,
                             [I_BETAX + a for a in range(3)], pos)
        return dict(state, co_pos=pos - dt * beta)

    def save_state(self, state):
        return {"u1": state["u"]}

    def accumulate_rk4(self, saved, state, delta):
        return {"u1": saved["u1"] + delta * state["u"]}

    def init_ghosts(self, state):
        u = self.bvals.fill_ghosts(state["u"])
        u = self.alg_constr(u)
        return dict(state, u=u, w=u)

    def cons_to_prim(self, u):
        return u, u, {}

    def stage_update(self, state, saved, gam0, gam1, beta_dt, tmunu=None):
        """One RK stage: RHS -> update -> chi floor -> halo -> algebraic
        constraints (reference task chain: z4c_tasks.cpp:48-85)."""
        u = state["u"]
        rhs = self.rhs(u, tmunu=tmunu)
        u = gam0 * u + gam1 * saved["u1"] + beta_dt * rhs
        u = self.bvals.fill_ghosts(u)
        u = self.alg_constr(u)
        return dict(state, u=u, w=u), {}

    def dt_from_state(self, state):
        """dt = min cell size (unit light speed, reference:
        z4c_newdt.cpp:26-60)."""
        mbi = self.mesh.mb_indcs
        if self.multilevel:
            dt = float(np.min(self.mesh.mb_size["dx1"]))
            if mbi.nx2 > 1:
                dt = min(dt, float(np.min(self.mesh.mb_size["dx2"])))
            if mbi.nx3 > 1:
                dt = min(dt, float(np.min(self.mesh.mb_size["dx3"])))
        else:
            ms = self.mesh.mesh_size
            dt = ms.dx1
            if mbi.nx2 > 1:
                dt = min(dt, ms.dx2)
            if mbi.nx3 > 1:
                dt = min(dt, ms.dx3)
        return jnp.asarray(dt, dtype=state["u"].dtype)


class _WholeArrayOps:
    """Whole-array FD backend for rhs_core: jnp.roll stencils over
    [nmb, n3, n2, n1] channel fields (fd.py operators)."""

    def __init__(self, z, beta):
        from ..comm import local_blocks
        self._z = z
        self._beta = beta
        # per-block idx tables (multilevel) localize to the device's
        # rows inside the shard_map cycle; scalars pass through
        self._idx = tuple(local_blocks(i, pad_edge=True) for i in z.idx)
        self._ng = z.ng

    def d1(self, f, d):
        return fd.d1(f, d, self._idx, self._ng)

    def d2(self, f, da, db):
        if da == db:
            return fd.d2(f, da, self._idx, self._ng)
        return fd.d1d1(f, min(da, db), max(da, db), self._idx, self._ng)

    def ladv(self, f):
        out = None
        for d in range(3):
            t = fd.adv(self._beta[d], f, d, self._idx, self._ng)
            out = t if out is None else out + t
        return out

    def ko(self, f):
        out = None
        for d in range(3):
            t = fd.ko_diss(f, d, self._idx, self._ng)
            out = t if out is None else out + t
        return out

    def d1_o2(self, f, d):
        return fd.d1(f, d, self._idx, 2)

    @staticmethod
    def center(f):
        return f

    def sbc(self):
        from ..comm import local_blocks
        z = self._z
        if z.sbc_mask is None:
            return None
        xc = local_blocks(z._sbc_xyz[0])
        yc = local_blocks(z._sbc_xyz[1])
        zc = local_blocks(z._sbc_xyz[2])
        r = jnp.sqrt(xc * xc + yc * yc + zc * zc)
        return (jnp.asarray(local_blocks(z.sbc_mask)), r,
                (xc / r, yc / r, zc / r))
