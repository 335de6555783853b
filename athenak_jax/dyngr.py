"""Dynamical GRMHD: MHD on an evolving (or fixed) ADM spacetime.

Parity target: the reference ``DynGRMHD``/``DynGRMHDPS`` stack
(reference: src/dyn_grmhd/dyn_grmhd.{hpp,cpp},
dyn_grmhd_fluxes.cpp, rsolvers/{flux,llf,hlle}_dyn_grmhd.hpp,
z4c/tmunu.{hpp,cpp}).  Design:

  * The conserved state u = sqrt(gamma)-densitized (D, S_i, tau); the
    face field bfc is the densitized B-tilde, so the whole CT machinery
    (corner EMFs, curl update, FC halo exchange) is BORROWED unchanged
    from the Newtonian MHD class — only the cell-centered transport EMF
    E = -(alpha v - beta) x B-tilde differs (mhd_corner_e.cpp ADM branch).
  * The EOS is the policy-based primitive-solver framework (eos_ps/):
    ideal / piecewise-polytrope / tabulated CompOSE, with the vectorized
    Kastaun mu-root c2p.
  * Spacetime: with a <z4c> block, the full coupled evolution runs —
    Tmunu computed from the fluid enters the Z4c RHS, and the ADM
    variables (gamma_ij, K_ij, alpha, beta) are derived pointwise from
    the Z4c state each stage (the reference's SetADMVariables).  Without
    <z4c>, the ADM background from the problem generator stays fixed
    (the reference's "<mhd>+<adm>" fixed-spacetime mode used by the
    dyngr shocktube tests, tst/test_suite/dyngrmhd/).

State dict: {"u", "w", "T", "bfc", "bcc"[, "z"]} where w stores
[rho, Wv^x, Wv^y, Wv^z, P] (utilde velocity) and T the temperature.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import jax.numpy as jnp
import numpy as np

from .bvals import BoundaryValues, _AXIS_OF
from .eos_ps import (PrimitiveSolverPS, contract, lower, make_policy,
                     raise_, spatial_det, spatial_inv, sym6)
from .indices import IDN, IEN, IVX, IVY, IVZ, RECON_NGHOST
from .mesh import Mesh
from .ops import recon as recon_ops
from .physics.mhd import MHD
from .z4c import fd


def adm_from_z4c(z4c, z):
    """Pointwise ADM variables from the Z4c state (reference:
    Z4c::Z4cToADM, z4c_adm.cpp): gamma_ij = g-tilde_ij / chi,
    K_ij = (A-tilde_ij + gamma-tilde_ij K/3) / chi with chi = psi^-4."""
    chi, g, khat, A, gam, theta, alpha, beta = z4c.unpack(z)
    chi_g = jnp.maximum(chi, z4c.opt.chi_min_floor)
    oopsi4 = chi_g ** (-4.0 / z4c.opt.chi_psi_power)   # = chi for -4
    K = khat + 2.0 * theta
    g3d = [g[a][b] / oopsi4 for (a, b) in
           ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]
    K_dd = [(A[a][b] + g[a][b] * K / 3.0) / oopsi4 for (a, b) in
            ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]
    return {"g3d": g3d, "alpha": alpha, "beta_u": beta, "K_dd": K_dd}


class DynGRMHD:
    """Composed physics module: primitive-solver MHD (+ optional Z4c)."""

    is_mhd = True

    # CT / face-field / update machinery shared with Newtonian MHD
    compute_bcc = MHD.compute_bcc
    corner_e = MHD.corner_e
    ct_update = MHD.ct_update
    _to_face = staticmethod(MHD._to_face)
    fill_ghosts_fc = MHD.fill_ghosts_fc
    _fc_fill_corners = MHD._fc_fill_corners
    _phys_bc_fc = MHD._phys_bc_fc
    _add_resist = MHD._add_resist
    rk_update = MHD.rk_update
    _ml_fc_override = MHD._ml_fc_override

    def __init__(self, pin, mesh: Mesh, bvals: BoundaryValues) -> None:
        self.mesh = mesh
        self.bvals = bvals
        self.multilevel = bool(getattr(mesh, "multilevel", False))
        if self.multilevel:
            bvals.prolong_prims = pin.get_or_add_boolean(
                "mesh_refinement", "prolong_primitives", False)
        self.is_sr = False
        self.is_gr = False          # CKS-fixed-metric machinery unused
        self.presist = None
        self.pvisc = None
        self.pcond = None
        self.pturb = None
        self.ppart = None
        self.psbox = None
        self.pgrav = None
        self.srcterms = None
        self.srcterms_func = None
        self.use_fofc = False
        self.fofc_excise_mask = None
        self.nscalars = 0
        self.nmhd = 5
        self.nvar = 5

        # EOS policy + primitive solver (reference: BuildDynGRMHD,
        # dyn_grmhd.cpp:78-120)
        self.policy = make_policy(pin, "mhd")
        self.ps = PrimitiveSolverPS.from_input(self.policy, pin, "mhd")
        # a light EOSData stand-in so borrowed MHD code can query floors
        from .ops.eos import EOSData
        self.eos = EOSData.from_input(pin, "mhd")

        self.recon_method = pin.get_or_add_string("mhd", "reconstruct",
                                                  "plm")
        if self.recon_method not in recon_ops.RECON_FNS:
            raise ValueError(f"mhd/reconstruct={self.recon_method} unknown")
        self.rsolver = pin.get_or_add_string("mhd", "rsolver", "llf")
        if self.rsolver not in ("llf", "hlle"):
            raise ValueError(
                f"mhd/rsolver={self.rsolver}: dynamical GRMHD supports "
                "llf and hlle (reference: DynGRMHD_RSolver)")
        ng_need = RECON_NGHOST[self.recon_method]
        if mesh.mb_indcs.ng < ng_need:
            raise ValueError(
                f"reconstruct={self.recon_method} needs nghost>={ng_need}")

        mbi = mesh.mb_indcs
        n1, n2, n3 = mbi.ncells1, mbi.ncells2, mbi.ncells3
        self.shape = (mesh.nmb_total, self.nvar, n3, n2, n1)
        self.bcc_shape = (mesh.nmb_total, 3, n3, n2, n1)
        self.fc_shapes = {
            "x1f": (mesh.nmb_total, n3, n2, n1 + 1),
            "x2f": (mesh.nmb_total, n3, n2 + 1, n1),
            "x3f": (mesh.nmb_total, n3 + 1, n2, n1),
        }
        ms = mesh.mesh_size

        # dx is scalar on uniform meshes, per-block broadcastable on SMR
        # (same pattern as physics/mhd.py)
        def _dx(name, nd):
            if self.multilevel:
                return mesh.mb_size[f"d{name}"].reshape(
                    (-1,) + (1,) * (nd - 1))
            return getattr(ms, f"d{name}")

        self.dirs = [("x1", 4, IVX, _dx("x1", 5))]
        if mbi.nx2 > 1:
            self.dirs.append(("x2", 3, IVY, _dx("x2", 5)))
        if mbi.nx3 > 1:
            self.dirs.append(("x3", 2, IVZ, _dx("x3", 5)))
        self._dx4 = {n: _dx(n, 4) for n in ("x1", "x2", "x3")}
        # per-block dx localized to the device's rows inside shard_map
        # (identity on scalars; mirrors physics/mhd.py _ldx4)
        from .comm import local_blocks
        self._ldx4 = lambda name: local_blocks(self._dx4[name],
                                               pad_edge=True)
        self.idx = tuple(1.0 / _dx(f"x{d}", 4) for d in (1, 2, 3))
        self.time_evolution = pin.get_string("time", "evolution") \
            if pin.does_block_exist("time") else "dynamic"

        # spacetime: evolved Z4c or fixed ADM background
        self.fixed_evolution = not pin.does_block_exist("z4c")
        if self.fixed_evolution:
            self.z4c = None
            self._fixed_adm = None  # set by the problem generator
            self._adm_fn = None     # time-dependent prescribed ADM
            self.nco = 0
        else:
            from .z4c.z4c import Z4c
            self.z4c = Z4c(pin, mesh, bvals)
            # compact-object trackers ride the z4c shift (BNS/BH-torus
            # production diagnostics + <z4c_amr> tracker criterion)
            self.nco = self.z4c.nco
            self.tracker_pos0 = self.z4c.tracker_pos0
            self.tracker_radius = self.z4c.tracker_radius
            self.tracker_reflevel = self.z4c.tracker_reflevel

    # ----------------------------------------------------------- allocate
    def allocate(self, dtype):
        u = jnp.zeros(self.shape, dtype=dtype)
        w = jnp.zeros(self.shape, dtype=dtype)
        bfc = {k: jnp.zeros(s, dtype=dtype)
               for k, s in self.fc_shapes.items()}
        return u, w, bfc

    def set_fixed_adm(self, g3d, alpha, beta_u, K_dd=None):
        """Install the static ADM background (pgen hook; the reference's
        ADM::SetADMVariables when no Z4c is present)."""
        zeros = [np.zeros_like(alpha)] * 6
        self._fixed_adm = {
            "g3d": list(g3d), "alpha": alpha, "beta_u": list(beta_u),
            "K_dd": list(K_dd) if K_dd is not None else zeros}

    def set_adm_fn(self, fn):
        """Prescribed TIME-DEPENDENT ADM background: ``fn(t) -> adm``
        dict with g3d/alpha/beta_u/K_dd, traced into the cycle so the
        spacetime moves without recompiles (the reference's
        padm->SetADMVariables hook re-evaluated per step, e.g. the
        superposed-BBH metric, src/pgen/dyn_grmhd/dynbbh.cpp:242-313)."""
        self._adm_fn = fn

    def adm_of(self, state):
        if self.fixed_evolution:
            if getattr(self, "_adm_fn", None) is not None:
                return self._adm_fn(state.get("t", 0.0))
            if self._fixed_adm is None:
                raise RuntimeError("fixed-spacetime DynGRMHD needs the "
                                   "pgen to call set_fixed_adm")
            from .comm import local_blocks as _lb
            fa = self._fixed_adm
            # per-block host arrays localize to the device's rows
            # inside the shard_map cycle (identity otherwise)
            return {"g3d": [_lb(c, pad_edge=True) for c in fa["g3d"]],
                    "alpha": _lb(fa["alpha"], pad_edge=True),
                    "beta_u": [_lb(c, pad_edge=True)
                               for c in fa["beta_u"]],
                    "K_dd": [_lb(c, pad_edge=True) for c in fa["K_dd"]]}
        return adm_from_z4c(self.z4c, state["z"])

    # ------------------------------------------------------- prim <-> cons
    def prim_to_cons_state(self, w, T, bcc, adm):
        """Densitized conserved state from primitives (pgen/init path)."""
        g3d = adm["g3d"]
        sdetg = jnp.sqrt(spatial_det(g3d))
        n = w[:, IDN] / self.ps.mb
        Wv = [w[:, IVX + a] for a in range(3)]
        P = w[:, IEN]
        B_u = [bcc[:, a] / sdetg for a in range(3)]
        D, S_d, tau = self.ps.prim_to_con(n, Wv, P, T, B_u, g3d)
        return jnp.stack([D * sdetg, S_d[0] * sdetg, S_d[1] * sdetg,
                          S_d[2] * sdetg, tau * sdetg], axis=1)

    def cons_to_prim(self, u, bcc, adm):
        g3d = adm["g3d"]
        g3u = spatial_inv(g3d)
        sdetg = jnp.sqrt(spatial_det(g3d))
        isd = 1.0 / sdetg
        D = u[:, 0] * isd
        S_d = [u[:, 1 + a] * isd for a in range(3)]
        tau = u[:, 4] * isd
        B_u = [bcc[:, a] * isd for a in range(3)]
        out = self.ps.con_to_prim(D, S_d, tau, B_u, g3d, g3u)
        w = jnp.stack([out["n"] * self.ps.mb, out["Wv_u"][0],
                       out["Wv_u"][1], out["Wv_u"][2], out["P"]], axis=1)
        u_fixed = jnp.stack(
            [out["D"] * sdetg, out["S_d"][0] * sdetg,
             out["S_d"][1] * sdetg, out["S_d"][2] * sdetg,
             out["tau"] * sdetg], axis=1)
        counters = {"nfloor": out["nfloor"], "nfail_c2p": out["nfail"]}
        return w, out["T"], u_fixed, counters

    # --------------------------------------------------------------- fluxes
    def _face_adm(self, adm, axis: int):
        """Arithmetic face average of the ADM fields along a cell axis
        (entry i = face between cells i-1 and i, like the flux arrays)."""
        def favg(f):
            return 0.5 * (f + jnp.roll(f, 1, axis=axis - 1))
        return {"g3d": [favg(c) for c in adm["g3d"]],
                "alpha": favg(adm["alpha"]),
                "beta_u": [favg(c) for c in adm["beta_u"]]}

    def _state_flux(self, prim, T, B_u_til, g3d, beta_u, alpha, isdetg,
                    iax):
        """One-sided flux (reference: flux_dyn_grmhd.hpp SingleStateFlux).
        ``prim``: [rho, Wv(3), P] channel list; B_u_til densitized."""
        n = prim[0] / self.ps.mb
        Wv = [prim[1], prim[2], prim[3]]
        P = prim[4]
        B_u = [b * isdetg for b in B_u_til]
        D, S_d, tau = self.ps.prim_to_con(n, Wv, P, T, B_u, g3d)
        ialpha = 1.0 / alpha
        Wv_d = lower(Wv, g3d)
        iWsq = 1.0 / (1.0 + contract(Wv, Wv_d))
        iW = jnp.sqrt(iWsq)
        vc = Wv[iax] * iW - beta_u[iax] * ialpha
        bu0 = contract(B_u, Wv_d) * ialpha
        B_d = lower(B_u, g3d)
        b_d = [(alpha * bu0 * Wv_d[a] + B_d[a]) * iW for a in range(3)]
        bsq = (contract(B_u, B_d) + (alpha * bu0) ** 2) * iWsq
        ptot = P + 0.5 * bsq
        f = [D * vc,
             S_d[0] * vc - b_d[0] * B_u[iax] * iW,
             S_d[1] * vc - b_d[1] * B_u[iax] * iW,
             S_d[2] * vc - b_d[2] * B_u[iax] * iW,
             tau * vc - alpha * bu0 * B_u[iax] * iW + ptot * Wv[iax] * iW]
        f[1 + iax] = f[1 + iax] + ptot
        iby = (iax + 1) % 3
        ibz = (iax + 2) % 3
        bf = {iby: B_u[iby] * vc
              - B_u[iax] * (Wv[iby] * iW - beta_u[iby] * ialpha),
              ibz: B_u[ibz] * vc
              - B_u[iax] * (Wv[ibz] * iW - beta_u[ibz] * ialpha)}
        cons = [D, S_d[0], S_d[1], S_d[2], tau]
        return cons, f, bf, bsq, B_u

    def _fast_speeds(self, prim, T, bsq, g3d, beta_u, alpha, gii, iax):
        """GR fast magnetosonic speeds (reference:
        primitive_solver_hyd.hpp:575-611)."""
        n = prim[0] / self.ps.mb
        Wv = [prim[1], prim[2], prim[3]]
        usq = contract(Wv, lower(Wv, g3d))
        Wsq = 1.0 + usq
        ialpha = 1.0 / alpha
        W = jnp.sqrt(Wsq)
        u0 = W * ialpha
        u1 = Wv[iax] - u0 * beta_u[iax]
        g00 = -ialpha * ialpha
        g01 = -g00 * beta_u[iax]
        g11 = gii - g01 * beta_u[iax]
        cs = self.policy.sound_speed(jnp.maximum(n, self.ps.n_atm), T)
        csq = cs * cs
        H = self.ps.mb * n * self.policy.enthalpy(
            jnp.maximum(n, self.ps.n_atm), T)
        vasq = bsq / (bsq + H)
        cmsq = csq + vasq - csq * vasq
        a = u0 * u0 - (g00 + u0 * u0) * cmsq
        b = -2.0 * (u0 * u1 - (g01 + u0 * u1) * cmsq)
        c = u1 * u1 - (g11 + u1 * u1) * cmsq
        a1 = b / a
        a0 = c / a
        s = jnp.sqrt(jnp.maximum(a1 * a1 - 4.0 * a0, 0.0))
        lam_p = jnp.where(a1 >= 0.0, -2.0 * a0 / (a1 + s), 0.5 * (-a1 + s))
        lam_m = jnp.where(a1 >= 0.0, 0.5 * (-a1 - s), -2.0 * a0 / (a1 - s))
        return lam_p, lam_m

    def fluxes(self, w, T, bcc, bfc, adm):
        """Per-direction reconstruct + LLF/HLLE dyngr solve
        (reference: dyn_grmhd_fluxes.cpp + rsolvers/llf_dyn_grmhd.hpp)."""
        rec = recon_ops.RECON_FNS[self.recon_method]
        floors = self.recon_method in recon_ops.FLOORED_METHODS
        wt = jnp.concatenate([w, T[:, None]], axis=1)
        bface = {
            "x1": bfc["x1f"][..., :-1],
            "x2": bfc["x2f"][..., :-1, :],
            "x3": bfc["x3f"][..., :-1, :, :],
        }
        flx = {}
        emf = {}
        fden = {}
        ey_name = {"x1": "e3x1", "x2": "e1x2", "x3": "e2x3"}
        ez_name = {"x1": "e2x1", "x2": "e3x2", "x3": "e1x3"}
        diag = [0, 3, 5]
        off = [4, 2, 1]   # S23, S13, S12 channel ids in sym6 order

        for name, axis, ivx, _dx in self.dirs:
            iax = ivx - IVX
            wl, wr = rec(wt, axis)
            bl, br = rec(bcc, axis)
            if floors:
                wl = wl.at[:, IDN].max(self.ps.n_atm * self.ps.mb)
                wr = wr.at[:, IDN].max(self.ps.n_atm * self.ps.mb)
            wl = wl.at[:, IEN].max(0.0)
            wr = wr.at[:, IEN].max(0.0)
            Tl = jnp.maximum(wl[:, 5], self.policy.min_T)
            Tr = jnp.maximum(wr[:, 5], self.policy.min_T)

            fadm = self._face_adm(adm, axis)
            g3d = fadm["g3d"]
            alpha = fadm["alpha"]
            beta_u = fadm["beta_u"]
            detg = spatial_det(g3d)
            sdetg = jnp.sqrt(detg)
            isdetg = 1.0 / sdetg

            bx = bface[name]
            prim_l = [wl[:, c] for c in range(5)]
            prim_r = [wr[:, c] for c in range(5)]
            # B normal component is the shared staggered face field
            Bl = [bx if a == iax else bl[:, a] for a in range(3)]
            Br = [bx if a == iax else br[:, a] for a in range(3)]

            cons_l, fl, bfl, bsql, Bul = self._state_flux(
                prim_l, Tl, Bl, g3d, beta_u, alpha, isdetg, iax)
            cons_r, fr, bfr, bsqr, Bur = self._state_flux(
                prim_r, Tr, Br, g3d, beta_u, alpha, isdetg, iax)

            iby = (iax + 1) % 3
            ibz = (iax + 2) % 3
            gii = (g3d[diag[iby]] * g3d[diag[ibz]]
                   - g3d[off[iax]] * g3d[off[iax]]) * isdetg * isdetg
            lpl, lml = self._fast_speeds(prim_l, Tl, bsql, g3d, beta_u,
                                         alpha, gii, iax)
            lpr, lmr = self._fast_speeds(prim_r, Tr, bsqr, g3d, beta_u,
                                         alpha, gii, iax)

            if self.rsolver == "llf":
                lam = jnp.maximum(jnp.maximum(lpl, lpr),
                                  -jnp.minimum(lml, lmr))
                chans = [0.5 * sdetg * (alpha * (fl[c] + fr[c])
                                        - lam * (cons_r[c] - cons_l[c]))
                         for c in range(5)]
                ey = -0.5 * sdetg * (alpha * (bfl[iby] + bfr[iby])
                                     - lam * (Bur[iby] - Bul[iby]))
                ez = 0.5 * sdetg * (alpha * (bfl[ibz] + bfr[ibz])
                                    - lam * (Bur[ibz] - Bul[ibz]))
            else:  # hlle (reference: hlle_dyn_grmhd.hpp)
                lam_r = jnp.maximum(jnp.maximum(lpl, lpr), 0.0)
                lam_l = jnp.minimum(jnp.minimum(lml, lmr), 0.0)
                idl = 1.0 / (lam_r - lam_l)
                chans = [sdetg * idl
                         * (alpha * (lam_r * fl[c] - lam_l * fr[c])
                            + lam_r * lam_l * (cons_r[c] - cons_l[c]))
                         for c in range(5)]
                ey = -sdetg * idl * (
                    alpha * (lam_r * bfl[iby] - lam_l * bfr[iby])
                    + lam_r * lam_l * (Bur[iby] - Bul[iby]))
                ez = sdetg * idl * (
                    alpha * (lam_r * bfl[ibz] - lam_l * bfr[ibz])
                    + lam_r * lam_l * (Bur[ibz] - Bul[ibz]))
            flx[name] = jnp.stack(chans, axis=1)
            fden[name] = chans[0]
            emf[ey_name[name]] = ey
            emf[ez_name[name]] = ez
        return flx, fden, emf

    # ----------------------------------------------------------- sources
    def coord_src_terms(self, u, w, T, bcc, adm, beta_dt):
        """Geometric source terms (reference: DynGRMHDPS::AddCoordTermsEOS,
        dyn_grmhd.cpp)."""
        g3d = adm["g3d"]
        alpha = adm["alpha"]
        beta_u = adm["beta_u"]
        K_dd = adm["K_dd"]
        detg = spatial_det(g3d)
        vol = jnp.sqrt(detg)
        g3u = spatial_inv(g3d, detg)
        from .comm import local_blocks as _lb
        ng = self.mesh.mb_indcs.ng
        idx = tuple(_lb(i, pad_edge=True) for i in self.idx)
        ndim = len(self.dirs)

        def D1(f, d):
            return fd.d1(f, d, idx, ng) if d < ndim else jnp.zeros_like(f)

        dalpha = [D1(alpha, d) for d in range(3)]
        dbeta = [[D1(beta_u[a], d) for a in range(3)] for d in range(3)]
        dg = [[D1(g3d[c], d) for c in range(6)] for d in range(3)]

        n = w[:, IDN] / self.ps.mb
        nf = jnp.maximum(n, self.ps.n_atm)
        Wv = [w[:, IVX + a] for a in range(3)]
        P = w[:, IEN]
        H = w[:, IDN] * self.policy.enthalpy(nf, T)
        Wv_d = lower(Wv, g3d)
        usq = contract(Wv, Wv_d)
        Wsq = 1.0 + usq
        W = jnp.sqrt(Wsq)
        isd = 1.0 / vol
        B_u = [bcc[:, a] * isd for a in range(3)]
        Bv = contract(B_u, Wv_d) / W
        B_d = lower(B_u, g3d)
        Bsq = contract(B_u, B_d)
        bsq = Bv * Bv + Bsq / Wsq
        ptot = P + 0.5 * bsq

        E = (H * Wsq + Bsq) - P - 0.5 * bsq
        S_d = [sum(((H * Wsq + Bsq) * Wv[b] / W - Bv * B_u[b])
                   * g3d[sym6(a, b)] for b in range(3)) for a in range(3)]
        S_uu = {}
        for a in range(3):
            for b in range(a, 3):
                S_uu[(a, b)] = ((H + Bsq / Wsq) * Wv[a] * Wv[b]
                                - B_u[a] * B_u[b] / Wsq
                                - Bv * (B_u[a] * Wv[b]
                                        + B_u[b] * Wv[a]) / W
                                + ptot * g3u[sym6(a, b)])

        def suu(a, b):
            return S_uu[(a, b) if a <= b else (b, a)]

        # energy source
        den = sum((alpha * K_dd[sym6(a, b)] * suu(a, b)
                   - g3u[sym6(a, b)] * S_d[a] * dalpha[b])
                  for a in range(3) for b in range(3))
        u = u.at[:, 4].add(beta_dt * vol * den)
        # momentum sources
        for a in range(3):
            dm = sum(0.5 * alpha * suu(b, c) * dg[a][sym6(b, c)]
                     for b in range(3) for c in range(3))
            dm = dm + sum(S_d[b] * dbeta[a][b] for b in range(3))
            dm = dm - E * dalpha[a]
            u = u.at[:, 1 + a].add(beta_dt * vol * dm)
        return u

    # ------------------------------------------------------------- tmunu
    def set_tmunu(self, u, w, bcc, adm):
        """Undensitized stress-energy projections (reference:
        DynGRMHD::SetTmunu, dyn_grmhd.cpp:412-478)."""
        g3d = adm["g3d"]
        detg = spatial_det(g3d)
        ivol = 1.0 / jnp.sqrt(detg)
        Wv = [w[:, IVX + a] for a in range(3)]
        v_d = lower(Wv, g3d)              # = W v_d
        iW = 1.0 / jnp.sqrt(1.0 + contract(Wv, v_d))
        B_u = [bcc[:, a] * ivol for a in range(3)]
        B_d = lower(B_u, g3d)
        Bv = contract(B_u, v_d)           # note: W-weighted like reference
        Bsq = contract(B_u, B_d)
        bsq = (Bsq + Bv * Bv) * iW * iW
        E = (u[:, 4] + u[:, 0]) * ivol
        S_d = [u[:, 1 + a] * ivol for a in range(3)]
        S_dd = [u[:, 1 + a] * ivol * v_d[b] * iW
                - (B_d[a] + Bv * v_d[a]) * iW * iW * B_d[b]
                + (w[:, IEN] + 0.5 * bsq) * g3d[sym6(a, b)]
                for (a, b) in ((0, 0), (0, 1), (0, 2),
                               (1, 1), (1, 2), (2, 2))]
        return {"E": E, "S_d": S_d, "S_dd": S_dd}

    # --------------------------------------------------- state interface
    def make_state(self, u, w, bfc, T=None, z=None):
        state = {"u": u, "w": w, "bfc": bfc,
                 "bcc": self.compute_bcc(bfc)}
        state["T"] = T if T is not None \
            else jnp.zeros(u.shape[:1] + u.shape[2:], dtype=u.dtype)
        if not self.fixed_evolution:
            if z is None:
                raise ValueError("dynamical spacetime needs z4c state")
            state["z"] = z
            if self.nco > 0:
                state["co_pos"] = jnp.asarray(self.z4c.tracker_pos0,
                                              u.dtype)
        return state

    def post_cycle(self, state, dt):
        """Advance the puncture/compact-object trackers on the z4c
        shift (see Z4c.post_cycle; the tracked field is state['z'])."""
        if self.z4c is None or self.nco == 0 or "co_pos" not in state:
            return state
        from .z4c.z4c import I_BETAX
        from .z4c.z4c_amr import device_interp
        pos = state["co_pos"]
        beta = device_interp(self.mesh, state["z"],
                             [I_BETAX + a for a in range(3)], pos)
        return dict(state, co_pos=pos - dt * beta)

    def save_state(self, state):
        saved = {"u1": state["u"], "bfc1": state["bfc"]}
        if not self.fixed_evolution:
            saved["z1"] = state["z"]
        return saved

    def accumulate_rk4(self, saved, state, delta):
        out = {"u1": saved["u1"] + delta * state["u"],
               "bfc1": {k: saved["bfc1"][k] + delta * state["bfc"][k]
                        for k in saved["bfc1"]}}
        if not self.fixed_evolution:
            out["z1"] = saved["z1"] + delta * state["z"]
        return out

    def init_ghosts(self, state):
        u = self.bvals.fill_ghosts(state["u"])
        bfc = self.fill_ghosts_fc(state["bfc"])
        bcc = self.compute_bcc(bfc)
        out = dict(state)
        if not self.fixed_evolution:
            z = self.bvals.fill_ghosts(state["z"])
            z = self.z4c.alg_constr(z)
            out["z"] = z
        adm = self.adm_of(out)
        w, T, u, _ = self.cons_to_prim(u, bcc, adm)
        out.update({"u": u, "w": w, "T": T, "bfc": bfc, "bcc": bcc})
        return out

    # --------------------------------------------------------------- stage
    def stage_update(self, state, saved, gam0, gam1, beta_dt):
        """One interleaved RK stage (reference: QueueDynGRMHDTasks order,
        dyn_grmhd.cpp:150-260): MHD flux -> Tmunu -> MHD update + coord
        sources -> corner EMFs + CT -> Z4c stage with matter ->
        halo fills -> ADM refresh -> c2p."""
        u, w, T = state["u"], state["w"], state["T"]
        bfc, bcc = state["bfc"], state["bcc"]
        adm = self.adm_of(state)

        flx, fden, emf = self.fluxes(w, T, bcc, bfc, adm)
        tmunu = None if self.fixed_evolution \
            else self.set_tmunu(u, w, bcc, adm)

        u_new = self.rk_update(u, saved["u1"], flx, gam0, gam1, beta_dt)
        u_new = self.coord_src_terms(u_new, w, T, bcc, adm, beta_dt)

        # transport-velocity cell EMFs: E = -(alpha v - beta) x B-tilde
        # (reference: mhd_corner_e.cpp ADM branch)
        Wv = [w[:, IVX + a] for a in range(3)]
        v_d = lower(Wv, adm["g3d"])
        iW = 1.0 / jnp.sqrt(1.0 + contract(Wv, v_d))
        vt = [adm["alpha"] * Wv[a] * iW - adm["beta_u"][a]
              for a in range(3)]
        # sign convention matches the Newtonian e1cc = vz*by - vy*bz form
        # and the reference ADM branch e3cc = Bx*vt2 - By*vt1
        bt = [bcc[:, a] for a in range(3)]
        ecc = (bt[1] * vt[2] - bt[2] * vt[1],
               bt[2] * vt[0] - bt[0] * vt[2],
               bt[0] * vt[1] - bt[1] * vt[0])
        e1, e2, e3 = self.corner_e(w, bcc, fden, emf, bfc=bfc, ecc=ecc)
        bfc_new = self.ct_update(bfc, saved["bfc1"], e1, e2, e3,
                                 gam0, gam1, beta_dt)

        out = dict(state)
        if not self.fixed_evolution:
            zstate, _ = self.z4c.stage_update(
                {"u": state["z"]}, {"u1": saved["z1"]},
                gam0, gam1, beta_dt, tmunu=tmunu)
            out["z"] = zstate["u"]

        u_new = self.bvals.fill_ghosts(u_new)
        bfc_new = self.fill_ghosts_fc(bfc_new)
        bcc_new = self.compute_bcc(bfc_new)
        adm_new = self.adm_of(out)
        w_new, T_new, u_new, counters = self.cons_to_prim(
            u_new, bcc_new, adm_new)
        out.update({"u": u_new, "w": w_new, "T": T_new,
                    "bfc": bfc_new, "bcc": bcc_new})
        return out, counters

    # ----------------------------------------------------------------- dt
    def dt_from_state(self, state):
        """Light-speed CFL per direction (the reference's dyngr/GR newdt
        uses unit coordinate speeds, src/mhd/mhd_newdt.cpp GR branch)."""
        mbi = self.mesh.mb_indcs
        if self.multilevel:
            import numpy as _np
            sz = self.mesh.mb_size
            dt = float(_np.min(sz["dx1"]))
            if mbi.nx2 > 1:
                dt = min(dt, float(_np.min(sz["dx2"])))
            if mbi.nx3 > 1:
                dt = min(dt, float(_np.min(sz["dx3"])))
        else:
            ms = self.mesh.mesh_size
            dt = ms.dx1
            if mbi.nx2 > 1:
                dt = min(dt, ms.dx2)
            if mbi.nx3 > 1:
                dt = min(dt, ms.dx3)
        return jnp.asarray(dt, dtype=state["u"].dtype)
