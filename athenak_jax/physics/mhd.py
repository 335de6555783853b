"""Newtonian magnetohydrodynamics with constrained transport.

Parity target: the reference ``MHD`` class and task DAG
(reference: src/mhd/mhd.hpp, mhd_tasks.cpp:48-81, mhd_fluxes.cpp,
mhd_corner_e.cpp, mhd_ct.cpp).  Design:

  * Face-centered B is a pytree of three arrays with +1 extent on the
    normal axis: x1f [nmb,n3,n2,n1+1], x2f [nmb,n3,n2+1,n1],
    x3f [nmb,n3+1,n2,n1] (CT staggering kept as separate arrays per
    SURVEY.md §7 guidance).
  * Corner EMFs (Gardiner & Stone 2007 upwinding) and the CT curl are
    cell-indexed roll-stencil ops: entry (k,j,i) is the edge at the lower
    corner of cell (k,j,i) — static shapes, no scatter.
  * The per-stage task chain (flux -> rkupdate -> cornerE -> CT -> halo ->
    BCs -> c2p) is one pure function; XLA fuses and schedules it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax.numpy as jnp
import numpy as _np

from ..bvals import BoundaryValues, _AXIS_OF
from ..comm import gather_blocks, local_blocks
from ..indices import IDN, IEN, IVX, IVY, IVZ, RECON_NGHOST
from ..mesh import Mesh
from ..ops import recon as recon_ops
from ..ops import rsolvers_mhd
from ..ops.eos import EOSData, cons_to_prim_mhd, prim_to_cons_mhd
from ..ops.plm_hlld_triton import plm_hlld_x1_auto


def _sh(a, s: int, axis: int):
    """a shifted so result[i] = a[i + s] (circular)."""
    return jnp.roll(a, -s, axis=axis)


class MHD:
    """Owns MHD configuration and provides the pure per-stage update."""

    is_mhd = True

    def __init__(self, pin, mesh: Mesh, bvals: BoundaryValues) -> None:
        from ..coordinates import Coordinates
        self.mesh = mesh
        self.multilevel = bool(getattr(mesh, "multilevel", False))
        if self.multilevel:
            bvals.prolong_prims = pin.get_or_add_boolean(
                "mesh_refinement", "prolong_primitives", False)
        self.bvals = bvals
        self.coord = Coordinates(pin)
        self.eos = EOSData.from_input(pin, "mhd")
        self.is_sr = self.coord.is_special_relativistic
        self.is_gr = self.coord.is_general_relativistic
        if (self.is_sr or self.is_gr) and not self.eos.is_ideal:
            raise ValueError("relativistic MHD requires the ideal-gas EOS")
        self.nmhd = 5 if self.eos.is_ideal else 4
        self.nscalars = pin.get_or_add_integer("mhd", "nscalars", 0)
        self.nvar = self.nmhd + self.nscalars

        self.recon_method = pin.get_or_add_string("mhd", "reconstruct", "plm")
        if self.recon_method not in recon_ops.RECON_FNS:
            raise ValueError(f"mhd/reconstruct={self.recon_method} unknown")
        self.rsolver = pin.get_or_add_string("mhd", "rsolver", "llf")
        if self.is_sr:
            # SR runs map generic solver names onto SR variants
            # (reference: src/mhd/mhd.cpp solver dispatch)
            from ..ops.rsolvers_srmhd import SR_MHD_RSOLVER_FNS
            if self.rsolver not in SR_MHD_RSOLVER_FNS:
                raise ValueError(
                    f"mhd/rsolver={self.rsolver} not available in SR MHD")
            self._rsolver_fns = SR_MHD_RSOLVER_FNS
        elif self.is_gr:
            from ..ops.rsolvers_grmhd import GR_MHD_RSOLVER_FNS
            if self.rsolver not in GR_MHD_RSOLVER_FNS:
                raise ValueError(
                    f"mhd/rsolver={self.rsolver} not available in GR MHD")
            self._rsolver_fns = GR_MHD_RSOLVER_FNS
        else:
            if self.rsolver not in rsolvers_mhd.MHD_RSOLVER_FNS:
                raise ValueError(f"mhd/rsolver={self.rsolver} unknown")
            self._rsolver_fns = rsolvers_mhd.MHD_RSOLVER_FNS

        ng_need = RECON_NGHOST[self.recon_method]
        if mesh.mb_indcs.ng < ng_need:
            raise ValueError(
                f"reconstruct={self.recon_method} requires nghost >= {ng_need}"
                f" but mesh/nghost={mesh.mb_indcs.ng}")

        mbi = mesh.mb_indcs
        n1, n2, n3 = mbi.ncells1, mbi.ncells2, mbi.ncells3
        self.shape = (mesh.nmb_total, self.nvar, n3, n2, n1)
        self.bcc_shape = (mesh.nmb_total, 3, n3, n2, n1)
        self.fc_shapes = {
            "x1f": (mesh.nmb_total, n3, n2, n1 + 1),
            "x2f": (mesh.nmb_total, n3, n2 + 1, n1),
            "x3f": (mesh.nmb_total, n3 + 1, n2, n1),
        }

        # dx is scalar on uniform meshes, per-block broadcastable on SMR
        def _dx(name, nd):
            if self.multilevel:
                return mesh.mb_size[f"d{name}"].reshape(
                    (-1,) + (1,) * (nd - 1))
            return getattr(mesh.mesh_size, f"d{name}")

        self.dirs = [("x1", 4, IVX, _dx("x1", 5))]
        if mbi.nx2 > 1:
            self.dirs.append(("x2", 3, IVY, _dx("x2", 5)))
        if mbi.nx3 > 1:
            self.dirs.append(("x3", 2, IVZ, _dx("x3", 5)))
        # 4D (no-var-axis) per-block dx for the CT curl and new_dt
        self._dx4 = {n: _dx(n, 4) for n in ("x1", "x2", "x3")}

        # per-block dx localized to the device's rows inside shard_map
        def _ldx4(name):
            return local_blocks(self._dx4[name], pad_edge=True)

        self._ldx4 = _ldx4
        # PLM + HLLD along x1 as one Triton kernel where the cycle is
        # compiled for a GPU (ops/plm_hlld_triton.py)
        self.x1_kernel = (not (self.is_sr or self.is_gr)
                          and self.recon_method == "plm"
                          and self.rsolver == "hlld"
                          and self.eos.is_ideal and self.nscalars == 0)

        self.time_evolution = pin.get_string("time", "evolution") \
            if pin.does_block_exist("time") else "dynamic"

        if self.is_gr:
            from ..coordinates import GRGeometry
            self.geom = GRGeometry(mesh, self.coord.coord_data)
            cd = self.coord.coord_data
            if cd.bh_excise:
                m_ = self.geom.excision_floor_mask()
                self.excise_mask = _np.broadcast_to(
                    m_, (mesh.nmb_total, mesh.mb_indcs.ncells3,
                         mesh.mb_indcs.ncells2, mesh.mb_indcs.ncells1)
                ).copy()
            else:
                self.excise_mask = None
        else:
            self.geom = None
            self.excise_mask = None

        # diffusion (constructed only if coefficients present,
        # reference: src/mhd/mhd.cpp:103-131)
        from ..diffusion import Conduction, Resistivity, Viscosity
        self.pvisc = Viscosity("mhd", pin, mesh, self.eos) \
            if (pin.does_parameter_exist("mhd", "nu_iso")
                or pin.does_parameter_exist("mhd", "nu_aniso")) else None
        self.presist = Resistivity(pin, mesh, self.eos) \
            if (pin.does_parameter_exist("mhd", "eta_ohm")
                or pin.does_parameter_exist("mhd", "eta_ad")) else None
        self.pcond = Conduction("mhd", pin, mesh, self.eos) \
            if (pin.does_parameter_exist("mhd", "alpha_iso")
                or pin.does_parameter_exist("mhd", "alpha_aniso")
                or pin.does_parameter_exist("mhd", "alpha_spitzer")) \
            else None

        # first-order flux correction (reference: src/mhd/mhd_fofc.cpp)
        self.use_fofc = pin.get_or_add_boolean("mhd", "fofc", False)
        self.fofc_excise_mask = None
        if self.is_gr and self.coord.coord_data.bh_excise:
            r_fe = 1.0
            r = self.geom.ks_radius_cc()
            rb = _np.broadcast_to(
                r, (mesh.nmb_total, mesh.mb_indcs.ncells3,
                    mesh.mb_indcs.ncells2, mesh.mb_indcs.ncells1)).copy()
            near = rb <= r_fe
            m = near.copy()
            for ax in (1, 2, 3):
                m |= _np.roll(near, 1, axis=ax) | _np.roll(near, -1, axis=ax)
            self.fofc_excise_mask = m

        # physics source terms from the <mhd_srcterms> block
        from ..srcterms import SourceTerms
        self.srcterms = SourceTerms("mhd_srcterms", pin, mesh, self.eos) \
            if pin.does_block_exist("mhd_srcterms") else None
        # turbulence driving (reference: src/srcterms/turb_driver.cpp)
        from ..turb_driver import TurbulenceDriver
        self.pturb = TurbulenceDriver(pin, mesh) \
            if pin.does_block_exist("turb_driving") else None
        # shearing box + orbital advection (reference:
        # src/shearing_box/shearing_box_fc.cpp, orbital_advection_fc.cpp)
        from ..shearing_box import ShearingBox
        self.psbox = ShearingBox(pin, mesh, self.nvar) \
            if pin.does_block_exist("shearing_box") else None

        # test particles (reference: src/particles/)
        from ..particles import Particles
        self.ppart = Particles(pin, mesh) \
            if pin.does_block_exist("particles") else None

        # self-gravity (reference: src/gravity/ + src/multigrid/; FFT
        # Poisson on uniform periodic meshes, SURVEY.md section 7 step 8)
        from ..gravity import make_gravity
        self.pgrav = make_gravity(pin, mesh) \
            if pin.does_block_exist("gravity") else None
        self.srcterms_func = None

        if self.multilevel:
            from ..multigrid import MGPoisson
            # diffusion operators take per-block dx (diffusion._dx_tab);
            # viscous/conductive fluxes ride the SMR flux correction and
            # resistive EMFs ride the edge-EMF correction
            # shearing box composes with refinement via per-level ring
            # tables (shearing_box._check_zslab enforces the z-slab
            # layout; reference: FindTargetMB, shearing_box.hpp:77)
            blockers = {
                # multigrid gravity handles refined meshes; the FFT
                # fast path does not
                "self-gravity (fft)": self.pgrav
                if not isinstance(self.pgrav, MGPoisson) else None,
            }
            for what, on in blockers.items():
                if on is not None and on is not False:
                    raise NotImplementedError(
                        f"{what} with static mesh refinement is not "
                        "supported yet")
            if mesh.mb_indcs.nx1 < 2 * mesh.mb_indcs.ng or \
                    (mesh.mb_indcs.nx2 > 1
                     and mesh.mb_indcs.nx2 < 2 * mesh.mb_indcs.ng):
                raise ValueError("SMR requires meshblocks >= 2*nghost")

    # ------------------------------------------------------------- allocate
    def allocate(self, dtype):
        u = jnp.zeros(self.shape, dtype=dtype)
        w = jnp.zeros(self.shape, dtype=dtype)
        bfc = {k: jnp.zeros(s, dtype=dtype) for k, s in self.fc_shapes.items()}
        return u, w, bfc

    # ----------------------------------------------------------------- bcc
    def compute_bcc(self, bfc):
        """Cell-centered field from face averages
        (reference: src/mhd/mhd.cpp bcc0 computation)."""
        b1 = 0.5 * (bfc["x1f"][..., :-1] + bfc["x1f"][..., 1:])
        b2 = 0.5 * (bfc["x2f"][..., :-1, :] + bfc["x2f"][..., 1:, :])
        b3 = 0.5 * (bfc["x3f"][..., :-1, :, :] + bfc["x3f"][..., 1:, :, :])
        return jnp.stack([b1, b2, b3], axis=1)

    # ----------------------------------------------------------------- c2p
    def cons_to_prim(self, u, bcc):
        if self.is_gr:
            from ..ops.eos_gr import cons_to_prim_gr_mhd
            gl, gu = self.geom.metric("cc")
            cd = self.coord.coord_data
            return cons_to_prim_gr_mhd(
                u, bcc, self.eos, gl, gu,
                excise_mask=local_blocks(self.excise_mask),
                dexcise=cd.dexcise, pexcise=cd.pexcise)
        if self.is_sr:
            from ..ops.eos_sr import cons_to_prim_sr_mhd
            return cons_to_prim_sr_mhd(u, bcc, self.eos)
        return cons_to_prim_mhd(u, bcc, self.eos)

    def prim_to_cons(self, w, bcc):
        if self.is_gr:
            from ..ops.eos_gr import prim_to_cons_gr_mhd
            gl, gu = self.geom.metric("cc")
            return prim_to_cons_gr_mhd(w, bcc, self.eos, gl, gu)
        if self.is_sr:
            from ..ops.eos_sr import prim_to_cons_sr_mhd
            return prim_to_cons_sr_mhd(w, bcc, self.eos)
        return prim_to_cons_mhd(w, bcc, self.eos)

    # --------------------------------------------------------------- fluxes
    def fluxes(self, w, bcc, bfc):
        """Reconstruct (w, bcc) + Riemann-solve per direction.

        Returns (flx, emf) dicts; emf keys follow the reference naming:
        x1 faces store (e3x1, e2x1), x2 faces (e1x2, e3x2), x3 faces
        (e2x3, e1x3) (reference: src/mhd/mhd_fluxes.cpp:120-250)."""
        rec = recon_ops.RECON_FNS[self.recon_method]
        solve = self._rsolver_fns[self.rsolver]
        floors = self.recon_method in recon_ops.FLOORED_METHODS

        flx = {}
        emf = {}
        ey_name = {"x1": "e3x1", "x2": "e1x2", "x3": "e2x3"}
        ez_name = {"x1": "e2x1", "x2": "e3x2", "x3": "e1x3"}
        bface = {
            "x1": bfc["x1f"][..., :-1],
            "x2": bfc["x2f"][..., :-1, :],
            "x3": bfc["x3f"][..., :-1, :, :],
        }
        for name, axis, ivx, _dx in self.dirs:
            if name == "x1" and self.x1_kernel:
                f, ey, ez = plm_hlld_x1_auto(w, bcc, bfc["x1f"], self.eos)
                flx[name] = f
                emf[ey_name[name]] = ey
                emf[ez_name[name]] = ez
                continue
            wl, wr = rec(w, axis)
            bl, br = rec(bcc, axis)
            if floors:
                wl = wl.at[:, IDN].max(self.eos.dfloor)
                wr = wr.at[:, IDN].max(self.eos.dfloor)
                if self.eos.is_ideal:
                    efloor = self.eos.pfloor / (self.eos.gamma - 1.0)
                    wl = wl.at[:, IEN].max(efloor)
                    wr = wr.at[:, IEN].max(efloor)
            if self.is_gr:
                gl_m, gu_m = self.geom.metric(name)
                f, ey, ez = solve(wl, wr, bl, br, bface[name], self.eos,
                                  ivx, gl_m, gu_m)
            else:
                f, ey, ez = solve(wl, wr, bl, br, bface[name], self.eos, ivx)
            if self.nscalars > 0:
                # passive scalars: upwind advection on the mass flux
                fd = f[:, IDN:IDN + 1]
                ns = self.nmhd
                fs = jnp.where(fd >= 0.0, fd * wl[:, ns:], fd * wr[:, ns:])
                f = f.at[:, ns:].set(fs)
            flx[name] = f
            emf[ey_name[name]] = ey
            emf[ez_name[name]] = ez
        if self.pvisc is not None:
            flx = self.pvisc.add_viscous_flux(w, flx, self.dirs)
        if self.pcond is not None:
            flx = self.pcond.add_heat_flux(w, flx, self.dirs)
        if self.presist is not None:
            flx = self.presist.add_resistive_flux(
                bfc, bcc, flx, self.dirs, len(self.dirs))
        return flx, emf

    # --------------------------------------------------------------- update
    def rk_update(self, u0, u1, flx, gam0, gam1, beta_dt):
        divf = None
        for name, axis, _ivx, dx in self.dirs:
            f = flx[name]
            d = (_sh(f, 1, axis) - f) / local_blocks(dx, pad_edge=True)
            divf = d if divf is None else divf + d
        return gam0 * u0 + gam1 * u1 - beta_dt * divf

    # ------------------------------------------------------------- corner E
    def corner_e(self, w, bcc, fden, emf, bfc=None, ecc=None):
        """Edge-centered EMFs via Gardiner-Stone (2005/07) upwinding
        (reference: src/mhd/mhd_corner_e.cpp).  Returns cell-indexed edge
        arrays e1/e2/e3: entry (k,j,i) is the edge at the lower corner of
        cell (k,j,i).  ``fden`` holds the mass-flux upwinding selectors
        per direction ({"x1": ..} arrays [nmb,n3,n2,n1]).  ``ecc``
        optionally supplies externally-computed cell-centered EMFs
        (e1cc, e2cc, e3cc) — used by dynamical GRMHD, where the transport
        velocity is alpha*v - beta (reference: mhd_corner_e.cpp ADM
        branch :66-84, 218-240)."""
        one_d = len(self.dirs) == 1
        two_d = len(self.dirs) == 2
        # axes of the 4D [nmb, n3, n2, n1] EMF/flux-channel arrays
        KA, JA, IA = 1, 2, 3

        if one_d:
            e2 = emf["e2x1"]
            e3 = emf["e3x1"]
            e1 = jnp.zeros_like(e2)
            return self._add_resist(bfc, bcc, e1, e2, e3)

        vx = w[:, IVX]
        vy = w[:, IVY]
        vz = w[:, IVZ]
        bx = bcc[:, 0]
        by = bcc[:, 1]
        bz = bcc[:, 2]
        if ecc is not None:
            e1cc_gr, e2cc_gr, e3cc_gr = ecc
        if self.is_sr:
            # SR primitives store u^i = gamma v^i: the transport velocity
            # in E = -v x B is the 3-velocity
            # (reference: mhd_corner_e.cpp:136-143)
            lor = jnp.sqrt(1.0 + vx * vx + vy * vy + vz * vz)
            vx, vy, vz = vx / lor, vy / lor, vz / lor
        if self.is_gr and ecc is None:
            # GR cell EMFs from the 4-velocity and 4-field
            # (reference: mhd_corner_e.cpp:86-133, 243-293)
            gl, gu = self.geom.metric("cc")
            q = (gl[1][1] * vx * vx + gl[2][2] * vy * vy
                 + gl[3][3] * vz * vz
                 + 2.0 * (gl[1][2] * vx * vy + gl[1][3] * vx * vz
                          + gl[2][3] * vy * vz))
            alpha = jnp.sqrt(-1.0 / gu[0][0])
            gam = jnp.sqrt(1.0 + q)
            u0 = gam / alpha
            u1 = vx - alpha * gam * gu[0][1]
            u2 = vy - alpha * gam * gu[0][2]
            u3 = vz - alpha * gam * gu[0][3]
            u_1 = gl[1][0] * u0 + gl[1][1] * u1 + gl[1][2] * u2 + gl[1][3] * u3
            u_2 = gl[2][0] * u0 + gl[2][1] * u1 + gl[2][2] * u2 + gl[2][3] * u3
            u_3 = gl[3][0] * u0 + gl[3][1] * u1 + gl[3][2] * u2 + gl[3][3] * u3
            b0 = u_1 * bx + u_2 * by + u_3 * bz
            b1 = (bx + b0 * u1) / u0
            b2 = (by + b0 * u2) / u0
            b3 = (bz + b0 * u3) / u0
            e1cc_gr = b2 * u3 - b3 * u2
            e2cc_gr = b3 * u1 - b1 * u3
            e3cc_gr = b1 * u2 - b2 * u1
        # cell-centered EMFs, E = -v x B (Newtonian/SR 3-velocity form)
        use_ext = self.is_gr or ecc is not None
        e3cc = e3cc_gr if use_ext else vy * bx - vx * by
        fx1 = fden["x1"]  # mass flux upwinding selector
        fx2 = fden["x2"]

        def gs07(e_cc, e_a, e_b, f_a, f_b, axa, axb):
            """Corner value of an EMF component lying along the remaining
            axis, from its two face-centered averages e_a (on faces normal
            to axa) and e_b (on faces normal to axb), upwinded by the mass
            fluxes f_a (normal axa) and f_b (normal axb).

            Index convention: corner (ka, kb) sits at the lower corner in
            both transverse axes, so stencils read offsets {-1, 0}.
            """
            e_a_m = _sh(e_a, -1, axb)     # e_a at (b-1)
            e_b_m = _sh(e_b, -1, axa)     # e_b at (a-1)
            f_a_m = _sh(f_a, -1, axb)     # f_a at (b-1)
            f_b_m = _sh(f_b, -1, axa)     # f_b at (a-1)
            cc_mm = _sh(_sh(e_cc, -1, axa), -1, axb)
            cc_am = _sh(e_cc, -1, axa)    # (a-1, b)
            cc_bm = _sh(e_cc, -1, axb)    # (a, b-1)

            # d(e)/da upwinded by f_a (evaluated at b-1/2 and b+1/2), and
            # d(e)/db upwinded by f_b (at a-1/2 and a+1/2)
            l_b = jnp.where(f_a_m >= 0.0, e_b_m - cc_mm, e_b - cc_bm)
            r_b = jnp.where(f_a >= 0.0, e_b_m - cc_am, e_b - e_cc)
            l_a = jnp.where(f_b_m >= 0.0, e_a_m - cc_mm, e_a - cc_am)
            r_a = jnp.where(f_b >= 0.0, e_a_m - cc_bm, e_a - e_cc)
            return 0.25 * (l_b + r_b + l_a + r_a
                           + e_b_m + e_b + e_a_m + e_a)

        if two_d:
            # E3 at corners via GS07; E1/E2 copied from faces
            e3 = gs07(e3cc, emf["e3x1"], emf["e3x2"], fx1, fx2, IA, JA)
            e1 = emf["e1x2"]
            e2 = emf["e2x1"]
            return self._add_resist(bfc, bcc, e1, e2, e3)

        # 3D
        e1cc = e1cc_gr if use_ext else vz * by - vy * bz
        e2cc = e2cc_gr if use_ext else vx * bz - vz * bx
        fx3 = fden["x3"]
        # E1 lies along x1; faces: e1x2 (x2-faces), e1x3 (x3-faces);
        # corner in (x2, x3) plane
        e1 = gs07(e1cc, emf["e1x2"], emf["e1x3"], fx2, fx3, JA, KA)
        # E2 along x2; faces: e2x3 (x3-faces), e2x1 (x1-faces); plane (x3,x1)
        e2 = gs07(e2cc, emf["e2x3"], emf["e2x1"], fx3, fx1, KA, IA)
        # E3 along x3; faces: e3x1 (x1-faces), e3x2 (x2-faces); plane (x1,x2)
        e3 = gs07(e3cc, emf["e3x1"], emf["e3x2"], fx1, fx2, IA, JA)
        return self._add_resist(bfc, bcc, e1, e2, e3)

    def _add_resist(self, bfc, bcc, e1, e2, e3):
        """Non-ideal EMF contributions at cell edges
        (reference: Resistivity::AddResistiveEMFs called from CornerE)."""
        if self.presist is None:
            return e1, e2, e3
        return self.presist.add_resistive_emf(
            bfc, bcc, e1, e2, e3, len(self.dirs))

    # ------------------------------------------------------------------- CT
    def ct_update(self, bfc, bfc_old, e1, e2, e3, gam0, gam1, beta_dt):
        """Constrained-transport curl update
        (reference: src/mhd/mhd_ct.cpp:40-80).  Face arrays carry a +1
        normal extent; edge arrays are cell-indexed, so face index i pairs
        with edges (i) and (i+1) via rolls on the cell-sized edge arrays."""
        ms = self.mesh.mesh_size
        multi_d = len(self.dirs) >= 2
        three_d = len(self.dirs) == 3
        KA, JA, IA = 1, 2, 3  # axes in 4D face/edge arrays (no var axis)

        new = {}
        # --- B1 faces: ncells1+1 on last axis.  For face index fi, the
        # edge arrays are sampled at cell i=fi (their entry is the lower
        # corner), which for the last face fi=n1 wraps; that slot is ghost
        # data and refilled by the exchange.
        b1 = gam0 * bfc["x1f"] + gam1 * bfc_old["x1f"]
        if multi_d:
            de3 = (_sh(e3, 1, JA) - e3) / self._ldx4("x2")
            b1 = b1 - beta_dt * self._to_face(de3, axis=3)
            if three_d:
                de2 = (_sh(e2, 1, KA) - e2) / self._ldx4("x3")
                b1 = b1 + beta_dt * self._to_face(de2, axis=3)
        new["x1f"] = b1

        # --- B2 faces (+1 on x2 axis)
        b2 = gam0 * bfc["x2f"] + gam1 * bfc_old["x2f"]
        de3 = (_sh(e3, 1, IA) - e3) / self._ldx4("x1")
        b2 = b2 + beta_dt * self._to_face(de3, axis=2)
        if three_d:
            de1 = (_sh(e1, 1, KA) - e1) / self._ldx4("x3")
            b2 = b2 - beta_dt * self._to_face(de1, axis=2)
        new["x2f"] = b2

        # --- B3 faces (+1 on x3 axis)
        b3 = gam0 * bfc["x3f"] + gam1 * bfc_old["x3f"]
        de2 = (_sh(e2, 1, IA) - e2) / self._ldx4("x1")
        b3 = b3 - beta_dt * self._to_face(de2, axis=1)
        if multi_d:
            de1 = (_sh(e1, 1, JA) - e1) / self._ldx4("x2")
            b3 = b3 + beta_dt * self._to_face(de1, axis=1)
        new["x3f"] = b3
        return new

    @staticmethod
    def _to_face(cell_arr, axis: int):
        """Extend a cell-indexed edge-difference array to face extent (+1)
        along `axis` by wrapping one slot (the extra face slot is ghost
        data, refilled by the face-field exchange)."""
        first = jnp.take(cell_arr, _np.array([0]), axis=axis)
        return jnp.concatenate([cell_arr, first], axis=axis)

    # --------------------------------------------- mixed-level face fields
    def _ml_fc_override(self, arr, ax: str, comp: str, src_arr=None):
        """SMR overrides for one face-field component in one axis sweep:
        area-average restriction from finer donors (including the shared
        face, which the fine side owns) and linear prolongation from a
        coarser donor (transverse min-mod on aligned planes, averaging on
        internal planes; reference: src/bvals/bvals_fc.cpp restriction +
        prolongation.hpp ProlongFCShared*/ProlongFCInternal).

        Donor slabs are gathered from ``src_arr`` (the pre-sweep array, so
        donor ghost cells hold the previous sweep's values like the CC
        exchange) and written into ``arr``."""
        from ..refinement import prolong_cc, restrict_cc
        if src_arr is None:
            src_arr = arr

        mesh = self.mesh
        mbi = mesh.mb_indcs
        ng, h = mbi.ng, mbi.ng // 2
        axis4 = _AXIS_OF[ax] - 1
        caxis4 = _AXIS_OF[comp[:2]] - 1  # component's face-normal axis
        normal = (caxis4 == axis4)
        nx_of = {"x1": mbi.nx1, "x2": mbi.nx2, "x3": mbi.nx3}
        nxa = nx_of[ax]
        n4 = arr.shape[axis4]
        active4 = {_AXIS_OF[a] - 1 for a in self.bvals.active_axes}

        def take(a, idx, axis):
            return jnp.take(a, _np.asarray(idx), axis=axis)

        for side in ("m", "p"):
            t = mesh.ml[f"{ax}{side}"]
            tn = t["t_names"]
            if not (t["any_fine"] or t["any_coarse"]):
                continue
            # mixed-level blocks: reset ghost regions to the pre-sweep
            # values so corner rings outside the override write regions
            # keep what earlier sweeps copied (the same-level gather is
            # self-garbage for these blocks)
            mlm4 = local_blocks(
                t["fine_mask"] | t["coarse_mask"]).reshape(
                (-1,) + (1,) * 3)
            if normal:
                gslc = [slice(None)] * 4
                gslc[axis4] = slice(0, ng) if side == "m" \
                    else slice(ng + nxa + 1, n4)
            else:
                gslc = [slice(None)] * 4
                gslc[axis4] = slice(0, ng) if side == "m" \
                    else slice(n4 - ng, n4)
            gslc = tuple(gslc)
            arr = arr.at[gslc].set(
                jnp.where(mlm4, src_arr[gslc], arr[gslc]))

            # ---------------- restriction from finer donors ----------------
            if t["any_fine"]:
                if normal:
                    # plane set includes the shared face (fine-authoritative)
                    if side == "m":
                        planes = _np.arange(0, ng + 1)
                        dn_planes = nxa - ng + 2 * planes
                    else:
                        planes = _np.arange(ng + nxa, n4)
                        dn_planes = ng + 2 * (planes - ng - nxa)
                    slab = take(src_arr, dn_planes, axis4)
                    parts = []
                    for q in range(t["fine"].shape[1]):
                        d = gather_blocks(slab, t["fine"][:, q])
                        d = restrict_cc(d, [_AXIS_OF[a] - 5 for a in tn])
                        parts.append(d)
                    for a2 in tn:
                        ta = _AXIS_OF[a2] - 1
                        keep = nx_of[a2] // 2 + h
                        merged = []
                        for b in range(0, len(parts), 2):
                            lo = take(parts[b], _np.arange(keep), ta)
                            nh = parts[b + 1].shape[ta]
                            hi = take(parts[b + 1], _np.arange(h, nh), ta)
                            merged.append(
                                jnp.concatenate([lo, hi], axis=ta))
                        parts = merged
                    assembled = parts[0]
                    # write the transverse INTERIOR only: the ghost-column
                    # parts of the shared plane must stay what the sweeps
                    # copied from the face's other owner, or same-level
                    # neighbors near a refinement corner would reconstruct
                    # from different bcc and break flux telescoping
                    region = [slice(None)] * 4
                    region[axis4] = planes
                    for a2 in tn:
                        ta = _AXIS_OF[a2] - 1
                        nxt = nx_of[a2]
                        assembled = take(
                            assembled, _np.arange(ng - h, ng - h + nxt), ta)
                        region[ta] = slice(ng, ng + nxt)
                    region = tuple(region)
                    fmask = local_blocks(t["fine_mask"]).reshape((-1,) + (1,) * 3)
                    arr = arr.at[region].set(
                        jnp.where(fmask, assembled, arr[region]))
                else:
                    # transverse component: ghost cells along the sweep axis
                    if side == "m":
                        cells = slice(0, ng)
                        dnc = _np.arange(n4 - 3 * ng, n4 - ng)
                    else:
                        cells = slice(n4 - ng, n4)
                        dnc = _np.arange(ng, 3 * ng)
                    slab = take(src_arr, dnc, axis4)
                    parts = []
                    for q in range(t["fine"].shape[1]):
                        d = gather_blocks(slab, t["fine"][:, q])
                        # pair-average along the sweep axis (cells)
                        d = restrict_cc(d, [axis4 - 4])
                        parts.append(d)
                    # merge along each transverse axis of the sweep
                    for a2 in tn:
                        ta = _AXIS_OF[a2] - 1
                        nxt = nx_of[a2]
                        merged = []
                        if ta == caxis4:
                            # face axis: stride-2 plane select over
                            # [ng-2h, ng+nxt+2h]
                            faces = _np.arange(ng - 2 * h,
                                              ng + nxt + 2 * h + 1, 2)
                            parts = [take(p, faces, ta) for p in parts]
                            keep = nxt // 2 + h
                            for b in range(0, len(parts), 2):
                                lo = take(parts[b], _np.arange(keep), ta)
                                nh = parts[b + 1].shape[ta]
                                hi = take(parts[b + 1],
                                          _np.arange(h, nh), ta)
                                merged.append(
                                    jnp.concatenate([lo, hi], axis=ta))
                        else:
                            parts = [restrict_cc(p, [ta - 4])
                                     for p in parts]
                            keep = nxt // 2 + h
                            for b in range(0, len(parts), 2):
                                lo = take(parts[b], _np.arange(keep), ta)
                                nh = parts[b + 1].shape[ta]
                                hi = take(parts[b + 1],
                                          _np.arange(h, nh), ta)
                                merged.append(
                                    jnp.concatenate([lo, hi], axis=ta))
                        parts = merged
                    assembled = parts[0]
                    region = [slice(None)] * 4
                    region[axis4] = cells
                    for a2 in tn:
                        ta = _AXIS_OF[a2] - 1
                        region[ta] = slice(h, arr.shape[ta] - h)
                    region = tuple(region)
                    fmask = local_blocks(t["fine_mask"]).reshape((-1,) + (1,) * 3)
                    arr = arr.at[region].set(
                        jnp.where(fmask, assembled, arr[region]))

            # ---------------- prolongation from a coarser donor ------------
            if t["any_coarse"]:
                cmask = local_blocks(t["coarse_mask"]).reshape((-1,) + (1,) * 3)
                # corner-strip guard: where the diagonal neighbor is
                # same-level or finer the sweeps already copied the true
                # values there; prolongation must not overwrite them
                # (concave trees; see refinement.build_ml_tables pkeep)
                for a2 in tn:
                    ta = _AXIS_OF[a2] - 1
                    ncc = arr.shape[ta]
                    shp = [1] * 4
                    shp[ta] = ncc
                    pos = _np.arange(ncc).reshape(shp)
                    km = local_blocks(t["pkeep"][a2]["m"]).reshape((-1,) + (1,) * 3)
                    kp = local_blocks(t["pkeep"][a2]["p"]).reshape((-1,) + (1,) * 3)
                    cmask = cmask & ((pos >= ng) | km) \
                        & ((pos < ncc - ng) | kp)

                def window(d, a2, guard):
                    """Parity window along cell axis a2: two static slices
                    + per-block select (static slices instead of a
                    gather)."""
                    ta = _AXIS_OF[a2] - 1
                    half = nx_of[a2] // 2
                    ln = half + ng + 2 * guard
                    s0 = ng - h - guard
                    d0 = jnp.take(d, _np.arange(s0, s0 + ln), axis=ta)
                    d1 = jnp.take(d, _np.arange(s0 + half, s0 + half + ln),
                                  axis=ta)
                    sel = local_blocks(t["par"][a2].astype(bool)).reshape(
                        (-1,) + (1,) * 3)
                    return jnp.where(sel, d1, d0)

                if normal:
                    if side == "m":
                        planes = _np.arange(0, ng)
                        win = _np.arange(ng + nxa - h, ng + nxa + 1)
                        off = lambda f: ng - f         # noqa: E731
                        pidx = lambda m: h - m         # noqa: E731
                    else:
                        planes = _np.arange(ng + nxa + 1, n4)
                        win = _np.arange(ng, ng + h + 1)
                        off = lambda f: f - ng - nxa   # noqa: E731
                        pidx = lambda m: m             # noqa: E731
                    d = take(src_arr, win, axis4)
                    d = gather_blocks(d, t["coarse"])
                    for a2 in tn:
                        d = window(d, a2, 1)
                    pro = prolong_cc(d, [_AXIS_OF[a2] - 5 for a2 in tn])

                    def plane(m):
                        return take(pro, [pidx(m)], axis4)

                    outs = []
                    for f in planes:
                        o = off(int(f))
                        if o % 2 == 0:
                            outs.append(plane(o // 2))
                        else:
                            outs.append(0.5 * (plane((o - 1) // 2)
                                               + plane((o + 1) // 2)))
                    assembled = jnp.concatenate(outs, axis=axis4)
                    region = [slice(None)] * 4
                    region[axis4] = planes
                    region = tuple(region)
                    arr = arr.at[region].set(
                        jnp.where(cmask, assembled, arr[region]))
                else:
                    if side == "m":
                        cells = slice(0, ng)
                        dnc = _np.arange(n4 - ng - h - 1, n4 - ng + 1)
                    else:
                        cells = slice(n4 - ng, n4)
                        dnc = _np.arange(ng - 1, ng + h + 1)
                    d = take(src_arr, dnc, axis4)
                    d = gather_blocks(d, t["coarse"])
                    cell_axes = [axis4 - 4]
                    for a2 in tn:
                        ta = _AXIS_OF[a2] - 1
                        if ta == caxis4:
                            # aligned-plane window along the face axis
                            half = nx_of[a2] // 2
                            ln = half + ng + 1
                            s0 = ng - h
                            d0 = jnp.take(d, _np.arange(s0, s0 + ln),
                                          axis=ta)
                            d1 = jnp.take(
                                d, _np.arange(s0 + half, s0 + half + ln),
                                axis=ta)
                            sel = local_blocks(t["par"][a2].astype(bool)).reshape(
                                (-1,) + (1,) * 3)
                            d = jnp.where(sel, d1, d0)
                        else:
                            d = window(d, a2, 1)
                            cell_axes.append(ta - 4)
                    pro = prolong_cc(d, cell_axes)
                    if caxis4 in active4:
                        # interleave aligned planes with internal averages
                        w = pro.shape[caxis4]
                        aligned = take(pro, _np.arange(w - 1), caxis4)
                        nxt_p = take(pro, _np.arange(1, w), caxis4)
                        internal = 0.5 * (aligned + nxt_p)
                        st = jnp.stack((aligned, internal), axis=caxis4 + 1)
                        sh = aligned.shape
                        inter = st.reshape(sh[:caxis4]
                                           + (2 * (w - 1),)
                                           + sh[caxis4 + 1:])
                        last = take(pro, [w - 1], caxis4)
                        pro = jnp.concatenate([inter, last], axis=caxis4)
                    region = [slice(None)] * 4
                    region[axis4] = cells
                    region = tuple(region)
                    arr = arr.at[region].set(
                        jnp.where(cmask, pro, arr[region]))
        return arr

    def _emf_sync(self, es):
        """Average edge EMFs with all SAME-LEVEL neighbors sharing the
        edge (faces + edge-diagonals), making every shared edge single-
        valued before the fine-replacement pass (reference:
        flux_correct_fc.cpp SumBoundaryFluxes/AverageBoundaryFluxes —
        the reference sums every same-level contribution and divides by
        the count).  On uniform regions the neighbors' values are
        bitwise identical, so this is exact there; at level-boundary
        junctions it reconciles the (differently-prolonged) stencils of
        same-level blocks — without it the corner edge is multi-valued
        and div(B) leaks at concave junctions."""
        mesh = self.mesh
        mbi = mesh.mb_indcs
        ng = mbi.ng
        nx_of = {"x1": mbi.nx1, "x2": mbi.nx2, "x3": mbi.nx3}
        active = self.bvals.active_axes
        out = {}
        for c in ("x1", "x2", "x3"):
            e = es[c]
            ac = _AXIS_OF[c] - 1
            sum_e = e
            cnt = jnp.ones_like(e)
            dims = [d for d in active if d != c]
            # ---- shared planes with same-level face neighbors
            for d in dims:
                ad = _AXIS_OF[d] - 1
                nxd = nx_of[d]
                for side, my_idx, dn_idx in (("m", ng, ng + nxd),
                                             ("p", ng + nxd, ng)):
                    t = mesh.ml[f"{d}{side}"]
                    msk = ~(t["fine_mask"] | t["coarse_mask"] | t["phys"])
                    region = [slice(None)] * 4
                    region[ad] = slice(my_idx, my_idx + 1)
                    dregion = [slice(None)] * 4
                    dregion[ad] = slice(dn_idx, dn_idx + 1)
                    for o in ("x1", "x2", "x3"):
                        if o in (c, d):
                            continue
                        ao = _AXIS_OF[o] - 1
                        if o in active:
                            region[ao] = slice(ng, ng + nx_of[o] + 1)
                            dregion[ao] = region[ao]
                    if c in active:
                        region[ac] = slice(ng, ng + nx_of[c])
                        dregion[ac] = region[ac]
                    region = tuple(region)
                    donor = gather_blocks(e[tuple(dregion)], t["same"])
                    mb = local_blocks(msk).reshape((-1,) + (1,) * 3)
                    sum_e = sum_e.at[region].add(jnp.where(mb, donor, 0.0))
                    cnt = cnt.at[region].add(
                        jnp.where(mb, jnp.ones_like(donor), 0.0))
            # ---- shared corner edges with same-level diagonal neighbors
            if len(dims) == 2:
                d1, d2 = dims
                a1 = _AXIS_OF[d1] - 1
                a2 = _AXIS_OF[d2] - 1
                for s1 in ("m", "p"):
                    for s2 in ("m", "p"):
                        t = mesh.ml.get(f"e_{d1}{s1}{d2}{s2}")
                        if t is None or not t.get("any_same"):
                            continue
                        my1 = ng if s1 == "m" else ng + nx_of[d1]
                        my2 = ng if s2 == "m" else ng + nx_of[d2]
                        dn1 = ng + nx_of[d1] if s1 == "m" else ng
                        dn2 = ng + nx_of[d2] if s2 == "m" else ng
                        region = [slice(None)] * 4
                        region[a1] = slice(my1, my1 + 1)
                        region[a2] = slice(my2, my2 + 1)
                        dregion = [slice(None)] * 4
                        dregion[a1] = slice(dn1, dn1 + 1)
                        dregion[a2] = slice(dn2, dn2 + 1)
                        if c in active:
                            region[ac] = slice(ng, ng + nx_of[c])
                            dregion[ac] = region[ac]
                        region = tuple(region)
                        donor = gather_blocks(e[tuple(dregion)],
                                              t["same_gid"])
                        mb = local_blocks(t["same_mask"]).reshape((-1,) + (1,) * 3)
                        sum_e = sum_e.at[region].add(
                            jnp.where(mb, donor, 0.0))
                        cnt = cnt.at[region].add(
                            jnp.where(mb, jnp.ones_like(donor), 0.0))
            out[c] = sum_e / cnt
        return out

    def _emf_correct(self, e1, e2, e3):
        """SMR EMF correction: on every level-boundary plane, overwrite the
        coarse block's edge EMFs with the line-average of the fine donors'
        edge EMFs, so the CT updates of the shared faces agree and div(B)
        stays at round-off on both levels (reference:
        src/bvals/flux_correction_fc.cpp)."""
        mesh = self.mesh
        mbi = mesh.mb_indcs
        ng = mbi.ng
        nx_of = {"x1": mbi.nx1, "x2": mbi.nx2, "x3": mbi.nx3}
        es = self._emf_sync({"x1": e1, "x2": e2, "x3": e3})
        active = set(self.bvals.active_axes)
        for d in self.bvals.active_axes:
            axis_d = _AXIS_OF[d] - 1
            nxa = nx_of[d]
            for side in ("m", "p"):
                t = mesh.ml[f"{d}{side}"]
                if not t["any_fine"]:
                    continue
                my_idx = ng if side == "m" else ng + nxa
                dn_idx = ng + nxa if side == "m" else ng
                fmask = local_blocks(t["fine_mask"]).reshape((-1,) + (1,) * 3)
                for c in ("x1", "x2", "x3"):
                    if c == d:
                        continue
                    axis_c = _AXIS_OF[c] - 1
                    e = es[c]
                    plane = jnp.take(e, _np.asarray([dn_idx]), axis=axis_d)
                    parts = [gather_blocks(plane, t["fine"][:, q])
                             for q in range(t["fine"].shape[1])]
                    region = [slice(None)] * 4
                    region[axis_d] = slice(my_idx, my_idx + 1)
                    for a2 in t["t_names"]:
                        ta = _AXIS_OF[a2] - 1
                        nxt = nx_of[a2]
                        merged = []
                        if a2 == c:
                            # along the edge direction: line-average pairs
                            # over the donor interior
                            parts = [
                                jnp.take(p, _np.arange(ng, ng + nxt),
                                         axis=ta).reshape(
                                    p.shape[:ta] + (nxt // 2, 2)
                                    + p.shape[ta + 1:]).mean(axis=ta + 1)
                                for p in parts]
                            for b in range(0, len(parts), 2):
                                merged.append(jnp.concatenate(
                                    [parts[b], parts[b + 1]], axis=ta))
                            region[ta] = slice(ng, ng + nxt)
                        else:
                            # corner-aligned: select even donor corners
                            sel = _np.arange(ng, ng + nxt + 1, 2)
                            parts = [jnp.take(p, sel, axis=ta)
                                     for p in parts]
                            for b in range(0, len(parts), 2):
                                lo = jnp.take(parts[b],
                                              _np.arange(nxt // 2), axis=ta)
                                merged.append(jnp.concatenate(
                                    [lo, parts[b + 1]], axis=ta))
                            region[ta] = slice(ng, ng + nxt + 1)
                        parts = merged
                    assembled = parts[0]
                    region = tuple(region)
                    es[c] = e.at[region].set(
                        jnp.where(fmask, assembled, e[region]))

        # ---- edge-diagonal corners: a coarse block touching finer blocks
        # only DIAGONALLY still shares the corner edge with them; give it
        # the same restricted fine EMF so the edge is single-valued mesh-
        # wide (reference: the edge buffers of flux_correction_fc.cpp)
        ax_name = {0: "x1", 1: "x2", 2: "x3"}
        pairs = [(d1, d2) for i, d1 in enumerate(("x1", "x2", "x3"))
                 for d2 in ("x1", "x2", "x3")[i + 1:]
                 if d1 in active and d2 in active]
        for d1, d2 in pairs:
            for s1 in ("m", "p"):
                for s2 in ("m", "p"):
                    t = mesh.ml.get(f"e_{d1}{s1}{d2}{s2}")
                    if t is None or not t["any"]:
                        continue
                    c = ax_name[t["edge_axis"]]
                    e = es[c]
                    a1 = _AXIS_OF[d1] - 1
                    a2 = _AXIS_OF[d2] - 1
                    ac = _AXIS_OF[c] - 1
                    my1 = ng if s1 == "m" else ng + nx_of[d1]
                    my2 = ng if s2 == "m" else ng + nx_of[d2]
                    dn1 = ng + nx_of[d1] if s1 == "m" else ng
                    dn2 = ng + nx_of[d2] if s2 == "m" else ng
                    region = [slice(None)] * 4
                    region[a1] = slice(my1, my1 + 1)
                    region[a2] = slice(my2, my2 + 1)
                    line = jnp.take(e, _np.asarray([dn1]), axis=a1)
                    line = jnp.take(line, _np.asarray([dn2]), axis=a2)
                    parts = [gather_blocks(line, t["fine"][:, q])
                             for q in range(t["fine"].shape[1])]
                    if c in active:
                        nxc = nx_of[c]
                        parts = [
                            jnp.take(p, _np.arange(ng, ng + nxc),
                                     axis=ac).reshape(
                                p.shape[:ac] + (nxc // 2, 2)
                                + p.shape[ac + 1:]).mean(axis=ac + 1)
                            for p in parts]
                        assembled = jnp.concatenate(parts, axis=ac)
                        region[ac] = slice(ng, ng + nxc)
                    else:
                        assembled = parts[0]
                    region = tuple(region)
                    mask = local_blocks(t["mask"]).reshape((-1,) + (1,) * 3)
                    es[c] = e.at[region].set(
                        jnp.where(mask, assembled, e[region]))
        return es["x1"], es["x2"], es["x3"]

    # ------------------------------------------------------- face-field halo
    def fill_ghosts_fc(self, bfc):
        """Halo exchange + physical BCs for the staggered field.

        Sequential axis sweeps like the CC exchange; on the normal axis of
        each component the shared face is owned identically by both blocks,
        so only the ng faces beyond it are exchanged
        (reference: src/bvals/bvals_fc.cpp, buffs_fc.cpp)."""
        bv = self.bvals
        mbi = self.mesh.mb_indcs
        ng = mbi.ng

        # mixed-level meshes sweep twice, like the CC exchange
        for _ in range(2 if self.multilevel else 1):
            for ax in bv.active_axes:
                axis4 = _AXIS_OF[ax] - 1  # face arrays have no var axis
                nxa = {"x1": mbi.nx1, "x2": mbi.nx2, "x3": mbi.nx3}[ax]
                for comp, arr in bfc.items():
                    normal = (comp == f"{ax}f")
                    n = arr.shape[axis4]

                    def slc(lo, hi, axis=axis4):
                        idx = [slice(None)] * 4
                        idx[axis] = slice(lo, hi)
                        return tuple(idx)

                    # concatenate-rebuild instead of slab .at[].set: see the
                    # layout note in bvals._sweep_axis (strided DUS writes)
                    if normal:
                        # ghost faces [0,ng) <- donor faces [nxa, nxa+ng);
                        # ghost faces [ng+nxa+1,n) <- donor [ng+1, 2ng+1)
                        donor_m = bv._exchange(arr[slc(nxa, nxa + ng)],
                                               f"{ax}m")
                        donor_p = bv._exchange(arr[slc(ng + 1, 2 * ng + 1)],
                                               f"{ax}p")
                        mid = arr[slc(ng, ng + nxa + 1)]
                    else:
                        donor_m = bv._exchange(arr[slc(n - 2 * ng, n - ng)],
                                               f"{ax}m")
                        donor_p = bv._exchange(arr[slc(ng, 2 * ng)],
                                               f"{ax}p")
                        mid = arr[slc(ng, n - ng)]
                    new_arr = jnp.concatenate([donor_m, mid, donor_p],
                                              axis=axis4)
                    if self.multilevel:
                        new_arr = self._ml_fc_override(new_arr, ax, comp,
                                                       src_arr=arr)
                    arr = new_arr
                    bfc = {**bfc, comp: arr}
                bfc = self._phys_bc_fc(bfc, ax)
        if self.multilevel:
            bfc = self._fc_fill_corners(bfc)
        return bfc

    def _fc_fill_corners(self, bfc):
        """Direct diagonal-donor fill of face-field edge/corner ghost
        patches (the FC counterpart of bvals._fill_corners; reference:
        the FC edge/corner buffers of src/bvals/bvals_fc.cpp).  Copies
        from same-level diagonal donors; restricts (even-face subsample
        + transverse averaging) from finer diagonal donors."""
        from ..refinement import restrict_cc

        mesh = self.mesh
        mbi = mesh.mb_indcs
        ng, h = mbi.ng, mbi.ng // 2
        nx_of = {"x1": mbi.nx1, "x2": mbi.nx2, "x3": mbi.nx3}
        act = self.bvals.active_axes

        def cell_slices(s, n):
            """(ghost, same-donor, fine-donor) cell slices on one side."""
            if s == "m":
                return (slice(0, ng), slice(n - 2 * ng, n - ng),
                        slice(n - 3 * ng, n - ng))
            return (slice(n - ng, n), slice(ng, 2 * ng),
                    slice(ng, 3 * ng))

        def face_slices(s, nxa):
            """(ghost, same-donor, fine-donor-indices) face slices; the
            fine donor faces are the even (coarse-coincident) ones."""
            if s == "m":
                return (slice(0, ng), slice(nxa, nxa + ng),
                        _np.arange(nxa + ng - 2 * ng, nxa + ng, 2))
            return (slice(nxa + ng + 1, nxa + 2 * ng + 1),
                    slice(ng + 1, 2 * ng + 1),
                    _np.arange(ng + 2, ng + 2 * ng + 1, 2))

        pairs = [(d1, d2) for i, d1 in enumerate(act)
                 for d2 in act[i + 1:]]
        out = dict(bfc)
        for comp, arr0 in bfc.items():
            nrm = comp[:2]
            cax = _AXIS_OF[nrm] - 1
            arr = arr0
            for d1, d2 in pairs:
                a1, a2 = _AXIS_OF[d1] - 1, _AXIS_OF[d2] - 1
                rest = [a for a in act if a not in (d1, d2)]
                for s1 in ("m", "p"):
                    for s2 in ("m", "p"):
                        t = mesh.ml.get(f"e_{d1}{s1}{d2}{s2}")
                        if t is None or not (t.get("any_same")
                                             or t.get("any")):
                            continue
                        my, dn, fn = {}, {}, {}
                        for (d, a, s) in ((d1, a1, s1), (d2, a2, s2)):
                            if d == nrm:
                                my[a], dn[a], fn[a] = face_slices(
                                    s, nx_of[d])
                            else:
                                my[a], dn[a], fn[a] = cell_slices(
                                    s, arr.shape[a])
                        region = [slice(None)] * 4
                        region[a1], region[a2] = my[a1], my[a2]
                        if t.get("any_same"):
                            drg = [slice(None)] * 4
                            drg[a1], drg[a2] = dn[a1], dn[a2]
                            donor = gather_blocks(arr[tuple(drg)],
                                                  t["same_gid"])
                            mb = local_blocks(t["same_mask"]).reshape((-1,) + (1,) * 3)
                            rg = tuple(region)
                            arr = arr.at[rg].set(
                                jnp.where(mb, donor, arr[rg]))
                        if t.get("any"):
                            drg = [slice(None)] * 4
                            drg[a1], drg[a2] = fn[a1], fn[a2]
                            caxes = [a for a in (a1, a2) if a != cax]
                            rrest = None
                            if rest:
                                ar = _AXIS_OF[rest[0]] - 1
                                rrest = ar
                                if ar != cax:
                                    caxes.append(ar)
                            parts = []
                            for q in range(t["fine"].shape[1]):
                                d = gather_blocks(arr[tuple(drg)],
                                                  t["fine"][:, q])
                                if rrest is not None and rrest == cax:
                                    # edge axis is the face axis:
                                    # even-face subsample over the
                                    # guarded span (per _ml_fc_override)
                                    faces = _np.arange(
                                        ng - 2 * h,
                                        ng + nx_of[nrm] + 2 * h + 1, 2)
                                    d = jnp.take(d, faces, axis=cax)
                                d = restrict_cc(
                                    d, [a - 4 for a in caxes])
                                parts.append(d)
                            rg = list(region)
                            if rrest is not None:
                                nxt = nx_of[rest[0]]
                                keep = nxt // 2 + h
                                ar = rrest
                                lo = jnp.take(parts[0], _np.arange(keep),
                                              axis=ar)
                                nh = parts[1].shape[ar]
                                hi = jnp.take(parts[1],
                                              _np.arange(h, nh), axis=ar)
                                assembled = jnp.concatenate([lo, hi],
                                                            axis=ar)
                                rg[ar] = slice(h, arr.shape[ar] - h)
                            else:
                                assembled = parts[0]
                            rg = tuple(rg)
                            mb = local_blocks(t["mask"]).reshape((-1,) + (1,) * 3)
                            arr = arr.at[rg].set(
                                jnp.where(mb, assembled, arr[rg]))
            if len(act) == 3:
                for s1 in ("m", "p"):
                    for s2 in ("m", "p"):
                        for s3 in ("m", "p"):
                            t = mesh.ml.get(f"v_{s1}{s2}{s3}")
                            if t is None or not (t["any_same"]
                                                 or t["any_fine"]):
                                continue
                            my, dn, fn = {}, {}, {}
                            for (d, s) in (("x1", s1), ("x2", s2),
                                           ("x3", s3)):
                                a = _AXIS_OF[d] - 1
                                if d == nrm:
                                    my[a], dn[a], fn[a] = face_slices(
                                        s, nx_of[d])
                                else:
                                    my[a], dn[a], fn[a] = cell_slices(
                                        s, arr.shape[a])
                            axs = [_AXIS_OF[d] - 1
                                   for d in ("x1", "x2", "x3")]
                            region = [slice(None)] * 4
                            for a in axs:
                                region[a] = my[a]
                            region = tuple(region)
                            if t["any_same"]:
                                drg = [slice(None)] * 4
                                for a in axs:
                                    drg[a] = dn[a]
                                donor = gather_blocks(arr[tuple(drg)],
                                                      t["same_gid"])
                                mb = local_blocks(
                                    t["same_mask"]).reshape(
                                    (-1,) + (1,) * 3)
                                arr = arr.at[region].set(
                                    jnp.where(mb, donor, arr[region]))
                            if t["any_fine"]:
                                drg = [slice(None)] * 4
                                for a in axs:
                                    drg[a] = fn[a]
                                d = gather_blocks(arr[tuple(drg)],
                                                  t["fine_gid"])
                                d = restrict_cc(
                                    d, [a - 4 for a in axs if a != cax])
                                mb = local_blocks(
                                    t["fine_mask"]).reshape(
                                    (-1,) + (1,) * 3)
                                arr = arr.at[region].set(
                                    jnp.where(mb, d, arr[region]))
                            # NOTE: fine-vertex face subsample along the
                            # normal axis happens via fn's even spacing
            out[comp] = arr
        return out

    def _phys_bc_fc(self, bfc, ax: str):
        """Physical BCs for face fields
        (reference: src/bvals/physics/bfield_bcs.cpp:81-155)."""
        bv = self.bvals
        ng = self.mesh.mb_indcs.ng
        for side in ("m", "p"):
            key = f"{ax}{side}"
            if not bv.any_phys[key]:
                continue
            flag = bv.flag[key]
            if flag in ("periodic", "shear_periodic", "user"):
                continue
            mask = bv._local_mask(key).reshape((-1,) + (1,) * 3)
            for comp, arr in bfc.items():
                axis4 = _AXIS_OF[ax] - 1
                normal = (comp == f"{ax}f")
                n = arr.shape[axis4]

                def slc(lo, hi):
                    idx = [slice(None)] * 4
                    idx[axis4] = slice(lo, hi)
                    return tuple(idx)

                if flag in ("outflow", "diode", "vacuum"):
                    if normal:
                        if side == "m":
                            edge = arr[slc(ng, ng + 1)]
                            ghost = slc(0, ng)
                        else:
                            edge = arr[slc(n - ng - 1, n - ng)]
                            ghost = slc(n - ng, n)
                    else:
                        if side == "m":
                            edge = arr[slc(ng, ng + 1)]
                            ghost = slc(0, ng)
                        else:
                            edge = arr[slc(n - ng - 1, n - ng)]
                            ghost = slc(n - ng, n)
                    bc = jnp.broadcast_to(edge, arr[ghost].shape)
                elif flag == "reflect":
                    if normal:
                        # b_normal(is-i-1) = -b_normal(is+i+1): mirror about
                        # the boundary face, negated
                        if side == "m":
                            src = arr[slc(ng + 1, 2 * ng + 1)]
                            bc = -jnp.flip(src, axis=axis4)
                            ghost = slc(0, ng)
                        else:
                            src = arr[slc(n - 2 * ng - 1, n - ng - 1)]
                            bc = -jnp.flip(src, axis=axis4)
                            ghost = slc(n - ng, n)
                    else:
                        if side == "m":
                            src = arr[slc(ng, 2 * ng)]
                            bc = jnp.flip(src, axis=axis4)
                            ghost = slc(0, ng)
                        else:
                            src = arr[slc(n - 2 * ng, n - ng)]
                            bc = jnp.flip(src, axis=axis4)
                            ghost = slc(n - ng, n)
                else:
                    raise ValueError(
                        f"B-field boundary flag '{flag}' not implemented")
                arr = arr.at[ghost].set(jnp.where(mask, bc, arr[ghost]))
                bfc = {**bfc, comp: arr}
        return bfc

    # ----------------------------------------------------------------- FOFC
    def _apply_fofc(self, u, u1, w, bcc, bfc, flx, emf,
                    gam0, gam1, beta_dt):
        """First-order flux correction for MHD: flagged cells get donor-
        cell LLF fluxes AND face EMFs (reference: MHD::FOFC,
        src/mhd/mhd_fofc.cpp).  Returns (flx, emf, nfofc)."""
        flag = None
        if self.use_fofc:
            utest = self.rk_update(u, u1, flx, gam0, gam1, beta_dt)
            _, u_fixed, _ = self.cons_to_prim(utest, bcc)
            flag = jnp.any(u_fixed != utest, axis=1)
        if self.fofc_excise_mask is not None:
            em = jnp.asarray(local_blocks(self.fofc_excise_mask))
            flag = em if flag is None else (flag | em)
        if flag is None:
            return flx, emf, jnp.asarray(0)

        if self.is_gr:
            from ..ops.rsolvers_grmhd import llf_grmhd as first_order
        elif self.is_sr:
            from ..ops.rsolvers_srmhd import llf_srmhd as first_order
        else:
            from ..ops.rsolvers_mhd import llf as first_order
        bface = {
            "x1": bfc["x1f"][..., :-1],
            "x2": bfc["x2f"][..., :-1, :],
            "x3": bfc["x3f"][:, :-1, :, :],
        }
        ey_name = {"x1": "e3x1", "x2": "e1x2", "x3": "e2x3"}
        ez_name = {"x1": "e2x1", "x2": "e3x2", "x3": "e1x3"}
        out_f = dict(flx)
        out_e = dict(emf)
        for name, axis, ivx, _dx in self.dirs:
            wl = jnp.roll(w, 1, axis=axis)
            wr = w
            bl = jnp.roll(bcc, 1, axis=axis)
            br = bcc
            if self.is_gr:
                gl, gu = self.geom.metric(name)
                f1, ey1, ez1 = first_order(wl, wr, bl, br, bface[name],
                                           self.eos, ivx, gl, gu)
            else:
                f1, ey1, ez1 = first_order(wl, wr, bl, br, bface[name],
                                           self.eos, ivx)
            if self.nscalars > 0:
                fd = f1[:, IDN:IDN + 1]
                ns = self.nmhd
                fs = jnp.where(fd >= 0.0, fd * wl[:, ns:], fd * wr[:, ns:])
                f1 = f1.at[:, ns:].set(fs)
            fmask = flag | jnp.roll(flag, 1, axis=axis - 1)
            out_f[name] = jnp.where(fmask[:, None], f1, out_f[name])
            out_e[ey_name[name]] = jnp.where(fmask, ey1,
                                             out_e[ey_name[name]])
            out_e[ez_name[name]] = jnp.where(fmask, ez1,
                                             out_e[ez_name[name]])
        return out_f, out_e, jnp.sum(flag)

    # --------------------------------------------------------- GR srcterms
    def coord_src_terms(self, u, w, bcc, beta_dt):
        """Geometric momentum sources S_i = 1/2 T^{ab} d_i(g_ab) with the
        magnetic stress included (reference: Coordinates::CoordSrcTerms MHD
        version, src/coordinates/coordinates.cpp:244-376)."""
        gl, gu = self.geom.metric("cc")
        dgs = self.geom.metric_derivatives()
        gp = self.eos.gamma / (self.eos.gamma - 1.0)

        rho = w[:, IDN]
        p = self.eos.pressure(w[:, IEN])
        wvx, wvy, wvz = w[:, IVX], w[:, IVY], w[:, IVZ]
        bxc, byc, bzc = bcc[:, 0], bcc[:, 1], bcc[:, 2]
        q = (gl[1][1] * wvx * wvx + gl[2][2] * wvy * wvy
             + gl[3][3] * wvz * wvz
             + 2.0 * (gl[1][2] * wvx * wvy + gl[1][3] * wvx * wvz
                      + gl[2][3] * wvy * wvz))
        alpha = jnp.sqrt(-1.0 / gu[0][0])
        gam = jnp.sqrt(1.0 + q)
        uv = {0: gam / alpha,
              1: wvx - alpha * gam * gu[0][1],
              2: wvy - alpha * gam * gu[0][2],
              3: wvz - alpha * gam * gu[0][3]}
        u_1 = (gl[1][0] * uv[0] + gl[1][1] * uv[1] + gl[1][2] * uv[2]
               + gl[1][3] * uv[3])
        u_2 = (gl[2][0] * uv[0] + gl[2][1] * uv[1] + gl[2][2] * uv[2]
               + gl[2][3] * uv[3])
        u_3 = (gl[3][0] * uv[0] + gl[3][1] * uv[1] + gl[3][2] * uv[2]
               + gl[3][3] * uv[3])
        b0 = u_1 * bxc + u_2 * byc + u_3 * bzc
        bv = {0: b0,
              1: (bxc + b0 * uv[1]) / uv[0],
              2: (byc + b0 * uv[2]) / uv[0],
              3: (bzc + b0 * uv[3]) / uv[0]}
        b_sq = None
        for mu in range(4):
            bl_mu = (gl[mu][0] * bv[0] + gl[mu][1] * bv[1]
                     + gl[mu][2] * bv[2] + gl[mu][3] * bv[3])
            t = bl_mu * bv[mu]
            b_sq = t if b_sq is None else b_sq + t

        wtot = rho + gp * p + b_sq
        ptot = p + 0.5 * b_sq

        from ..indices import IM1, IM2, IM3
        for d, im in ((0, IM1), (1, IM2), (2, IM3)):
            dg = dgs[d]
            s = None
            for mu in range(4):
                for nu in range(mu, 4):
                    fac = 0.5 if mu == nu else 1.0
                    tt = (wtot * uv[mu] * uv[nu] + ptot * gu[mu][nu]
                          - bv[mu] * bv[nu])
                    term = fac * dg[mu][nu] * tt
                    s = term if s is None else s + term
            u = u.at[:, im].add(beta_dt * s)
        return u

    # ---------------------------------------------------------------- newdt
    def new_dt(self, w, bcc):
        """min dx / (|v| + c_fast) per direction
        (reference: src/mhd/mhd_newdt.cpp)."""
        mbi = self.mesh.mb_indcs
        sl = (slice(None), slice(None),
              slice(mbi.ks, mbi.ke + 1),
              slice(mbi.js, mbi.je + 1),
              slice(mbi.is_, mbi.ie + 1))
        wa = w[sl]
        ba = bcc[sl]
        d = wa[:, IDN]
        if self.time_evolution == "kinematic":
            dv1 = jnp.abs(wa[:, IVX])
            dv2 = jnp.abs(wa[:, IVY])
            dv3 = jnp.abs(wa[:, IVZ])
        elif self.is_gr:
            one = jnp.ones_like(wa[:, IVX])
            dv1 = dv2 = dv3 = one
        elif self.is_sr:
            from ..ops.eos_sr import sr_mhd_fast_speeds
            ux, uy, uz = wa[:, IVX], wa[:, IVY], wa[:, IVZ]
            lor = jnp.sqrt(1.0 + ux * ux + uy * uy + uz * uz)
            p = self.eos.pressure(wa[:, IEN])
            # b^mu b_mu from cell-centered field
            bx, by, bz = ba[:, 0], ba[:, 1], ba[:, 2]
            b0 = bx * ux + by * uy + bz * uz
            b1 = (bx + b0 * ux) / lor
            b2_ = (by + b0 * uy) / lor
            b3 = (bz + b0 * uz) / lor
            bsq = -b0 * b0 + b1 * b1 + b2_ * b2_ + b3 * b3
            lp1, lm1 = sr_mhd_fast_speeds(self.eos, d, p, ux, lor, bsq)
            lp2, lm2 = sr_mhd_fast_speeds(self.eos, d, p, uy, lor, bsq)
            lp3, lm3 = sr_mhd_fast_speeds(self.eos, d, p, uz, lor, bsq)
            dv1 = jnp.maximum(jnp.abs(lm1), lp1)
            dv2 = jnp.maximum(jnp.abs(lm2), lp2)
            dv3 = jnp.maximum(jnp.abs(lm3), lp3)
        else:
            p = self.eos.pressure(wa[:, IEN]) if self.eos.is_ideal else None
            b1, b2, b3 = ba[:, 0], ba[:, 1], ba[:, 2]
            cf1 = self.eos.mhd_fast_speed(d, p, b1, b2, b3)
            cf2 = self.eos.mhd_fast_speed(d, p, b2, b3, b1)
            cf3 = self.eos.mhd_fast_speed(d, p, b3, b1, b2)
            dv1 = jnp.abs(wa[:, IVX]) + cf1
            dv2 = jnp.abs(wa[:, IVY]) + cf2
            dv3 = jnp.abs(wa[:, IVZ]) + cf3

        dt = jnp.min(self._ldx4("x1") / dv1)
        if mbi.nx2 > 1:
            dt = jnp.minimum(dt, jnp.min(self._ldx4("x2") / dv2))
        if mbi.nx3 > 1:
            dt = jnp.minimum(dt, jnp.min(self._ldx4("x3") / dv3))
        return dt

    # ------------------------------------------------- state-dict interface
    def make_state(self, u, w, bfc, bcc=None):
        state = {"u": u, "w": w, "bfc": bfc,
                 "bcc": bcc if bcc is not None else self.compute_bcc(bfc)}
        if self.pturb is not None:
            state.update(self.pturb.init_state_entries(u.dtype))
        if self.ppart is not None:
            state.update(self.ppart.init_state_entries(u.dtype))
        if self.psbox is not None:
            state["t"] = jnp.asarray(0.0, dtype=u.dtype)
        from ..multigrid import MGPoisson
        if isinstance(self.pgrav, MGPoisson):
            # warm-start carrier for the per-stage multigrid solve
            state["phi"] = jnp.zeros((u.shape[0], 1) + u.shape[2:],
                                     dtype=u.dtype)
        return state

    def save_state(self, state):
        return {"u1": state["u"], "bfc1": state["bfc"]}

    def accumulate_rk4(self, saved, state, delta):
        return {"u1": saved["u1"] + delta * state["u"],
                "bfc1": {k: saved["bfc1"][k] + delta * state["bfc"][k]
                         for k in saved["bfc1"]}}

    def init_ghosts(self, state):
        u = self.bvals.fill_ghosts(state["u"])
        bfc = self.fill_ghosts_fc(state["bfc"])
        bcc = self.compute_bcc(bfc)
        w, u, _ = self.cons_to_prim(u, bcc)
        if self.bvals.prolong_prims:
            u, w = self.bvals.prolong_prims_fixup(
                u, w, lambda w2: self.prim_to_cons(w2, bcc))
        out = dict(state)
        out.update({"u": u, "w": w, "bfc": bfc, "bcc": bcc})
        return out

    def stage_update(self, state, saved, gam0, gam1, beta_dt):
        """One RK stage (reference task chain mhd_tasks.cpp:48-81)."""
        u, w, bfc, bcc = state["u"], state["w"], state["bfc"], state["bcc"]
        flx, emf = self.fluxes(w, bcc, bfc)
        nfofc = None
        if self.use_fofc or self.fofc_excise_mask is not None:
            flx, emf, nfofc = self._apply_fofc(
                u, saved["u1"], w, bcc, bfc, flx, emf, gam0, gam1, beta_dt)
        if self.multilevel:
            from ..refinement import flux_correct_cc
            flx = flux_correct_cc(flx, self.mesh, [d[0] for d in self.dirs])
        # gravity is solved from the pre-update state: the reference runs
        # MGGravityDriver::Solve before the stagen task list
        # (reference: driver.cpp:406-408); multigrid warm-starts from the
        # previous stage's potential carried in state["phi"]
        phi = None
        if self.pgrav is not None:
            phi = self.pgrav.solve(u, self.bvals,
                                   phi0=state.get("phi"))
        u = self.rk_update(u, saved["u1"], flx, gam0, gam1, beta_dt)
        if self.is_gr:
            u = self.coord_src_terms(u, w, bcc, beta_dt)
        if self.srcterms is not None and self.srcterms.any_enabled:
            u = self.srcterms.apply(u, w, beta_dt, flx=flx, phi=phi)
        if self.psbox is not None:
            u = self.psbox.src_terms(u, w, beta_dt, self.eos.is_ideal,
                                     len(self.dirs) == 3, bcc=bcc)
        if self.srcterms_func is not None:
            u = self._user_srcs(u, w, beta_dt, bcc, t=state.get("t"))
        e1, e2, e3 = self.corner_e(
            w, bcc, {n: flx[n][:, IDN] for n in flx}, emf, bfc=bfc)
        if self.multilevel:
            e1, e2, e3 = self._emf_correct(e1, e2, e3)
        if self.psbox is not None and not self.psbox.oa_active:
            # 2D r-z: background orbital EMF enters as an FC source
            e1, e2 = self.psbox.src_terms_fc(e1, e2, bfc)
        bfc = self.ct_update(bfc, saved["bfc1"], e1, e2, e3,
                             gam0, gam1, beta_dt)
        u = self.bvals.fill_ghosts(u)
        bfc = self.fill_ghosts_fc(bfc)
        if self.psbox is not None:
            u = self.psbox.remap_ghosts(u, state["t"])
            bfc = self.psbox.remap_ghosts_fc(bfc, state["t"])
        bcc = self.compute_bcc(bfc)
        w, u, counters = self.cons_to_prim(u, bcc)
        if self.bvals.prolong_prims:
            u, w = self.bvals.prolong_prims_fixup(
                u, w, lambda w2: self.prim_to_cons(w2, bcc))
        if nfofc is not None:
            counters = dict(counters, nfofc=nfofc)
        out = dict(state)
        out.update({"u": u, "w": w, "bfc": bfc, "bcc": bcc})
        if phi is not None and "phi" in state:
            out["phi"] = phi
        return out, counters


    def _user_srcs(self, u, w, beta_dt, bcc, t=None):
        """Apply the pgen-enrolled source term.  Functions that declare
        ``needs_bcc = True`` receive the cell-centered field as a kwarg
        (reference: user_srcs_func reads pmbp->pmhd->bcc0 directly,
        e.g. BarotropicCooling in src/pgen/tests/be_collapse.cpp);
        ``needs_time = True`` adds the simulation time (reference:
        user sources receive (Mesh*, time, dt) — time-dependent terms
        like orbiting planets need it, disk-magnetosphere.cpp)."""
        kw = {}
        if getattr(self.srcterms_func, "needs_bcc", False):
            kw["bcc"] = bcc
        if getattr(self.srcterms_func, "needs_time", False):
            kw["t"] = t
        if kw:
            return self.srcterms_func(u, w, beta_dt, **kw)
        return self.srcterms_func(u, w, beta_dt)

    def dt_from_state(self, state):
        dt = self.new_dt(state["w"], state["bcc"])
        ndim = len(self.dirs)
        dtype = state["w"].dtype
        if self.pvisc is not None:
            dt = jnp.minimum(dt, self.pvisc.new_dt(ndim, dtype))
        if self.pcond is not None:
            dt = jnp.minimum(dt, self.pcond.new_dt(ndim, dtype))
        if self.presist is not None:
            dt = jnp.minimum(dt, self.presist.new_dt(
                state["bcc"], ndim, dtype, self.mesh.mb_indcs))
        if self.srcterms is not None and self.srcterms.any_enabled:
            dt = jnp.minimum(dt, self.srcterms.new_dt(state["w"]))
        if self.ppart is not None:
            dt = jnp.minimum(dt, jnp.asarray(self.ppart.new_dt(),
                                             dtype=dtype))
        return dt
