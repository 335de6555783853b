"""Composed radiation + hydro/MHD physics module.

Parity target: the reference MeshBlockPack running Radiation alongside
Hydro or MHD with the RadFluidCoupling source exchange (reference:
src/mesh/meshblock_pack.cpp AddPhysics radiation+fluid branches,
src/radiation/radiation_tasks.cpp task ordering: fluxes -> updates ->
RadFluidCoupling -> boundary exchange -> c2p).

Design: one composed module whose jitted stage runs the fluid
stage, the intensity transport update, and the vectorized implicit
coupling back-to-back; the whole cycle stays one XLA program.
"""

from __future__ import annotations

import jax.numpy as jnp

from .coupling import rad_fluid_coupling
from .radiation import Radiation


class RadiationFluid:
    """<radiation> + <hydro> or <mhd> (reference: rad_hydro/rad_mhd)."""

    def __init__(self, pin, mesh, bvals) -> None:
        from ..physics.hydro import Hydro
        from ..physics.mhd import MHD

        self.mesh = mesh
        self.bvals = bvals
        if pin.does_block_exist("mhd"):
            self.fluid = MHD(pin, mesh, bvals)
        else:
            self.fluid = Hydro(pin, mesh, bvals)
        self.rad = Radiation(pin, mesh, bvals)
        self.is_mhd = self.fluid.is_mhd
        self.eos = self.fluid.eos
        if not self.eos.is_ideal:
            raise ValueError("radiation coupling requires the ideal EOS")
        self.nvar = self.fluid.nvar
        self.nhydro = getattr(self.fluid, "nhydro",
                              getattr(self.fluid, "nmhd", 5))
        self.nscalars = self.fluid.nscalars
        self.shape = self.fluid.shape
        self.dirs = self.fluid.dirs
        self.is_sr = self.fluid.is_sr
        self.is_gr = self.fluid.is_gr
        if not self.is_gr:
            # the angular coupling uses the lowered-index (T^0_0-like)
            # energy convention of the GR fluid; Minkowski runs set
            # <coord> general_rel=true + minkowski=true like the
            # reference (radiation.cpp:46-52)
            raise ValueError(
                "radiation-fluid coupling requires <coord> "
                "general_rel=true (use minkowski=true for flat space)")
        self.multilevel = getattr(self.fluid, "multilevel", False)
        self.geom = getattr(self.fluid, "geom", None)
        self.pturb = None
        self.ppart = None
        self.psbox = None
        self.pgrav = None
        self.srcterms_func = None
        self.user_hist_func = None
        # forward MHD face-field helpers when composed with MHD
        if self.is_mhd:
            self.fc_shapes = self.fluid.fc_shapes
            self.compute_bcc = self.fluid.compute_bcc
            self.fill_ghosts_fc = self.fluid.fill_ghosts_fc

    # ------------------------------------------------------------------
    def allocate(self, dtype):
        return self.fluid.allocate(dtype)

    def cons_to_prim(self, u, bcc=None):
        if self.is_mhd:
            return self.fluid.cons_to_prim(u, bcc)
        return self.fluid.cons_to_prim(u)

    def prim_to_cons(self, w, bcc=None):
        if self.is_mhd:
            return self.fluid.prim_to_cons(w, bcc)
        return self.fluid.prim_to_cons(w)

    # ------------------------------------------------------------------
    def make_state(self, u, w, i0, bfc=None):
        if self.is_mhd:
            state = self.fluid.make_state(u, w, bfc)
        else:
            state = self.fluid.make_state(u, w)
        state["i0"] = i0
        return state

    def save_state(self, state):
        saved = self.fluid.save_state(state)
        saved["i1"] = state["i0"]
        return saved

    def accumulate_rk4(self, saved, state, delta):
        out = self.fluid.accumulate_rk4(saved, state, delta)
        out["i1"] = saved["i1"] + delta * state["i0"]
        return out

    def init_ghosts(self, state):
        out = self.fluid.init_ghosts(state)
        out["i0"] = self.bvals.fill_ghosts(state["i0"])
        return out

    # ------------------------------------------------------------------
    def stage_update(self, state, saved, gam0, gam1, beta_dt):
        """Fluid stage + intensity transport + implicit coupling
        (reference task order: radiation_tasks.cpp:45-90)."""
        rad = self.rad
        i0 = state["i0"]
        # transport update of the intensities (uses pre-stage state)
        flx = rad.fluxes(i0)
        i0_new = rad.rk_update(i0, saved["i1"], flx, gam0, gam1, beta_dt)
        if rad.beam_dii0 is not None:
            i0_new = i0_new + beta_dt * rad.beam_dii0
        i0_new = rad._floor(i0_new)

        # fluid stage (fluxes/update/srcterms/ghosts/c2p)
        out, counters = self.fluid.stage_update(state, saved, gam0,
                                                gam1, beta_dt)

        # implicit comoving-frame exchange (uses the freshly updated w)
        if (not rad.fixed_fluid or rad.kappa_a > 0.0
                or rad.kappa_s > 0.0
                or getattr(rad, "power_opacity", False)):
            gm1 = self.eos.gamma - 1.0
            i0_new, u_new = rad_fluid_coupling(
                rad, i0_new, out["u"], out["w"], gm1, beta_dt,
                affect_fluid=(rad.affect_fluid and not rad.fixed_fluid))
            if rad.affect_fluid and not rad.fixed_fluid:
                u_new = self.bvals.fill_ghosts(u_new)
                if self.is_mhd:
                    w_new, u_new, _ = self.fluid.cons_to_prim(
                        u_new, out["bcc"])
                else:
                    w_new, u_new, _ = self.fluid.cons_to_prim(u_new)
                out = dict(out, u=u_new, w=w_new)
        i0_new = self.bvals.fill_ghosts(i0_new)
        out["i0"] = i0_new
        return out, counters

    # ------------------------------------------------------------------
    def dt_from_state(self, state):
        dt = self.fluid.dt_from_state(state)
        return jnp.minimum(dt, self.rad.dt_from_state(
            {"u": state["i0"]}))

    # ------------------------------------------------------------- outputs
    def coord_moments(self, state):
        return self.rad.coord_moments({"u": state["i0"]})

    def coord_energy_density(self, state):
        return self.rad.coord_energy_density({"u": state["i0"]})
