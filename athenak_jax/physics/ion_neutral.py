"""Ion-neutral two-fluid coupling with ImEx time integration.

Parity target: the reference ``IonNeutral`` module
(reference: src/ion-neutral/ion-neutral.cpp:25-31,
ion-neutral_tasks.cpp:95-295): neutrals evolve as Hydro, ions as MHD,
coupled by a stiff drag term gamma_d (rho_i rho_n)(v_n - v_i) plus
optional ionization/recombination, integrated with the Pareschi & Russo
ImEx-SSP schemes — the drag is solved analytically in the implicit
stages, the flux divergences explicitly.

Design: the interleaved task DAG collapses into ``imex_cycle``, one
pure function per cycle: two pre-stages of the implicit solve, then per
explicit stage (hydro stage, MHD stage, accumulate a_twid history, solve
implicit drag, recompute the stiff residual).  The stiff-residual history
``ru`` lives in the state pytree.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..indices import IDN, IM1, IM2, IM3
from .hydro import Hydro
from .mhd import MHD


class IonNeutral:
    is_mhd = False  # top-level u/w are the neutral fluid

    def __init__(self, pin, mesh, bvals) -> None:
        self.mesh = mesh
        self.bvals = bvals
        self.drag_coeff = pin.get_real("ion-neutral", "drag_coeff")
        if getattr(mesh, "multilevel", False):
            raise NotImplementedError(
                "ion-neutral with static mesh refinement is not supported yet")
        self.xi = pin.get_or_add_real("ion-neutral", "ionization_coeff", 0.0)
        self.alpha = pin.get_or_add_real(
            "ion-neutral", "recombination_coeff", 0.0)
        self.phydro = Hydro(pin, mesh, bvals)   # neutrals
        self.pmhd = MHD(pin, mesh, bvals)       # ions
        self.eos = self.phydro.eos
        self.nvar = self.phydro.nvar
        self.pturb = self.phydro.pturb
        self.ppart = None
        self.psbox = None

    # ---------------------------------------------------------------- state
    def make_state(self, un, wn, ui, wi, bfc):
        mbi = self.mesh.mb_indcs
        nimp = 4  # max implicit stages (imex3); imex2 uses first 3
        # block axis leads so the history shards over the device mesh
        # like every other state leaf (parallel/shard_comm state specs)
        ru = jnp.zeros((self.mesh.nmb_total, nimp, 8,
                        mbi.ncells3, mbi.ncells2, mbi.ncells1),
                       dtype=un.dtype)
        return {"u": un, "w": wn,
                "ui": ui, "wi": wi,
                "bfc": bfc, "bcc": self.pmhd.compute_bcc(bfc),
                "ru": ru}

    def _hyd(self, state):
        return {"u": state["u"], "w": state["w"]}

    def _ion(self, state):
        return {"u": state["ui"], "w": state["wi"],
                "bfc": state["bfc"], "bcc": state["bcc"]}

    def init_ghosts(self, state):
        h = self.phydro.init_ghosts(self._hyd(state))
        m = self.pmhd.init_ghosts(self._ion(state))
        return dict(state, u=h["u"], w=h["w"], ui=m["u"], wi=m["w"],
                    bfc=m["bfc"], bcc=m["bcc"])

    def dt_from_state(self, state):
        dt_n = self.phydro.dt_from_state(self._hyd(state))
        dt_i = self.pmhd.dt_from_state(self._ion(state))
        return jnp.minimum(dt_n, dt_i)

    # ------------------------------------------------------------- implicit
    def _stiff_residual(self, ui, un):
        """R(U): drag + ionization/recombination source channels
        (reference: ion-neutral_tasks.cpp:259-288)."""
        g, xi, al = self.drag_coeff, self.xi, self.alpha
        di, dn = ui[:, IDN], un[:, IDN]
        out = []
        for im in (IM1, IM2, IM3):
            out.append(g * (di * un[:, im] - dn * ui[:, im])
                       + xi * un[:, im] - al * di * ui[:, im])
        for im in (IM1, IM2, IM3):
            out.append(g * (dn * ui[:, im] - di * un[:, im])
                       - xi * un[:, im] + al * di * ui[:, im])
        out.append(xi * dn - al * di * di)
        out.append(-xi * dn + al * di * di)
        return jnp.stack(out, axis=1)  # [nmb, 8, n3, n2, n1]

    def _imp_update(self, state, istage, integ, dt):
        """One implicit stage (reference: IonNeutral::ImpRKUpdate,
        ion-neutral_tasks.cpp:145-290)."""
        ui, un, ru = state["ui"], state["u"], state["ru"]

        # (a) accumulate explicit combination of previous stiff residuals
        if istage > 1:
            for s in range(istage - 1):
                if integ.a_twid[istage - 2][s] == 0.0:
                    continue
                adt = integ.a_twid[istage - 2][s] * dt
                r = ru[:, s]
                for c, im in ((0, IM1), (1, IM2), (2, IM3)):
                    ui = ui.at[:, im].add(adt * r[:, c])
                for c, im in ((3, IM1), (4, IM2), (5, IM3)):
                    un = un.at[:, im].add(adt * r[:, c])
                ui = ui.at[:, IDN].add(adt * r[:, 6])
                un = un.at[:, IDN].add(adt * r[:, 7])

        # (b) analytic implicit solve for drag/ionization/recombination
        if istage <= integ.nimp_stages:
            g_adt = self.drag_coeff * integ.a_impl * dt
            xi_adt = self.xi * integ.a_impl * dt
            al_adt = self.alpha * integ.a_impl * dt

            rho_i = ui[:, IDN]
            if self.alpha > 0.0:
                d = (1.0 / (4.0 * al_adt ** 2)
                     + xi_adt / (2.0 * al_adt ** 2)
                     + xi_adt ** 2 / (4.0 * al_adt ** 2)
                     + ui[:, IDN] / al_adt
                     + xi_adt / al_adt * (ui[:, IDN] + un[:, IDN]))
                rho_i = (-1.0 / (2.0 * al_adt) - xi_adt / (2.0 * al_adt)
                         + jnp.sqrt(d))
            rho_n = ui[:, IDN] + un[:, IDN] - rho_i
            ui = ui.at[:, IDN].set(rho_i)
            un = un.at[:, IDN].set(rho_n)

            denom = 1.0 + g_adt * (rho_i + rho_n) + xi_adt + al_adt * rho_i
            for im in (IM1, IM2, IM3):
                tot = ui[:, im] + un[:, im]
                u_i = (ui[:, im] + (g_adt * rho_i + xi_adt) * tot) / denom
                ui = ui.at[:, im].set(u_i)
                un = un.at[:, im].set(tot - u_i)

            # (c) store the stiff residual at the new state
            ru = ru.at[:, istage - 1].set(self._stiff_residual(ui, un))
        return dict(state, ui=ui, u=un, ru=ru)

    # ---------------------------------------------------------------- cycle
    def imex_cycle(self, state, dt, integ):
        """Full ImEx cycle (reference: FirstTwoImpRK +
        per-stage ImpRKUpdate after the explicit updates)."""
        if self.pturb is not None:
            state = self.pturb.apply(state, dt, self.phydro)

        # register copy BEFORE the implicit pre-stages (reference:
        # FirstTwoImpRK copies u0 -> u1 first, ion-neutral_tasks.cpp:103-108)
        saved_h = self.phydro.save_state(self._hyd(state))
        saved_m = self.pmhd.save_state(self._ion(state))

        # first two fully implicit stages (istage = 1, 2)
        state = self._imp_update(state, 1, integ, dt)
        state = self._imp_update(state, 2, integ, dt)
        h = self.phydro.cons_to_prim(state["u"])
        m = self.pmhd.cons_to_prim(state["ui"], state["bcc"])
        state = dict(state, w=h[0], u=h[1], wi=m[0], ui=m[1])

        counters_tot = None
        for s in range(integ.nexp_stages):
            bdt = integ.beta[s] * dt
            hs, ch = self.phydro.stage_update(
                self._hyd(state), saved_h, integ.gam0[s], integ.gam1[s], bdt)
            ms, cm = self.pmhd.stage_update(
                self._ion(state), saved_m, integ.gam0[s], integ.gam1[s], bdt)
            state = dict(state, u=hs["u"], w=hs["w"], ui=ms["u"],
                         wi=ms["w"], bfc=ms["bfc"], bcc=ms["bcc"])
            # implicit stage istage = s + 3 in 1-based counting after the
            # two pre-stages (reference: istage = estage + 2 with estage
            # starting at 1)
            state = self._imp_update(state, s + 3, integ, dt)
            h = self.phydro.cons_to_prim(state["u"])
            m = self.pmhd.cons_to_prim(state["ui"], state["bcc"])
            state = dict(state, w=h[0], u=h[1], wi=m[0], ui=m[1])
            c = {f"n_{k}": v for k, v in {**ch, **cm}.items()}
            counters_tot = c if counters_tot is None else \
                {k: counters_tot[k] + v for k, v in c.items()}

        dtnew = self.dt_from_state(state)
        return state, dtnew, counters_tot
