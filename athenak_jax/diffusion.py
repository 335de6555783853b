"""Diffusion physics: viscosity, thermal conduction, resistivity, ambipolar.

Parity target: the reference diffusion classes
(reference: src/diffusion/viscosity.cpp:30-251, conduction.cpp:65-379,
resistivity.cpp:28-364, ambipolar.cpp, current_density.hpp).

Design: all diffusion operators are whole-array roll stencils on
the cell-indexed face-flux / edge-EMF layout (entry i = lower face/edge of
cell i), fused by XLA into the ideal-flux computation.  Diffusive fluxes are
*added into* the Godunov fluxes, so the conservative RK update applies them
for free — exactly the reference's structure.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .indices import IDN, IEN, IVX, IVY, IVZ

_HUGE = float(np.finfo(np.float32).max)

# axes in 4D per-channel arrays [nmb, n3, n2, n1]
_KA, _JA, _IA = 1, 2, 3


def _m1(a, ax):
    """a at index-1 (circular; wrap lands in ghosts, refilled later)."""
    return jnp.roll(a, 1, axis=ax)


def _p1(a, ax):
    return jnp.roll(a, -1, axis=ax)


def _dt_fac(ndim: int) -> float:
    """Explicit diffusion CFL prefactor per dimensionality
    (reference: viscosity.cpp:234-240)."""
    return {1: 0.5, 2: 0.25, 3: 1.0 / 6.0}[ndim]


def _dx_tab(mesh):
    """{name: dx} — scalar on uniform meshes, per-block [nmb, 1, 1, 1]
    on multilevel meshes (broadcast against 4D per-channel arrays)."""
    if getattr(mesh, "multilevel", False):
        return {n: mesh.mb_size[f"d{n}"].reshape(-1, 1, 1, 1)
                for n in ("x1", "x2", "x3")}
    ms = mesh.mesh_size
    return {"x1": ms.dx1, "x2": ms.dx2, "x3": ms.dx3}


def _dx_min(mesh, name: str) -> float:
    """Finest spacing along an axis (diffusion dt limit on SMR/AMR)."""
    if getattr(mesh, "multilevel", False):
        return float(np.min(mesh.mb_size[f"d{name}"]))
    return getattr(mesh.mesh_size, f"d{name}")


class Viscosity:
    """Isotropic shear viscosity (reference: src/diffusion/viscosity.cpp)."""

    def __init__(self, block: str, pin, mesh, eos) -> None:
        self.mesh = mesh
        self.eos = eos
        self.nu_iso = pin.get_or_add_real(block, "nu_iso", 0.0)
        self.nu_aniso = pin.get_or_add_real(block, "nu_aniso", 0.0)

    def add_viscous_flux(self, w, flx, dirs):
        """Add viscous momentum+energy fluxes into the face fluxes.

        ``dirs`` is the physics module's direction list
        [(name, axis5, ivx, dx), ...].  Discretization matches
        reference viscosity.cpp:64-214: normal derivatives are 2-point
        face differences; transverse derivatives are the average of the
        two adjacent cells' central differences.
        """
        if self.nu_iso == 0.0:
            return flx
        nu = self.nu_iso
        active = {name for name, *_ in dirs}
        vel = {"x1": w[:, IVX], "x2": w[:, IVY], "x3": w[:, IVZ]}
        iv = {"x1": IVX, "x2": IVY, "x3": IVZ}
        ax4 = {"x1": _IA, "x2": _JA, "x3": _KA}
        dxs = _dx_tab(self.mesh)
        dens = w[:, IDN]

        out = dict(flx)
        for n in active:
            a_n = ax4[n]
            dn = dxs[n]
            trans = [t for t in ("x1", "x2", "x3") if t != n and t in active]

            def face_avg_ddt(comp, t):
                """d(comp)/d(t) at the n-face: avg of central diffs of the
                two cells sharing the face."""
                a_t = ax4[t]
                c = vel[comp]
                cm = _m1(c, a_n)
                return ((_p1(c, a_t) + _p1(cm, a_t))
                        - (_m1(c, a_t) + _m1(cm, a_t))) / (4.0 * dxs[t])

            # tau_{n,n} = 4/3 dvn/dn - 2/3 sum_t dvt/dt
            f = {}
            f[n] = 4.0 * (vel[n] - _m1(vel[n], a_n)) / (3.0 * dn)
            for t in trans:
                f[n] = f[n] - (2.0 / 3.0) * face_avg_ddt(t, t)
                # tau_{t,n} = dvt/dn + dvn/dt
                f[t] = (vel[t] - _m1(vel[t], a_n)) / dn \
                    + face_avg_ddt(n, t)
            # components with no active transverse axis still diffuse along n
            for t in ("x1", "x2", "x3"):
                if t not in f:
                    f[t] = (vel[t] - _m1(vel[t], a_n)) / dn

            nud = 0.5 * nu * (dens + _m1(dens, a_n))
            fl = out[n]
            for comp in ("x1", "x2", "x3"):
                fl = fl.at[:, iv[comp]].add(-nud * f[comp])
            if self.eos.is_ideal:
                en = None
                for comp in ("x1", "x2", "x3"):
                    vface = _m1(vel[comp], a_n) + vel[comp]
                    term = vface * f[comp]
                    en = term if en is None else en + term
                fl = fl.at[:, IEN].add(-0.5 * nud * en)
            out[n] = fl
        return out

    def new_dt(self, ndim: int, dtype):
        if self.nu_iso == 0.0:
            return jnp.asarray(_HUGE, dtype=dtype)
        fac = _dt_fac(ndim)
        dt = fac * _dx_min(self.mesh, "x1") ** 2 / self.nu_iso
        if ndim > 1:
            dt = min(dt, fac * _dx_min(self.mesh, "x2") ** 2 / self.nu_iso)
        if ndim > 2:
            dt = min(dt, fac * _dx_min(self.mesh, "x3") ** 2 / self.nu_iso)
        return jnp.asarray(dt, dtype=dtype)


class Conduction:
    """Isotropic thermal conduction, q = -alpha * rho * dT/dx
    (reference: src/diffusion/conduction.cpp:65-152).  alpha is a
    diffusivity; the conductivity is kappa = rho * alpha."""

    def __init__(self, block: str, pin, mesh, eos) -> None:
        self.mesh = mesh
        self.eos = eos
        if not eos.is_ideal:
            raise ValueError("thermal conduction requires ideal gas EOS")
        self.alpha_iso = pin.get_or_add_real(block, "alpha_iso", 0.0)
        self.alpha_aniso = pin.get_or_add_real(block, "alpha_aniso", 0.0)
        self.alpha_spitzer = pin.get_or_add_boolean(block, "alpha_spitzer",
                                                    False)
        if self.alpha_spitzer:
            raise NotImplementedError(
                "Spitzer conduction is disabled in the reference snapshot "
                "(reference: conduction.cpp:168-230 commented out)")

    def add_heat_flux(self, w, flx, dirs):
        if self.alpha_iso == 0.0:
            return flx
        gm1 = self.eos.gamma - 1.0
        dxs = _dx_tab(self.mesh)
        ax4 = {"x1": _IA, "x2": _JA, "x3": _KA}
        temp = w[:, IEN] / w[:, IDN]
        dens = w[:, IDN]
        out = dict(flx)
        for name, _axis5, _ivx, _dx in dirs:
            a = ax4[name]
            dtempdx = (temp - _m1(temp, a)) * gm1 / dxs[name]
            densf = 0.5 * (dens + _m1(dens, a))
            out[name] = out[name].at[:, IEN].add(
                -self.alpha_iso * densf * dtempdx)
        return out

    def new_dt(self, ndim: int, dtype):
        if self.alpha_iso == 0.0:
            return jnp.asarray(_HUGE, dtype=dtype)
        fac = _dt_fac(ndim)
        a = self.alpha_iso
        dt = fac * _dx_min(self.mesh, "x1") ** 2 / a
        if ndim > 1:
            dt = min(dt, fac * _dx_min(self.mesh, "x2") ** 2 / a)
        if ndim > 2:
            dt = min(dt, fac * _dx_min(self.mesh, "x3") ** 2 / a)
        return jnp.asarray(dt, dtype=dtype)


class Resistivity:
    """Ohmic resistivity + ambipolar diffusion (constant coefficients)
    (reference: src/diffusion/resistivity.cpp, ambipolar.cpp)."""

    def __init__(self, pin, mesh, eos) -> None:
        self.mesh = mesh
        self.eos = eos
        self.eta_ohm = pin.get_or_add_real("mhd", "eta_ohm", 0.0)
        self.eta_ad = pin.get_or_add_real("mhd", "eta_ad", 0.0)

    # ------------------------------------------------------------------
    def _edge_currents(self, bfc, ndim: int):
        """Edge-centered current density (cell-indexed: entry (k,j,i) is
        the edge at the lower corner of cell (k,j,i)), from the staggered
        field curl (reference: src/diffusion/current_density.hpp)."""
        dxs = _dx_tab(self.mesh)
        b1 = bfc["x1f"][..., :-1]          # face i-1/2 at cell index i
        b2 = bfc["x2f"][..., :-1, :]
        b3 = bfc["x3f"][:, :-1, :, :]
        zero = jnp.zeros_like(b1)

        multi_d = ndim > 1
        three_d = ndim > 2
        # J1 = dB3/dx2 - dB2/dx3 at (i, j-1/2, k-1/2)
        j1 = zero
        if multi_d:
            j1 = j1 + (b3 - _m1(b3, _JA)) / dxs["x2"]
        if three_d:
            j1 = j1 - (b2 - _m1(b2, _KA)) / dxs["x3"]
        # J2 = dB1/dx3 - dB3/dx1 at (i-1/2, j, k-1/2)
        j2 = -(b3 - _m1(b3, _IA)) / dxs["x1"]
        if three_d:
            j2 = j2 + (b1 - _m1(b1, _KA)) / dxs["x3"]
        # J3 = dB2/dx1 - dB1/dx2 at (i-1/2, j-1/2, k)
        j3 = (b2 - _m1(b2, _IA)) / dxs["x1"]
        if multi_d:
            j3 = j3 - (b1 - _m1(b1, _JA)) / dxs["x2"]
        return j1, j2, j3

    # ------------------------------------------------------------------
    def add_resistive_emf(self, bfc, bcc, e1, e2, e3, ndim: int):
        """E += eta_ohm * J + eta_ad * [B^2 J - (J.B) B] at cell edges
        (reference: resistivity.cpp:80-184, ambipolar.cpp:57-235)."""
        if self.eta_ohm == 0.0 and self.eta_ad == 0.0:
            return e1, e2, e3
        j1, j2, j3 = self._edge_currents(bfc, ndim)

        if self.eta_ohm != 0.0:
            e1 = e1 + self.eta_ohm * j1
            e2 = e2 + self.eta_ohm * j2
            e3 = e3 + self.eta_ohm * j3

        if self.eta_ad != 0.0:
            eta = self.eta_ad
            b1 = bfc["x1f"][..., :-1]
            b2 = bfc["x2f"][..., :-1, :]
            b3 = bfc["x3f"][:, :-1, :, :]
            bx, by, bz = bcc[:, 0], bcc[:, 1], bcc[:, 2]

            def avg4(a, axa, axb):
                return 0.25 * (a + _m1(a, axa) + _m1(a, axb)
                               + _m1(_m1(a, axa), axb))

            def edge_avg4(j, axa, axb):
                """Average an edge-centered J onto a different edge
                (reference: ambipolar.cpp:178-185 4-point averages)."""
                return 0.25 * (j + _p1(j, axa) + _m1(j, axb)
                               + _p1(_m1(j, axb), axa))

            # e1 edges (i, j-1/2, k-1/2)
            intj2 = edge_avg4(j2, _IA, _JA)   # J2 at (i±, j-1..j)
            intj3 = edge_avg4(j3, _IA, _KA)
            ibx = avg4(bx, _JA, _KA)
            iby = 0.5 * (b2 + _m1(b2, _KA))
            ibz = 0.5 * (b3 + _m1(b3, _JA))
            bsq = ibx * ibx + iby * iby + ibz * ibz
            jdb = j1 * ibx + intj2 * iby + intj3 * ibz
            e1 = e1 + eta * (bsq * j1 - jdb * ibx)

            # e2 edges (i-1/2, j, k-1/2)
            intj1 = edge_avg4(j1, _JA, _IA)
            intj3 = edge_avg4(j3, _JA, _KA)
            ibx2 = 0.5 * (b1 + _m1(b1, _KA))
            iby2 = avg4(by, _IA, _KA)
            ibz2 = 0.5 * (b3 + _m1(b3, _IA))
            bsq = ibx2 * ibx2 + iby2 * iby2 + ibz2 * ibz2
            jdb = intj1 * ibx2 + j2 * iby2 + intj3 * ibz2
            e2 = e2 + eta * (bsq * j2 - jdb * iby2)

            # e3 edges (i-1/2, j-1/2, k)
            intj1 = edge_avg4(j1, _KA, _IA)
            intj2 = edge_avg4(j2, _KA, _JA)
            ibx3 = 0.5 * (b1 + _m1(b1, _JA))
            iby3 = 0.5 * (b2 + _m1(b2, _IA))
            ibz3 = avg4(bz, _IA, _JA)
            bsq = ibx3 * ibx3 + iby3 * iby3 + ibz3 * ibz3
            jdb = intj1 * ibx3 + intj2 * iby3 + j3 * ibz3
            e3 = e3 + eta * (bsq * j3 - jdb * ibz3)

        return e1, e2, e3

    # ------------------------------------------------------------------
    def add_resistive_flux(self, bfc, bcc, flx, dirs, ndim: int):
        """Poynting energy flux from resistive EMFs, F = (eta J) x B
        (reference: resistivity.cpp:191-280, ambipolar.cpp:248-330).
        Edge EMFs are averaged to faces, then crossed with face B."""
        if (self.eta_ohm == 0.0 and self.eta_ad == 0.0) \
                or not self.eos.is_ideal:
            return flx
        j1, j2, j3 = self._edge_currents(bfc, ndim)
        b1 = bfc["x1f"][..., :-1]
        b2 = bfc["x2f"][..., :-1, :]
        b3 = bfc["x3f"][:, :-1, :, :]

        # resistive EMF at edges (Ohmic part; ambipolar handled via bcc avg)
        if self.eta_ohm != 0.0:
            re1, re2, re3 = (self.eta_ohm * j1, self.eta_ohm * j2,
                             self.eta_ohm * j3)
        else:
            z = jnp.zeros_like(j1)
            re1, re2, re3 = z, z, z
        if self.eta_ad != 0.0:
            # S_AD = eta_ad*B^2*(J x B); B^2 at edges approximated with the
            # same interpolations as the EMF (reference ambipolar.cpp:243-246)
            bsq_c = (bcc[:, 0] ** 2 + bcc[:, 1] ** 2 + bcc[:, 2] ** 2)

            def to_edge(axa, axb):
                return 0.25 * (bsq_c + _m1(bsq_c, axa) + _m1(bsq_c, axb)
                               + _m1(_m1(bsq_c, axa), axb))

            re1 = re1 + self.eta_ad * to_edge(_JA, _KA) * j1
            re2 = re2 + self.eta_ad * to_edge(_KA, _IA) * j2
            re3 = re3 + self.eta_ad * to_edge(_IA, _JA) * j3

        out = dict(flx)
        active = {name for name, *_ in dirs}
        # x1 faces: F1 = E2*B3 - E3*B2, edge values averaged to the face
        f = out["x1"]
        e2f = 0.5 * (re2 * (b3 + _m1(b3, _IA))
                     + _p1(re2, _KA) * (_p1(b3, _KA) + _m1(_p1(b3, _KA), _IA)))
        e3f = 0.5 * (re3 * (b2 + _m1(b2, _IA))
                     + _p1(re3, _JA) * (_p1(b2, _JA) + _m1(_p1(b2, _JA), _IA)))
        out["x1"] = f.at[:, IEN].add(0.5 * (e2f - e3f))
        if "x2" in active:
            f = out["x2"]
            e3f = 0.5 * (re3 * (b1 + _m1(b1, _JA))
                         + _p1(re3, _IA) * (_p1(b1, _IA)
                                            + _m1(_p1(b1, _IA), _JA)))
            e1f = 0.5 * (re1 * (b3 + _m1(b3, _JA))
                         + _p1(re1, _KA) * (_p1(b3, _KA)
                                            + _m1(_p1(b3, _KA), _JA)))
            out["x2"] = f.at[:, IEN].add(0.5 * (e3f - e1f))
        if "x3" in active:
            f = out["x3"]
            e1f = 0.5 * (re1 * (b2 + _m1(b2, _KA))
                         + _p1(re1, _JA) * (_p1(b2, _JA)
                                            + _m1(_p1(b2, _JA), _KA)))
            e2f = 0.5 * (re2 * (b1 + _m1(b1, _KA))
                         + _p1(re2, _IA) * (_p1(b1, _IA)
                                            + _m1(_p1(b1, _IA), _KA)))
            out["x3"] = f.at[:, IEN].add(0.5 * (e1f - e2f))
        return out

    # ------------------------------------------------------------------
    def new_dt(self, bcc, ndim: int, dtype, mb_indcs=None):
        """dt <= fac dx^2 / (eta_ohm + eta_ad B^2) per cell
        (reference: resistivity.cpp:283-364)."""
        if self.eta_ohm == 0.0 and self.eta_ad == 0.0:
            return jnp.asarray(_HUGE, dtype=dtype)
        fac = _dt_fac(ndim)
        dx2min = _dx_min(self.mesh, "x1") ** 2
        if ndim > 1:
            dx2min = min(dx2min, _dx_min(self.mesh, "x2") ** 2)
        if ndim > 2:
            dx2min = min(dx2min, _dx_min(self.mesh, "x3") ** 2)
        if self.eta_ad == 0.0:
            return jnp.asarray(fac * dx2min / self.eta_ohm, dtype=dtype)
        mbi = mb_indcs if mb_indcs is not None else self.mesh.mb_indcs
        sl = (slice(None), slice(None),
              slice(mbi.ks, mbi.ke + 1),
              slice(mbi.js, mbi.je + 1),
              slice(mbi.is_, mbi.ie + 1))
        bsq = (bcc[sl][:, 0] ** 2 + bcc[sl][:, 1] ** 2 + bcc[sl][:, 2] ** 2)
        eta_tot = self.eta_ohm + self.eta_ad * bsq
        return jnp.min(fac * dx2min / jnp.maximum(eta_tot, 1e-300)) \
            .astype(dtype)
