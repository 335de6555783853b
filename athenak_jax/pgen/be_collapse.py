"""Bonnor-Ebert sphere collapse with self-gravity and Jeans AMR.

Parity target: reference src/pgen/tests/be_collapse.cpp (port of the
Athena++ collapse.cpp generator; Tomida & Stone 2023, ApJS 266, 7) and
the inputs/tests/be_collapse{,_mhd}.athinput decks — the workload the
multigrid multipole boundary conditions exist for:

  * enhanced BE density profile rho = f (1 + r^2/rcsq)^{-3/2} with
    rcsq = rc^2/3 (Tomida 2011 approximation), clamped at the cloud
    radius rc, optional m=2 bar perturbation and solid-body rotation
    omega = omegatff/tff with tff = pi sqrt(3/(8f));
  * a cgs unit system derived from (mass [Msun], temperature [K]):
    m0 = mass*msun/(bemass*f), v0 = cs10 sqrt(T/10),
    rho0 = v0^6/(m0^2 64 pi^3 G^3), t0 = 1/sqrt(4 pi G rho0)
    (be_collapse.cpp:120-131);
  * uniform Bz from the mass-to-flux ratio mu (mucrit1 =
    0.53/(3 pi) sqrt(5/G), be_collapse.cpp:170-178);
  * barotropic cooling source: e_int = rho/(gamma-1)
    sqrt(1 + (rho/rhocrit)^{2(gamma-1)}) — isothermal below rhocrit,
    adiabatic above — plus zeroed momentum outside the cloud
    (BarotropicCooling, be_collapse.cpp:361-440);
  * Jeans AMR criterion nJ = v_eff/sqrt(rho_max) * 2 pi/dx with
    v_eff = cs (+ max Alfven speed for isothermal MHD); refine below
    njeans, derefine above 2.5 njeans (JeansRefinement,
    be_collapse.cpp:444-524).

Design: ICs build in host numpy; the cooling source is a pointwise
masked jnp expression whose per-block coordinate tables rebuild at trace
time (the AMR driver retraces after tree updates, so they stay fresh);
the Jeans criterion is a host-side per-block reduction like the other
AMR criteria.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..indices import IDN, IEN, IM1, IM2, IM3

# dimensionless BE constants (be_collapse.cpp:40-43)
RC_DEFAULT = 6.45
RCSQ_FAC = 1.0 / 3.0
BEMASS = 197.561

# physical constants, cgs (be_collapse.cpp:45-50)
CS10 = 1.9e4
MSUN = 1.9891e33
AU = 1.4959787e13
YR = 3.15569e7
G_CGS = 6.67259e-8


def _be_profile(r, rcsq):
    return (1.0 + r * r / rcsq) ** -1.5


def init(pin, mesh, phys):
    is_mhd = getattr(phys, "is_mhd", False)
    eos = phys.eos
    is_ideal = eos.is_ideal
    gamma = eos.gamma if is_ideal else 5.0 / 3.0
    cs = 1.0 if is_ideal else eos.iso_cs

    rc = pin.get_or_add_real("problem", "cloud_radius", RC_DEFAULT)
    mass = pin.get_or_add_real("problem", "mass", 0.0)
    temp = pin.get_or_add_real("problem", "temperature", 0.0)
    f = pin.get_or_add_real("problem", "f", 1.2)
    amp = pin.get_or_add_real("problem", "amp", 0.0)
    xc = pin.get_or_add_real("problem", "x_center", 0.0)
    yc = pin.get_or_add_real("problem", "y_center", 0.0)
    zc = pin.get_or_add_real("problem", "z_center", 0.0)
    njeans = pin.get_or_add_real("problem", "njeans", 16.0)
    rcsq = rc * rc * RCSQ_FAC

    # unit system from (mass, temperature) (be_collapse.cpp:120-131)
    if mass > 0.0 and temp > 0.0:
        m0 = mass * MSUN / (BEMASS * f)
        v0 = CS10 * math.sqrt(temp / 10.0)
        rho0 = v0 ** 6 / (m0 ** 2 * 64.0 * math.pi ** 3 * G_CGS ** 3)
        t0 = 1.0 / math.sqrt(4.0 * math.pi * G_CGS * rho0)
        l0 = v0 * t0
        gauss_unit = math.sqrt(rho0 * v0 * v0 * 4.0 * math.pi)
    else:
        m0 = v0 = rho0 = t0 = l0 = gauss_unit = 0.0

    rhocrit_cgs = pin.get_or_add_real("problem", "rhocrit", 0.0)
    rhocrit = rhocrit_cgs / rho0 if (rhocrit_cgs > 0.0
                                     and rho0 > 0.0) else 0.0

    # solid-body rotation (be_collapse.cpp:163-166)
    tff = math.sqrt(3.0 / (8.0 * f)) * math.pi
    omegatff = pin.get_or_add_real("problem", "omegatff", 0.0)
    omega = omegatff / tff

    # magnetic field from the mass-to-flux ratio (be_collapse.cpp:170-178)
    bz = 0.0
    if is_mhd:
        mu = pin.get_or_add_real("problem", "mu", 0.0)
        if mu > 0.0 and mass > 0.0:
            mucrit1 = 0.53 / (3.0 * math.pi) * math.sqrt(5.0 / G_CGS)
            bz = mass * MSUN / (mucrit1 * mu * math.pi
                                * (rc * l0) ** 2) / gauss_unit
        else:
            bz = pin.get_or_add_real("problem", "b0_z", 0.0)

    four_pi_G = pin.get_or_add_real("gravity", "four_pi_G", 1.0)
    if getattr(phys, "pgrav", None) is not None:
        phys.pgrav.four_pi_G = four_pi_G
        if hasattr(phys.pgrav, "set_four_pi_G"):
            phys.pgrav.set_four_pi_G(four_pi_G)

    # ---- initial condition (primitives; be_collapse.cpp:186-300) ----
    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    igm1 = 1.0 / (gamma - 1.0) if is_ideal else 0.0
    w = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    act = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.is_ + mbi.nx1))
    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        X3, X2, X1 = np.meshgrid(x3v[act[0]], x2v[act[1]], x1v[act[2]],
                                 indexing="ij")
        r = np.sqrt((X1 - xc) ** 2 + (X2 - yc) ** 2 + (X3 - zc) ** 2)
        rho = f * _be_profile(np.minimum(r, rc), rcsq)
        if amp > 0.0:
            rho = np.where(
                r < rc,
                rho * (1.0 + amp * r * r / (rc * rc)
                       * np.cos(2.0 * np.arctan2(X2 - yc, X1 - xc))),
                rho)
        inside = r < rc
        w[gid, IDN][act] = rho
        w[gid, IM1][act] = np.where(inside, omega * (X2 - yc), 0.0)
        w[gid, IM2][act] = np.where(inside, -omega * (X1 - xc), 0.0)
        if is_ideal:
            # p = rho cs^2 with cs = 1 initially -> e_int = rho/(gm-1)
            w[gid, IEN][act] = rho * igm1

    # ---- Jeans AMR criterion (JeansRefinement) ----
    def jeans_refinement(state, mesh):
        mbi = mesh.mb_indcs
        uu = np.asarray(state["u"])
        rho_max = uu[:, IDN].max(axis=(1, 2, 3))
        v_eff = np.full(uu.shape[0], cs)
        if is_mhd and not is_ideal:
            bcc = np.asarray(state["bcc"])
            bsq = (bcc ** 2).sum(axis=1)
            v_eff = cs + np.sqrt((bsq / uu[:, IDN]).max(axis=(1, 2, 3)))
        dx = np.asarray(mesh.mb_size["dx1"])
        nj = v_eff / np.sqrt(np.maximum(rho_max, 1e-300)) \
            * (2.0 * math.pi / dx)
        flags = np.zeros(uu.shape[0], dtype=np.int64)
        flags[nj < njeans] = 1
        flags[nj > njeans * 2.5] = -1
        return flags

    phys.user_refine_func = jeans_refinement

    # ---- barotropic cooling (BarotropicCooling) ----
    if is_ideal and rhocrit > 0.0:
        gm1 = gamma - 1.0
        live_mesh = mesh  # AMR retraces the cycle; read geometry fresh

        def barotropic(u, wprim, beta_dt, bcc=None):
            m = live_mesh
            mbi = m.mb_indcs
            nmb_now = u.shape[0]
            xv = np.empty((nmb_now, 1, 1, mbi.ncells1))
            yv = np.empty((nmb_now, 1, mbi.ncells2, 1))
            zv = np.empty((nmb_now, mbi.ncells3, 1, 1))
            for g in range(min(nmb_now, m.nmb_total)):
                c1, c2, c3 = m.cell_centers(g)
                xv[g, 0, 0], yv[g, 0, :, 0], zv[g, :, 0, 0] = c1, c2, c3
            for g in range(m.nmb_total, nmb_now):  # pool pad slots
                xv[g], yv[g], zv[g] = xv[0], yv[0], zv[0]
            from ..comm import local_blocks
            r2 = ((jnp.asarray(local_blocks(xv, pad_edge=True)) - xc) ** 2
                  + (jnp.asarray(local_blocks(yv, pad_edge=True))
                     - yc) ** 2
                  + (jnp.asarray(local_blocks(zv, pad_edge=True))
                     - zc) ** 2)
            outside = r2 > rc * rc
            mx = jnp.where(outside, 0.0, u[:, IM1])
            my = jnp.where(outside, 0.0, u[:, IM2])
            mz = jnp.where(outside, 0.0, u[:, IM3])
            rho = u[:, IDN]
            ke = 0.5 * (mx * mx + my * my + mz * mz) / rho
            me = 0.0
            if bcc is not None:
                me = 0.5 * jnp.sum(bcc * bcc, axis=1)
            te = (rho / gm1) * jnp.sqrt(
                1.0 + (rho / rhocrit) ** (2.0 * gm1))
            u = u.at[:, IM1].set(mx)
            u = u.at[:, IM2].set(my)
            u = u.at[:, IM3].set(mz)
            u = u.at[:, IEN].set(te + ke + me)
            return u

        barotropic.needs_bcc = is_mhd
        phys.srcterms_func = barotropic

    from . import state_from_prims

    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    wj = w.astype(dtype)
    if is_mhd:
        bfc = {k: np.zeros(s, dtype=dtype)
               for k, s in phys.fc_shapes.items()}
        bfc["x3f"][:] = bz
        return state_from_prims(phys, wj, bfc)
    return state_from_prims(phys, wj)
