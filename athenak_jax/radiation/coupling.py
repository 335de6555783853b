"""Implicit radiation-fluid coupling in the comoving frame.

Parity target: ``Radiation::RadFluidCoupling`` (reference:
src/radiation/radiation_source.cpp:34-392): per-cell implicit exchange
between the gas and the specific intensities — absorption/scattering
with the exact quartic solve for the equilibrium gas temperature
(FourthPolyRoot), energy/momentum given to the fluid as the difference
of radiation moments.

Design: every per-angle loop is a sum over the channel axis; the
quartic root and its fallback branches become ``where`` masks, so the
whole solve is one fused elementwise pass.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

FOUR_PI = 4.0 * math.pi


def fourth_poly_root(coef4, tconst):
    """Exact real root of coef4 x^4 + x + tconst = 0 (reference:
    FourthPolyRoot, radiation_source.cpp:396-436).  Returns (root, ok)
    with ok False where no acceptable root exists."""
    ccubic = tconst * tconst * tconst
    delta1 = 0.25 - 64.0 * ccubic * coef4 / 27.0
    ok = delta1 >= 0.0
    delta1 = jnp.sqrt(jnp.maximum(delta1, 0.0))
    ok = ok & (delta1 >= 0.5)
    zroot = jnp.where(
        delta1 > 1.0e11,
        (jnp.maximum(delta1, 1e-300) ** (-2.0 / 3.0)) / 3.0,
        jnp.cbrt(0.5 + delta1) - jnp.cbrt(jnp.maximum(delta1 - 0.5, 0.0)))
    ok = ok & (zroot >= 0.0)
    zroot = zroot * jnp.maximum(coef4, 1e-300) ** (-2.0 / 3.0)
    rcoef = jnp.sqrt(jnp.maximum(zroot, 0.0))
    delta2 = -zroot + 2.0 / jnp.maximum(coef4 * rcoef, 1e-300)
    ok = ok & (delta2 >= 0.0)
    root = 0.5 * (jnp.sqrt(jnp.maximum(delta2, 0.0)) - rcoef)
    ok = ok & (root >= 0.0) & jnp.isfinite(root)
    return root, ok


def rad_fluid_coupling(rad, i0, u, w, gm1, dt_eff, affect_fluid=True):
    """One implicit coupling step.  Returns (i0_new, u_new).

    ``rad``: the Radiation module (tetrads, grid, opacities);
    ``u, w``: fluid conserved/primitive arrays; ``dt_eff``: the stage's
    beta*dt.  All arrays full-extent; the ghost refill afterwards is the
    caller's job (reference applies over active zones then exchanges)."""
    from ..indices import IDN, IEN, IVX, IVY, IVZ
    from ..gr.cks import metric

    n0, n_0, n_mu, n2t = rad.tet_quantities()
    sang = rad.sang
    nh = rad.nh4  # [nangles, 4]
    nh_b = [nh[:, a].reshape(1, -1, 1, 1, 1) for a in range(4)]

    from .radiation import _lb as _local
    xv, yv, zv = (_local(c) for c in rad._coords[:3])
    X = xv[:, None, None, :]
    Y = yv[:, None, :, None]
    Z = zv[:, :, None, None]
    gl, gu = metric(X, Y, Z, rad.spin, rad.minkowski)
    alpha = 1.0 / jnp.sqrt(-gu[0][0])

    wdn = w[:, IDN]
    wvx, wvy, wvz = w[:, IVX], w[:, IVY], w[:, IVZ]
    wen = w[:, IEN]
    pgas = gm1 * wen
    tgas = pgas / wdn
    q = (gl[1][1] * wvx * wvx + 2.0 * gl[1][2] * wvx * wvy
         + 2.0 * gl[1][3] * wvx * wvz + gl[2][2] * wvy * wvy
         + 2.0 * gl[2][3] * wvy * wvz + gl[3][3] * wvz * wvz)
    gamma = jnp.sqrt(1.0 + q)
    u0 = gamma / alpha

    if getattr(rad, "power_opacity", False):
        # Kramers power-law opacity kappa ~ rho T^-3.5 (reference:
        # radiation_opacities.hpp OpacityFunction power branch; unit
        # scales and the Rosseland coefficients default to 1/0 in code
        # units exactly like radiation_source.cpp:65-75)
        ross = getattr(rad, "rosseland_coef", 1.0)
        pmr = getattr(rad, "planck_minus_rosseland_coef", 0.0)
        power_law = wdn * (gm1 / jnp.maximum(tgas, 1e-30)) ** 3.5
        sigma_a = wdn * ross * power_law
        sigma_p = wdn * pmr * power_law
        sigma_s = wdn * rad.kappa_s
    else:
        # gray opacities (constant kappa; per-cell sigma = rho * kappa)
        sigma_a = wdn * rad.kappa_a
        sigma_s = wdn * rad.kappa_s
        sigma_p = wdn * rad.kappa_p
    dtcsiga = dt_eff * sigma_a
    dtcsigs = dt_eff * sigma_s
    dtcsigp = dt_eff * sigma_p
    dtaucsiga = dtcsiga / u0
    dtaucsigs = dtcsigs / u0
    dtaucsigp = dtcsigp / u0

    # fluid velocity in the tetrad frame
    u_tet = [sum(jnp.asarray(n2t[a][nu])
                 * (gamma, wvx, wvy, wvz)[nu] for nu in range(4))
             for a in range(4)]
    u_tet = [ut[:, None] for ut in u_tet]

    n0c = n0  # [nmb, 1, ...] = n^0 (angle independent)
    # per-angle comoving n^0
    n0_cm = (u_tet[0] * nh_b[0] - u_tet[1] * nh_b[1]
             - u_tet[2] * nh_b[2] - u_tet[3] * nh_b[3])
    omega_cm = sang / (n0_cm * n0_cm)
    intensity_cm = FOUR_PI * (i0 / (n0c * n_0)) * n0_cm ** 4
    dts = (dtcsiga + dtcsigs)[:, None]
    vncsigma = 1.0 / (n0c + dts * n0_cm)
    vncsigma2 = n0_cm * vncsigma
    ir_weight = intensity_cm * omega_cm

    wght_sum = jnp.sum(omega_cm, axis=1)
    suma1 = jnp.sum(omega_cm * vncsigma2, axis=1) / wght_sum
    suma2 = jnp.sum(ir_weight * n0c * vncsigma, axis=1) / wght_sum
    suma3 = suma1 * (dtcsigs - dtcsigp)
    suma1 = suma1 * (dtcsiga + dtcsigp)

    coef1 = ((dtaucsiga + dtaucsigp)
             * (1.0 - suma1 / (1.0 - suma3))
             * rad.arad * gm1 / wdn)
    coef0 = -tgas - (dtaucsiga + dtaucsigp) * suma2 * gm1 \
        / (wdn * (1.0 - suma3))

    root, ok = fourth_poly_root(jnp.abs(coef1) + 1e-300, coef0)
    lin = jnp.abs(coef1) <= 1.0e-20
    tgasnew = jnp.where(lin, -coef0, jnp.where(ok, root, tgas))
    badcell = (~lin) & (~ok)

    emission = rad.arad * tgasnew ** 4
    jr_cm = (suma1 * emission + suma2) / (1.0 - suma3)

    di_cm = (((dtcsigs - dtcsigp)[:, None] * jr_cm[:, None]
              + (dtcsiga + dtcsigp)[:, None] * emission[:, None]
              - dts * intensity_cm) * vncsigma2)
    prim_new = i0 / (n0c * n_0) + di_cm / (FOUR_PI * n0_cm ** 4)
    i0_new = n0c * n_0 * jnp.maximum(prim_new, 0.0)
    # badcells keep the old intensity
    i0_new = jnp.where(badcell[:, None], i0, i0_new)

    if getattr(rad, "is_compton", False):
        # --- Compton scattering stage (reference:
        # radiation_source.cpp:290-377): a second implicit update against
        # the partially-updated gas temperature, exchanging energy
        # between gas and radiation at the thermal-Compton rate
        # 4 sigma_s (T_gas - T_rad) / T_electron until T_rad -> T_gas.
        inv_te = rad.inv_t_electron
        tgas_c = tgasnew            # partially updated gas temperature
        wght_cm = omega_cm / wght_sum[:, None]
        intensity_c = FOUR_PI * (i0_new / (n0c * n_0)) * n0_cm ** 4
        jr_cm_c = jnp.sum(intensity_c * wght_cm, axis=1)
        csuma1 = jnp.sum((n0_cm / n0c) * 4.0 * dtcsigs[:, None]
                         * inv_te * wght_cm, axis=1)
        csuma2 = 4.0 * dtaucsigs * inv_te * gm1 / wdn
        trad = jnp.sqrt(jnp.sqrt(jnp.maximum(jr_cm_c, 0.0) / rad.arad))
        # equilibrium deadband: the reference's absolute 1e-12 test
        # (radiation_source.cpp:314) widened to a relative band so the
        # quartic's cbrt cancellation noise cannot re-excite the cell
        eps_t = 8.0 * jnp.finfo(i0.dtype).eps
        temp_equil = jnp.abs(trad - tgas_c) < (
            1.0e-12 + eps_t * jnp.abs(tgas_c))
        denom1 = csuma1 * jr_cm_c
        ccoef4 = (1.0 + csuma2 * jr_cm_c) \
            / jnp.where(denom1 == 0.0, 1e-300, denom1) * rad.arad
        ccoef0 = -(1.0 + csuma2 * jr_cm_c) \
            / jnp.where(csuma1 == 0.0, 1e-300, csuma1) - tgas_c
        tradnew, cok = fourth_poly_root(ccoef4, ccoef0)
        apply_c = cok & jnp.isfinite(tradnew) & (~temp_equil) \
            & (denom1 > 0.0)
        tgasnew_c = (rad.arad * tradnew ** 4 - jr_cm_c) \
            / jnp.where(denom1 == 0.0, 1e-300, denom1) + tradnew
        # the exact implicit Compton step moves both temperatures
        # monotonically toward each other; bracketing the computed
        # roots to [min, max](trad, tgas) removes root-solve noise
        # (which otherwise runs away near equilibrium at f32) without
        # changing the converged physics
        t_lo = jnp.minimum(trad, tgas_c)
        t_hi = jnp.maximum(trad, tgas_c)
        tradnew = jnp.clip(tradnew, t_lo, t_hi)
        tgasnew_c = jnp.clip(tgasnew_c, t_lo, t_hi)
        di_cm_c = ((n0_cm / n0c) * dtcsigs[:, None] * 4.0
                   * jr_cm_c[:, None] * inv_te
                   * (tgasnew_c - tradnew)[:, None])
        prim_c = i0_new / (n0c * n_0) + di_cm_c / (FOUR_PI * n0_cm ** 4)
        i0_compton = n0c * n_0 * jnp.maximum(prim_c, 0.0)
        i0_new = jnp.where(apply_c[:, None], i0_compton, i0_new)

    if rad.excise_mask is not None:
        m = _local(rad.excise_mask)[:, None]
        i0_new = jnp.where(m, 0.0, i0_new)
        i0_new = jnp.where(jnp.abs(n_0) < rad.n_0_floor, 0.0, i0_new)

    if not affect_fluid:
        return i0_new, u

    # fluid feedback: moment differences (reference:
    # radiation_source.cpp:233-292)
    def mom(ii, comp):
        if comp == 0:
            return jnp.sum(ii * sang, axis=1)
        return jnp.sum(n_mu[comp] * ii / n_0 * sang, axis=1)

    dE = mom(i0, 0) - mom(i0_new, 0)
    dM1 = mom(i0, 1) - mom(i0_new, 1)
    dM2 = mom(i0, 2) - mom(i0_new, 2)
    dM3 = mom(i0, 3) - mom(i0_new, 3)
    u_new = u.at[:, IEN].add(dE)
    u_new = u_new.at[:, 1].add(dM1)
    u_new = u_new.at[:, 2].add(dM2)
    u_new = u_new.at[:, 3].add(dM3)
    return i0_new, u_new
