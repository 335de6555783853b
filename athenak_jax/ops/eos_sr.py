"""Special-relativistic ideal-gas EOS: c2p, p2c, and wave speeds.

Parity target: the SR branches of the reference EOS layer
(reference: src/eos/ideal_c2p_hyd.hpp:91-243, ideal_c2p_mhd.hpp SR parts,
eos.hpp:81-111).  Conventions:

  primitives  w = (rho, u^i, e)   u^i = gamma v^i spatial 4-velocity,
                                  e = internal energy density (fluid frame)
  conserved   u = (D, M_i, tau)   D = rho gamma, tau = E - D

The c2p is the Galeazzi et al. (2013) bracketed 1-D root find on
z = gamma*v (their eqs. C2-C26), run as a fixed 25-iteration vectorized
Illinois/false-position loop — the vectorized form of the reference's
per-cell early-exit iteration (fixed trip count, masked updates).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as _np

from ..indices import IDN, IEN, IM1, IM2, IM3, IVX, IVY, IVZ
from .eos import EOSData

_MAX_ITER = 25
_TOL = 1.0e-12
_VMAX = 0.9999999999995


def _tol_for(dtype):
    """Convergence tolerance matched to the working precision: the f64
    value mirrors the reference (ideal_c2p_mhd.hpp tol = 1e-12); at f32
    that is below machine eps (~1.2e-7), so the root find can converge
    to the last representable bit and still be branded a failure —
    production runs are f32, so scale to ~8 ULP instead."""
    return max(_TOL, float(_np.finfo(_np.dtype(dtype)).eps) * 8.0)


def sr_hydro_sound_speeds(eos: EOSData, d, p, ux, lor):
    """lambda_+/- for SR hydro (reference: eos.hpp:81-91, DZB eq. 73)."""
    cs2 = eos.gamma * p / (d + eos.gamma * p / (eos.gamma - 1.0))
    v2 = 1.0 - 1.0 / (lor * lor)
    p1 = (ux / lor) * (1.0 - cs2)
    tmp = jnp.sqrt(jnp.maximum(
        cs2 * ((1.0 - v2 * cs2) - p1 * (ux / lor)), 0.0)) / lor
    invden = 1.0 / (1.0 - v2 * cs2)
    return (p1 + tmp) * invden, (p1 - tmp) * invden


def sr_mhd_fast_speeds(eos: EOSData, d, p, ux, lor, b_sq):
    """Maximal fast magnetosonic speeds (reference: eos.hpp:97-111,
    DZB eq. 72/76)."""
    w = d + eos.gamma * p / (eos.gamma - 1.0)
    cs_sq = eos.gamma * p / w
    va_sq = b_sq / (b_sq + w)
    cms = cs_sq + va_sq - cs_sq * va_sq
    v2 = 1.0 - 1.0 / (lor * lor)
    p1 = (ux / lor) * (1.0 - cms)
    tmp = jnp.sqrt(jnp.maximum(
        cms * ((1.0 - v2 * cms) - p1 * (ux / lor)), 0.0)) / lor
    invden = 1.0 / (1.0 - v2 * cms)
    return (p1 + tmp) * invden, (p1 - tmp) * invden


def _eq_c22(z, ud, q, r, eos: EOSData):
    """Master function f(z) (reference: EquationC22,
    ideal_c2p_hyd.hpp:91-101)."""
    gm1 = eos.gamma - 1.0
    w = jnp.sqrt(1.0 + z * z)
    wd = ud / w
    eps = w * q - z * r + (z * z) / (1.0 + w)
    epsmin = jnp.maximum(eos.pfloor / (wd * gm1),
                         eos.sfloor * wd ** gm1 / gm1)
    eps = jnp.maximum(eps, epsmin)
    h = 1.0 + eos.gamma * eps
    return z - r / h


def cons_to_prim_sr_hydro(u, eos: EOSData):
    """Vectorized SR hydro c2p (reference: SingleC2P_IdealSRHyd,
    ideal_c2p_hyd.hpp:108-223).  Returns (w, u_fixed, counters)."""
    gm1 = eos.gamma - 1.0
    kmax = 2.0 * _VMAX / (1.0 + _VMAX * _VMAX)

    d = u[..., IDN, :, :, :]
    mx = u[..., IM1, :, :, :]
    my = u[..., IM2, :, :, :]
    mz = u[..., IM3, :, :, :]
    tau = u[..., IEN, :, :, :]

    dfloor_used = d < eos.dfloor
    d = jnp.maximum(d, eos.dfloor)
    efloor_used0 = tau < eos.pfloor / gm1
    tau = jnp.maximum(tau, eos.pfloor / gm1)

    s2 = mx * mx + my * my + mz * mz
    q = tau / d
    r = jnp.sqrt(s2) / d
    kk = jnp.minimum(kmax, r / (1.0 + q))

    zm = 0.5 * kk / jnp.sqrt(1.0 - 0.25 * kk * kk)
    zp = kk / jnp.sqrt(jnp.maximum(1.0 - kk * kk, 1.0e-30))
    fm = _eq_c22(zm, d, q, r, eos)
    fp = _eq_c22(zp, d, q, r, eos)

    # skip flag: bracket already within tolerance
    tol = _tol_for(zm.dtype)
    skip = (jnp.abs(zm - zp) < tol) | ((jnp.abs(fm) + jnp.abs(fp))
                                       < 2.0 * tol)
    z0 = 0.5 * (zm + zp)

    def body(_, carry):
        zm, zp, fm, fp, z, done = carry
        # the secant denominator guard must survive the working
        # precision (1e-300 flushes to zero in f32)
        znew = (zm * fp - zp * fm) / (fp - fm + _np.finfo(
            _np.dtype(zm.dtype)).tiny)
        f = _eq_c22(znew, d, q, r, eos)
        newly_done = (jnp.abs(zm - zp) < tol) | (jnp.abs(f) < tol)
        # Illinois update
        cond = f * fp < 0.0
        zm_n = jnp.where(cond, zp, zm)
        fm_n = jnp.where(cond, fp, 0.5 * fm)
        zp_n = znew
        fp_n = f
        # freeze converged lanes
        zm_n = jnp.where(done, zm, zm_n)
        zp_n = jnp.where(done, zp, zp_n)
        fm_n = jnp.where(done, fm, fm_n)
        fp_n = jnp.where(done, fp, fp_n)
        z_out = jnp.where(done, z, znew)
        return zm_n, zp_n, fm_n, fp_n, z_out, done | newly_done

    init = (zm, zp, fm, fp, z0, skip)
    zm, zp, fm, fp, z, done = jax.lax.fori_loop(0, _MAX_ITER, body, init)
    c2p_failure = ~done  # never converged within the fixed iteration budget

    lor = jnp.sqrt(1.0 + z * z)
    dens = jnp.maximum(d / lor, eos.dfloor)
    eps = lor * q - z * r + (z * z) / (1.0 + lor)
    epsmin = jnp.maximum(eos.pfloor / (dens * gm1),
                         eos.sfloor * dens ** gm1 / gm1)
    efloor_used = eps <= epsmin
    eps = jnp.maximum(eps, epsmin)
    h = 1.0 + eos.gamma * eps
    conv = 1.0 / h

    wd = jnp.where(c2p_failure, eos.dfloor, dens)
    we = jnp.where(c2p_failure, eos.pfloor / gm1, dens * eps)
    wvx = jnp.where(c2p_failure, 0.0, conv * (mx / d))
    wvy = jnp.where(c2p_failure, 0.0, conv * (my / d))
    wvz = jnp.where(c2p_failure, 0.0, conv * (mz / d))

    w = u.at[..., IDN, :, :, :].set(wd)
    w = w.at[..., IVX, :, :, :].set(wvx)
    w = w.at[..., IVY, :, :, :].set(wvy)
    w = w.at[..., IVZ, :, :, :].set(wvz)
    w = w.at[..., IEN, :, :, :].set(we)

    # scalars: concentration = (rho s gamma)/(rho gamma) = u_s / D
    nfluid = 5
    if u.shape[-4] > nfluid:
        s = u[..., nfluid:, :, :, :]
        w = w.at[..., nfluid:, :, :, :].set(s / d[..., None, :, :, :])

    # make conserved consistent where floors fired (reference resets u
    # from the floored prims on failure; we re-run p2c on failed lanes)
    u_fail = prim_to_cons_sr_hydro(w, eos)
    fail_b = (c2p_failure | dfloor_used | efloor_used0)[..., None, :, :, :]
    u_fixed = jnp.where(fail_b, u_fail, u)

    counters = {
        "neos_dfloor": jnp.sum(dfloor_used),
        "neos_efloor": jnp.sum(efloor_used | efloor_used0),
        "nc2p_fail": jnp.sum(c2p_failure),
    }
    return w, u_fixed, counters


def prim_to_cons_sr_hydro(w, eos: EOSData):
    """(reference: SingleP2C_IdealSRHyd, ideal_c2p_hyd.hpp:230-243)."""
    gam = eos.gamma
    d = w[..., IDN, :, :, :]
    ux = w[..., IVX, :, :, :]
    uy = w[..., IVY, :, :, :]
    uz = w[..., IVZ, :, :, :]
    e = w[..., IEN, :, :, :]
    u0 = jnp.sqrt(1.0 + ux * ux + uy * uy + uz * uz)
    wgas_u0 = (d + gam * e) * u0

    u = w.at[..., IDN, :, :, :].set(d * u0)
    u = u.at[..., IM1, :, :, :].set(wgas_u0 * ux)
    u = u.at[..., IM2, :, :, :].set(wgas_u0 * uy)
    u = u.at[..., IM3, :, :, :].set(wgas_u0 * uz)
    u = u.at[..., IEN, :, :, :].set(wgas_u0 * u0 - (gam - 1.0) * e - d * u0)

    nfluid = 5
    if w.shape[-4] > nfluid:
        s = w[..., nfluid:, :, :, :]
        u = u.at[..., nfluid:, :, :, :].set(
            s * (d * u0)[..., None, :, :, :])
    return u


# ------------------------------------------------------------------ SR MHD
def _eq49(mu, b2, rp, r):
    """Bracket function fa(mu) (reference: ideal_c2p_mhd.hpp:92-97,
    Kastaun et al. 2021 eq. 49)."""
    x = 1.0 / (1.0 + mu * b2)
    rbar = x * x * r * r + mu * x * (1.0 + x) * rp * rp
    return mu * jnp.sqrt(1.0 + rbar) - 1.0


def _eq44(mu, b2, rpar, r, q, ud, eos: EOSData):
    """Master function f(mu) (reference: ideal_c2p_mhd.hpp:104-119,
    Kastaun et al. 2021 eq. 44)."""
    gm1 = eos.gamma - 1.0
    x = 1.0 / (1.0 + mu * b2)
    rbar = x * x * r * r + mu * x * (1.0 + x) * rpar * rpar
    qbar = q - 0.5 * b2 - 0.5 * (mu * mu * (b2 * rbar - rpar * rpar))
    z2 = mu * mu * rbar / jnp.abs(1.0 - mu * mu * rbar)
    w = jnp.sqrt(1.0 + z2)
    wd = ud / w
    eps = w * (qbar - mu * rbar) + z2 / (w + 1.0)
    epsmin = jnp.maximum(eos.pfloor / (wd * gm1),
                         eos.sfloor * wd ** gm1 / gm1)
    eps = jnp.maximum(eps, epsmin)
    h = 1.0 + eos.gamma * eps
    return mu - 1.0 / (h / w + rbar * mu)


def _illinois(f, zm, zp, fm, fp):
    """Fixed-trip vectorized Illinois false-position solve of f(z)=0."""
    tol = _tol_for(zm.dtype)
    skip = (jnp.abs(zm - zp) < tol) | ((jnp.abs(fm) + jnp.abs(fp))
                                       < 2.0 * tol)
    z0 = 0.5 * (zm + zp)

    def body(_, carry):
        zm, zp, fm, fp, z, done = carry
        # the secant denominator guard must survive the working
        # precision (1e-300 flushes to zero in f32)
        znew = (zm * fp - zp * fm) / (fp - fm + _np.finfo(
            _np.dtype(zm.dtype)).tiny)
        fv = f(znew)
        newly = (jnp.abs(zm - zp) < tol) | (jnp.abs(fv) < tol)
        cond = fv * fp < 0.0
        zm_n = jnp.where(cond, zp, zm)
        fm_n = jnp.where(cond, fp, 0.5 * fm)
        zm_n = jnp.where(done, zm, zm_n)
        fm_n = jnp.where(done, fm, fm_n)
        zp_n = jnp.where(done, zp, znew)
        fp_n = jnp.where(done, fp, fv)
        z_out = jnp.where(done, z, znew)
        return zm_n, zp_n, fm_n, fp_n, z_out, done | newly

    init = (zm, zp, fm, fp, z0, skip)
    zm, zp, fm, fp, z, done = jax.lax.fori_loop(0, _MAX_ITER, body, init)
    return z, done


def cons_to_prim_sr_mhd(u, bcc, eos: EOSData):
    """Vectorized SR MHD c2p (reference: SingleC2P_IdealSRMHD,
    ideal_c2p_mhd.hpp:127-286; Kastaun, Kalinani & Ciolfi 2021).
    Two-stage bracketed root find on mu = 1/(h W)."""
    gm1 = eos.gamma - 1.0

    d = u[..., IDN, :, :, :]
    mx = u[..., IM1, :, :, :]
    my = u[..., IM2, :, :, :]
    mz = u[..., IM3, :, :, :]
    tau = u[..., IEN, :, :, :]
    bx = bcc[..., 0, :, :, :]
    by = bcc[..., 1, :, :, :]
    bz = bcc[..., 2, :, :, :]

    s2 = mx * mx + my * my + mz * mz
    b2_raw = bx * bx + by * by + bz * bz

    dfloor_eff = jnp.maximum(eos.dfloor, b2_raw / eos.sigma_max)
    dfloor_used = d < dfloor_eff
    d = jnp.maximum(d, dfloor_eff)
    efloor0 = tau < (eos.pfloor / gm1 + 0.5 * b2_raw)
    tau = jnp.maximum(tau, eos.pfloor / gm1 + 0.5 * b2_raw)

    rpar_raw = (bx * mx + by * my + bz * mz) / d

    # normalized variables (eqs. 22-24)
    q = tau / d
    r = jnp.sqrt(s2) / d
    isqrtd = 1.0 / jnp.sqrt(d)
    b2 = b2_raw / d
    rpar = rpar_raw * isqrtd

    # stage 1: upper bracket from fa(mu)=0 (eq. 49)
    zm = jnp.zeros_like(d)
    zp = jnp.ones_like(d)
    f49 = lambda z: _eq49(z, b2, rpar, r)  # noqa: E731
    mu_up, done1 = _illinois(f49, zm, zp, f49(zm), f49(zp))

    # stage 2: solve f(mu)=0 (eq. 44) in [0, mu_up]
    f44 = lambda z: _eq44(z, b2, rpar, r, q, d, eos)  # noqa: E731
    zm2 = jnp.zeros_like(d)
    mu, done2 = _illinois(f44, zm2, mu_up, f44(zm2), f44(mu_up))
    c2p_failure = ~(done1 & done2)

    x = 1.0 / (1.0 + mu * b2)
    rbar = x * x * r * r + mu * x * (1.0 + x) * rpar * rpar
    qbar = q - 0.5 * b2 - 0.5 * (mu * mu * (b2 * rbar - rpar * rpar))
    z2 = mu * mu * rbar / jnp.abs(1.0 - mu * mu * rbar)
    lor = jnp.sqrt(1.0 + z2)

    dens = jnp.maximum(d / lor, dfloor_eff)
    eps = lor * (qbar - mu * rbar) + z2 / (lor + 1.0)
    epsmin = jnp.maximum(eos.pfloor / (dens * gm1),
                         eos.sfloor * dens ** gm1 / gm1)
    efloor_used = eps <= epsmin
    eps = jnp.maximum(eps, epsmin)
    h = 1.0 + eos.gamma * eps
    conv = lor / (h * lor + b2)

    bxn, byn, bzn = bx * isqrtd, by * isqrtd, bz * isqrtd
    wd = jnp.where(c2p_failure, dfloor_eff, dens)
    we = jnp.where(c2p_failure, eos.pfloor / gm1, dens * eps)
    wvx = jnp.where(c2p_failure, 0.0,
                    conv * (mx / d + bxn * rpar / (h * lor)))
    wvy = jnp.where(c2p_failure, 0.0,
                    conv * (my / d + byn * rpar / (h * lor)))
    wvz = jnp.where(c2p_failure, 0.0,
                    conv * (mz / d + bzn * rpar / (h * lor)))

    w = u.at[..., IDN, :, :, :].set(wd)
    w = w.at[..., IVX, :, :, :].set(wvx)
    w = w.at[..., IVY, :, :, :].set(wvy)
    w = w.at[..., IVZ, :, :, :].set(wvz)
    w = w.at[..., IEN, :, :, :].set(we)

    nfluid = 5
    if u.shape[-4] > nfluid:
        s = u[..., nfluid:, :, :, :]
        w = w.at[..., nfluid:, :, :, :].set(s / d[..., None, :, :, :])

    u_fail = prim_to_cons_sr_mhd(w, bcc, eos)
    fail_b = (c2p_failure | dfloor_used | efloor0)[..., None, :, :, :]
    u_fixed = jnp.where(fail_b, u_fail, u)

    counters = {
        "neos_dfloor": jnp.sum(dfloor_used),
        "neos_efloor": jnp.sum(efloor_used | efloor0),
        "nc2p_fail": jnp.sum(c2p_failure),
    }
    return w, u_fixed, counters


def prim_to_cons_sr_mhd(w, bcc, eos: EOSData):
    """(reference: SingleP2C_IdealSRMHD, ideal_c2p_mhd.hpp:292-312)."""
    gam = eos.gamma
    d = w[..., IDN, :, :, :]
    ux = w[..., IVX, :, :, :]
    uy = w[..., IVY, :, :, :]
    uz = w[..., IVZ, :, :, :]
    e = w[..., IEN, :, :, :]
    bx = bcc[..., 0, :, :, :]
    by = bcc[..., 1, :, :, :]
    bz = bcc[..., 2, :, :, :]

    u0 = jnp.sqrt(1.0 + ux * ux + uy * uy + uz * uz)
    b0 = bx * ux + by * uy + bz * uz
    b1 = (bx + b0 * ux) / u0
    b2_ = (by + b0 * uy) / u0
    b3 = (bz + b0 * uz) / u0
    b_sq = -b0 * b0 + b1 * b1 + b2_ * b2_ + b3 * b3

    wtot_u02 = (d + gam * e + b_sq) * u0 * u0
    D = d * u0
    u = w.at[..., IDN, :, :, :].set(D)
    u = u.at[..., IM1, :, :, :].set(wtot_u02 * ux / u0 - b0 * b1)
    u = u.at[..., IM2, :, :, :].set(wtot_u02 * uy / u0 - b0 * b2_)
    u = u.at[..., IM3, :, :, :].set(wtot_u02 * uz / u0 - b0 * b3)
    u = u.at[..., IEN, :, :, :].set(
        wtot_u02 - b0 * b0 - ((gam - 1.0) * e + 0.5 * b_sq) - D)

    nfluid = 5
    if w.shape[-4] > nfluid:
        s = w[..., nfluid:, :, :, :]
        u = u.at[..., nfluid:, :, :, :].set(s * D[..., None, :, :, :])
    return u
