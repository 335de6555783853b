"""Vectorized relativistic primitive solver (Kastaun-style mu root).

A re-design of the reference ``PrimitiveSolver<EOSPolicy,
ErrorPolicy>`` (reference: src/eos/primitive-solver/primitive_solver.hpp):
the per-point Anderson-Bjorck false-position root solve becomes a
fixed-iteration masked update over whole arrays — every cell iterates in
lockstep, converged lanes simply stop moving (the same trick the SR/GR
c2p paths in ops/eos_sr.py use).  The error policy is the reference's
``ResetFloor`` (reset_floor.hpp): failed/atmosphere cells get floor
primitives and the conserved state is re-synced with prim_to_con.

All geometry is passed as 6-channel symmetric-metric arrays
[g_xx,g_xy,g_xz,g_yy,g_yz,g_zz] broadcastable against the field arrays.
Velocity primitive is Wv^i = u^i (the "utilde" the reference uses).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

SYM = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
_IDX = {(0, 0): 0, (0, 1): 1, (0, 2): 2, (1, 0): 1, (1, 1): 3,
        (1, 2): 4, (2, 0): 2, (2, 1): 4, (2, 2): 5}


def sym6(a, b):
    return _IDX[(a, b)]


def lower(v_u, g3d):
    return [sum(g3d[sym6(a, b)] * v_u[b] for b in range(3))
            for a in range(3)]


def raise_(v_d, g3u):
    return [sum(g3u[sym6(a, b)] * v_d[b] for b in range(3))
            for a in range(3)]


def contract(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def spatial_det(g3d):
    gxx, gxy, gxz, gyy, gyz, gzz = g3d
    return (gxx * (gyy * gzz - gyz * gyz)
            - gxy * (gxy * gzz - gyz * gxz)
            + gxz * (gxy * gyz - gyy * gxz))


def spatial_inv(g3d, detg=None):
    gxx, gxy, gxz, gyy, gyz, gzz = g3d
    if detg is None:
        detg = spatial_det(g3d)
    i = 1.0 / detg
    return [(gyy * gzz - gyz * gyz) * i,
            (gxz * gyz - gxy * gzz) * i,
            (gxy * gyz - gyy * gxz) * i,
            (gxx * gzz - gxz * gxz) * i,
            (gxy * gxz - gxx * gyz) * i,
            (gxx * gyy - gxy * gxy) * i]


class PrimitiveSolverPS:
    """ConToPrim/PrimToCon on undensitized ADM-slice variables."""

    def __init__(self, policy, dfloor: float = 1e-12,
                 tfloor: float = 0.0, pfloor: Optional[float] = None,
                 v_max: float = 0.9999, threshold: float = 1.0,
                 n_newton: int = 20, n_falsepos: int = 30,
                 n_bisect: int = 30) -> None:
        self.eos = policy
        self.mb = policy.mb
        self.n_atm = dfloor / policy.mb
        self.threshold = threshold
        # temperature floor: from pfloor if given (ideal-like), else tfloor
        if pfloor is not None and tfloor == 0.0:
            self.t_atm_from_p = pfloor
        else:
            self.t_atm_from_p = None
        self.t_atm = tfloor
        self.v_max = v_max
        self.n_newton = n_newton
        self.n_falsepos = n_falsepos
        self.n_bisect = n_bisect

    @classmethod
    def from_input(cls, policy, pin, block: str) -> "PrimitiveSolverPS":
        return cls(policy,
                   dfloor=pin.get_or_add_real(block, "dfloor", 1e-12),
                   tfloor=pin.get_or_add_real(block, "tfloor", 0.0),
                   pfloor=pin.get_or_add_real(block, "pfloor", 1e-15),
                   v_max=pin.get_or_add_real(block, "dyn_vmax", 0.9999),
                   threshold=pin.get_or_add_real(
                       block, "dthreshold", 1.0))

    # ------------------------------------------------------------------
    def _atm_T(self, n):
        if self.t_atm_from_p is not None:
            return self.eos.temperature_from_p(
                jnp.maximum(n, self.n_atm), self.t_atm_from_p
                * jnp.ones_like(n))
        return jnp.full_like(n, self.t_atm)

    # ------------------------------------------------------------------
    def prim_to_con(self, n, Wv_u, P, T, B_u, g3d):
        """(reference: primitive_solver.hpp PrimToCon :553-616).
        Returns (D, S_d[3], tau) — undensitized."""
        eos = self.eos
        Wv_d = lower(Wv_u, g3d)
        Wvsq = contract(Wv_u, Wv_d)
        Wsq = 1.0 + Wvsq
        W = jnp.sqrt(Wsq)
        iW = 1.0 / W
        v_d = [Wv_d[a] * iW for a in range(3)]
        B_d = lower(B_u, g3d)
        Bsq = contract(B_u, B_d)
        Bv = contract(B_u, v_d)
        H = n * eos.enthalpy(n, T) * 1.0  # enthalpy density (mb inside)
        HWsq = H * Wsq
        D = n * self.mb * W
        HWsqpb = HWsq + Bsq
        S_d = [HWsqpb * v_d[a] - Bv * B_d[a] for a in range(3)]
        tau = HWsqpb - P - 0.5 * (Bv * Bv + Bsq * iW * iW) - D
        return D, S_d, tau

    # ------------------------------------------------------------------
    def _root_f(self, mu, D, q, bsq, rsq, rbsq, Y):
        """RootFunctor (reference: primitive_solver.hpp:87-165):
        f(mu) = mu - muhat and the (n, T, P) estimates at mu."""
        eos = self.eos
        x = 1.0 / (1.0 + mu * bsq)
        musq = mu * mu
        rbarsq = x * (rsq * x + mu * (x + 1.0) * rbsq)
        qbar = q - 0.5 * bsq - 0.5 * musq * x * x * (bsq * rsq - rbsq)
        h_min = eos.min_enthalpy()
        vsq_max = jnp.minimum(rsq / (h_min * h_min + rsq),
                              self.v_max * self.v_max)
        vhatsq = jnp.minimum(musq * rbarsq, vsq_max)
        iWhat = jnp.sqrt(jnp.maximum(1.0 - vhatsq, 1e-30))
        nhat = jnp.clip(D * iWhat / self.mb, eos.min_n, eos.max_n)
        eoverD = qbar - mu * rbarsq + 1.0
        ehat = D * eoverD
        That = eos.temperature_from_e(nhat, ehat, Y)
        That = jnp.clip(That, eos.min_T, eos.max_T)
        ehat = eos.energy(nhat, That, Y)
        Phat = eos.pressure(nhat, That, Y)
        hhat = (ehat + Phat) / (self.mb * nhat)
        nu_a = hhat * iWhat
        nu_b = (D * eoverD + Phat) / D
        nuhat = jnp.maximum(nu_a, nu_b)
        muhat = 1.0 / (nuhat + mu * rbarsq)
        return mu - muhat, nhat, That, Phat

    def _upper_f(self, mu, bsq, rsq, rbsq, h_min):
        """UpperRootFunctor (reference: primitive_solver.hpp:35-62)."""
        x = 1.0 / (1.0 + mu * bsq)
        xsq = x * x
        rbarsq = rsq * xsq + mu * x * (1.0 + x) * rbsq
        dis = jnp.sqrt(h_min * h_min + rbarsq)
        dx = -bsq * xsq
        drbarsq = rbsq * xsq + mu * rbsq * dx \
            + x * (rbsq + 2.0 * (mu * rbsq + rsq) * dx)
        f = mu * dis - 1.0
        df = dis + mu * drbarsq / (2.0 * dis)
        return f, df

    # ------------------------------------------------------------------
    def con_to_prim(self, D, S_d, tau, B_u, g3d, g3u, Y=None):
        """(reference: primitive_solver.hpp ConToPrim :331-550).

        Returns dict(n, Wv_u, P, T, D, S_d, tau, natm_mask, nfail)
        with the conserved variables re-synced where floors fired."""
        eos = self.eos
        mb = self.mb

        d_atm = mb * self.n_atm
        atm = D <= d_atm * self.threshold
        Ds = jnp.maximum(D, d_atm)

        sqrtD = jnp.sqrt(Ds)
        b_u = [B_u[a] / sqrtD for a in range(3)]
        r_d = [S_d[a] / Ds for a in range(3)]
        r_u = raise_(r_d, g3u)
        rsq = jnp.maximum(contract(r_u, r_d), 0.0)
        rb = contract(b_u, r_d)
        rbsq = rb * rb
        b_d = lower(b_u, g3d)
        bsq = jnp.maximum(contract(b_u, b_d), 0.0)
        q = tau / Ds

        h_min = eos.min_enthalpy()
        # ---- tighter upper bound where rsq > h_min^2 (masked NewtonSafe)
        # (lax loops keep the traced graph small: the unrolled version
        # nests the policy's own inversion loops and explodes compile
        # times for tabulated EOS policies)
        import jax as _jax

        def _newton_body(_, carry):
            lo, hi, mu = carry
            f, df = self._upper_f(mu, bsq, rsq, rbsq, h_min)
            lo = jnp.where(f < 0.0, mu, lo)
            hi = jnp.where(f >= 0.0, mu, hi)
            step = mu - f / jnp.where(jnp.abs(df) > 1e-30, df, 1.0)
            inside = (step > lo) & (step < hi)
            return lo, hi, jnp.where(inside, step, 0.5 * (lo + hi))

        lo = jnp.zeros_like(Ds)
        hi = jnp.full_like(Ds, 1.0 / h_min)
        _, _, mu = _jax.lax.fori_loop(
            0, self.n_newton, _newton_body, (lo, hi, 0.5 * (lo + hi)))
        muh = jnp.where(rsq > h_min * h_min,
                        mu * (1.0 + 1e-10), 1.0 / h_min)

        # ---- Anderson-Bjorck false position for f(mu) = mu - muhat
        a = jnp.zeros_like(Ds)
        b = muh
        fa, _, _, _ = self._root_f(a, Ds, q, bsq, rsq, rbsq, Y)
        fb, _, _, _ = self._root_f(b, Ds, q, bsq, rsq, rbsq, Y)
        # f(0) < 0 always.  fb < 0 means the root sits above the tight
        # upper bound (near-cold states where h -> h_min make root and
        # bound nearly coincide, reference: primitive_solver.hpp:471-476);
        # widen back to the universal bound 1/h_min and re-evaluate.
        wide = jnp.full_like(Ds, 1.0 / h_min)
        f_wide, _, _, _ = self._root_f(wide, Ds, q, bsq, rsq, rbsq, Y)
        b = jnp.where(fb <= 0.0, wide, b)
        fb = jnp.where(fb <= 0.0, f_wide, fb)
        # truly degenerate: root numerically AT the bound
        collided = fb <= 0.0
        # bracket invariant: f(a) <= 0 <= f(b) (f(0) = -muhat < 0 and the
        # bound setup guarantees f(b) >= 0); updates test the SIGN of fx
        # directly — a product test like fx*fa >= 0 degenerates to
        # always-true once fa underflows to exactly 0 at convergence and
        # then walks the bracket off the root
        def _fp_body(_, carry):
            a, b, fa, fb, side = carry
            denom = jnp.where(jnp.abs(fb - fa) > 1e-30, fb - fa, 1.0)
            x = (fb * a - fa * b) / denom
            fx, _, _, _ = self._root_f(x, Ds, q, bsq, rsq, rbsq, Y)
            low_side = fx <= 0.0
            # Anderson-Bjorck weighting on same-side repeats
            m_hi = 1.0 - fx / jnp.where(jnp.abs(fa) > 1e-30, fa, 1.0)
            m_hi = jnp.where(m_hi > 0.0, m_hi, 0.5)
            m_lo = 1.0 - fx / jnp.where(jnp.abs(fb) > 1e-30, fb, 1.0)
            m_lo = jnp.where(m_lo > 0.0, m_lo, 0.5)
            fb_new = jnp.where(low_side & (side == 1.0), fb * m_hi, fb)
            fa_new = jnp.where(~low_side & (side == -1.0), fa * m_lo, fa)
            a = jnp.where(low_side, x, a)
            fa = jnp.where(low_side, fx, fa_new)
            b = jnp.where(low_side, b, x)
            fb = jnp.where(low_side, fb_new, fx)
            return a, b, fa, fb, jnp.where(low_side, 1.0, -1.0)

        side = jnp.zeros_like(Ds)  # +1: last test matched lower, -1: upper
        a, b, fa, fb, side = _jax.lax.fori_loop(
            0, self.n_falsepos, _fp_body, (a, b, fa, fb, side))

        # bisection polish: Anderson-Bjorck can stall on derivative kinks
        # (piecewise-polytrope piece boundaries); bisection guarantees the
        # bracket keeps halving
        def _bi_body(_, carry):
            a, b, fa, fb = carry
            mid = 0.5 * (a + b)
            fm, _, _, _ = self._root_f(mid, Ds, q, bsq, rsq, rbsq, Y)
            low_side = fm <= 0.0
            a = jnp.where(low_side, mid, a)
            fa = jnp.where(low_side, fm, fa)
            b = jnp.where(low_side, b, mid)
            fb = jnp.where(low_side, fb, fm)
            return a, b, fa, fb

        a, b, fa, fb = _jax.lax.fori_loop(
            0, self.n_bisect, _bi_body, (a, b, fa, fb))
        # prefer the exactly-converged endpoint over the bracket midpoint
        x = jnp.where(fa == 0.0, a, jnp.where(fb == 0.0, b,
                                              0.5 * (a + b)))

        mu_root = jnp.where(collided, b, x)
        _, n, T, P = self._root_f(mu_root, Ds, q, bsq, rsq, rbsq, Y)

        # ---- primitives
        rho = n * mb
        W = Ds / rho
        Wmux = W * mu_root / (1.0 + mu_root * bsq)
        rbmu = rb * mu_root
        Wv_u = [Wmux * (r_u[a] + rbmu * b_u[a]) for a in range(3)]

        # ---- ResetFloor error policy (reference: reset_floor.hpp):
        # atmosphere where the solve failed or n fell below the floor
        bad = atm | ~jnp.isfinite(mu_root) \
            | (n < self.n_atm * self.threshold)
        n_out = jnp.where(bad, self.n_atm, n)
        T_atm = self._atm_T(n_out)
        T_out = jnp.where(bad, T_atm, jnp.maximum(T, eos.min_T))
        P_out = jnp.where(bad, eos.pressure(n_out, T_out, Y),
                          jnp.maximum(P, 0.0))
        Wv_out = [jnp.where(bad, 0.0, Wv_u[a]) for a in range(3)]

        # re-sync conserved state wherever anything fired
        Dn, S_dn, taun = self.prim_to_con(n_out, Wv_out, P_out, T_out,
                                          B_u, g3d)
        resync = bad
        D_out = jnp.where(resync, Dn, D)
        S_out = [jnp.where(resync, S_dn[a], S_d[a]) for a in range(3)]
        tau_out = jnp.where(resync, taun, tau)

        return {"n": n_out, "Wv_u": Wv_out, "P": P_out, "T": T_out,
                "D": D_out, "S_d": S_out, "tau": tau_out,
                "nfloor": jnp.sum(bad),
                "nfail": jnp.sum(bad & ~atm)}
