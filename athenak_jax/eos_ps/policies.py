"""EOS policies for the primitive-solver framework (dynamical GR).

A re-design of the reference's policy classes
(reference: src/eos/primitive-solver/{idealgas,piecewise_polytrope,
eos_compose,eos_hybrid}.hpp): every method is VECTORIZED over whole
arrays of (n, T) — number density and temperature — instead of the
reference's per-point inline calls, so one policy call becomes one fused
XLA elementwise region (or a gather for tabulated policies).

Thermodynamic convention (identical to the reference, ps_types.hpp):
  n : baryon number density          rho = mb * n
  T : temperature
  e : total energy density (includes rest mass)
  P : pressure
  h : enthalpy per baryon  (= (e + P)/n)
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

_BIG = 1.0e308


# --------------------------------------------------------------------- logs
class NormalLogs:
    """Exact log2/exp2 (reference: logs.hpp NormalLogs)."""

    def log2(self, x):
        return jnp.log2(x)

    def exp2(self, x):
        return jnp.exp2(x)


class NQTLogs:
    """'Not-quite-transcendental' first-order bit-hack log2/exp2
    (reference: logs.hpp:68 NQTLogs::log2_LANL/exp2_LANL).  Exact at
    powers of two, linear in the mantissa between — monotone and
    invertible, which is all a log-spaced table lookup needs."""

    def log2(self, x):
        x = jnp.asarray(x)
        if x.dtype == jnp.float64:
            one_as_int = np.int64(4607182418800017408)
            scale_down = 2.22044604925031e-16
            bits = jnp.asarray(x).view(jnp.int64)
            return (bits - one_as_int).astype(jnp.float64) * scale_down
        one_as_int = np.int32(1065353216)
        bits = jnp.asarray(x, jnp.float32).view(jnp.int32)
        return (bits - one_as_int).astype(jnp.float32) * np.float32(
            1.0 / 8388608.0)

    def exp2(self, x):
        x = jnp.asarray(x)
        if x.dtype == jnp.float64:
            one_as_int = np.int64(4607182418800017408)
            scale_up = 4503599627370496.0
            bits = (x * scale_up).astype(jnp.int64) + one_as_int
            return bits.view(jnp.float64)
        one_as_int = np.int32(1065353216)
        bits = (jnp.asarray(x, jnp.float32)
                * np.float32(8388608.0)).astype(jnp.int32) + one_as_int
        return bits.view(jnp.float32)


# ------------------------------------------------------------------- ideal
class IdealGasPS:
    """Ideal-gas policy (reference: idealgas.hpp)."""

    name = "ideal"

    def __init__(self, gamma: float = 5.0 / 3.0, mb: float = 1.0) -> None:
        self.gamma = min(max(gamma, 1.00001), 2.00001)
        self.gm1 = self.gamma - 1.0
        self.mb = mb
        self.min_n = 0.0
        self.max_n = _BIG
        self.min_T = 0.0
        self.max_T = _BIG

    @classmethod
    def from_input(cls, pin, block: str) -> "IdealGasPS":
        return cls(gamma=pin.get_or_add_real(block, "gamma", 5.0 / 3.0),
                   mb=pin.get_or_add_real(block, "mb", 1.0))

    def temperature_from_e(self, n, e, Y=None):
        return self.gm1 * (e - self.mb * n) / n

    def temperature_from_p(self, n, p, Y=None):
        return p / n

    def energy(self, n, T, Y=None):
        return n * (self.mb + T / self.gm1)

    def pressure(self, n, T, Y=None):
        return n * T

    def enthalpy(self, n, T, Y=None):
        return self.mb + self.gamma / self.gm1 * T

    def min_enthalpy(self) -> float:
        return self.mb

    def sound_speed(self, n, T, Y=None):
        return jnp.sqrt(self.gamma * self.gm1 * T
                        / (self.gm1 * self.mb + self.gamma * T))


# --------------------------------------------------------------- piecewise
class PiecewisePolytropePS:
    """Piecewise-polytropic cold EOS + ideal thermal part
    (reference: piecewise_polytrope.{hpp,cpp}).

    Pieces stored exactly like the reference InitializeFromData
    (piecewise_polytrope.hpp:170-230): density_pieces[0] repeats the
    first dividing density so P0 anchors the first segment; eps_pieces
    accumulate the energy-continuity constants.
    """

    name = "piecewise_poly"

    def __init__(self, densities, gammas, P0: float,
                 mb: float = 1.0, gamma_thermal: float = 5.0 / 3.0) -> None:
        n = len(gammas)
        if len(densities) != n or n < 2:
            raise ValueError("piecewise polytrope needs n>=2 pieces with "
                             "matching density list (first = rho_min)")
        dens = np.asarray(densities, dtype=np.float64)
        if np.any(np.diff(dens) <= 0.0):
            raise ValueError("dividing densities must be increasing")
        self.mb = mb
        self.gamma_th = gamma_thermal
        d = np.empty(n)
        g = np.asarray(gammas, dtype=np.float64)
        p = np.empty(n)
        eps = np.empty(n)
        d[0] = dens[1] / mb
        p[0] = P0
        eps[0] = 0.0
        for i in range(1, n):
            d[i] = dens[i] / mb
            p[i] = p[i - 1] * (d[i] / d[i - 1]) ** g[i - 1]
            # energy continuity at the dividing density d[i]: the
            # correction uses P and rho AT the boundary
            eps[i] = eps[i - 1] + p[i] / (d[i] * mb) * (
                1.0 / (g[i - 1] - 1.0) - 1.0 / (g[i] - 1.0))
        self.density_pieces = d
        self.gamma_pieces = g
        self.pressure_pieces = p
        self.eps_pieces = eps
        self.n_pieces = n
        self.min_n = 0.0
        self.max_n = _BIG
        self.min_T = 0.0
        self.max_T = _BIG

    @classmethod
    def from_input(cls, pin, block: str) -> "PiecewisePolytropePS":
        n = pin.get_integer(block, "npieces")
        dens = [pin.get_real(block, "rho_min")] + [
            pin.get_real(block, f"density{i}") for i in range(1, n)]
        gammas = [pin.get_real(block, f"gamma{i}") for i in range(1, n + 1)]
        return cls(dens, gammas, pin.get_real(block, "P0"),
                   mb=pin.get_or_add_real(block, "mb", 1.0),
                   gamma_thermal=pin.get_or_add_real(
                       block, "gamma_thermal", 5.0 / 3.0))

    # -- piece lookup (vectorized FindPiece, reference :260-268)
    def _piece(self, n):
        thresholds = jnp.asarray(self.density_pieces[1:])
        return jnp.searchsorted(thresholds, n, side="right")

    def _gather(self, table, idx):
        return jnp.take(jnp.asarray(table), idx)

    def _cold_p(self, n, idx):
        dp = self._gather(self.density_pieces, idx)
        gp = self._gather(self.gamma_pieces, idx)
        pp = self._gather(self.pressure_pieces, idx)
        return pp * (n / dp) ** gp

    def _cold_e(self, n, idx):
        ep = self._gather(self.eps_pieces, idx)
        gp = self._gather(self.gamma_pieces, idx)
        return self.mb * n * (1.0 + ep) + self._cold_p(n, idx) / (gp - 1.0)

    def temperature_from_e(self, n, e, Y=None):
        idx = self._piece(n)
        return (e - self._cold_e(n, idx)) * (self.gamma_th - 1.0) / n

    def temperature_from_p(self, n, p, Y=None):
        idx = self._piece(n)
        return (p - self._cold_p(n, idx)) / n

    def energy(self, n, T, Y=None):
        idx = self._piece(n)
        return self._cold_e(n, idx) + n * T / (self.gamma_th - 1.0)

    def pressure(self, n, T, Y=None):
        idx = self._piece(n)
        return self._cold_p(n, idx) + n * T

    def enthalpy(self, n, T, Y=None):
        idx = self._piece(n)
        return (self._cold_e(n, idx) + self._cold_p(n, idx)) / n \
            + self.gamma_th / (self.gamma_th - 1.0) * T

    def min_enthalpy(self) -> float:
        return self.mb

    def sound_speed(self, n, T, Y=None):
        idx = self._piece(n)
        rho = n * self.mb
        e_c = self._cold_e(n, idx)
        p_c = self._cold_p(n, idx)
        gp = self._gather(self.gamma_pieces, idx)
        h_cold = (e_c + p_c) / rho
        h_th = self.gamma_th / (self.gamma_th - 1.0) * T / self.mb
        csq_cold_w = gp * p_c / rho
        csq_th_w = (self.gamma_th - 1.0) * h_th
        return jnp.sqrt((csq_cold_w + csq_th_w) / (h_th + h_cold))

    # -- cold inverse, used by the TOV solver
    def cold_pressure_np(self, rho):
        """Host/numpy cold P(rho) for initial-data integrators."""
        n = np.asarray(rho, dtype=np.float64) / self.mb
        idx = np.searchsorted(self.density_pieces[1:], n, side="right")
        dp = self.density_pieces[idx]
        gp = self.gamma_pieces[idx]
        pp = self.pressure_pieces[idx]
        return pp * (n / dp) ** gp

    def cold_energy_np(self, rho):
        n = np.asarray(rho, dtype=np.float64) / self.mb
        idx = np.searchsorted(self.density_pieces[1:], n, side="right")
        gp = self.gamma_pieces[idx]
        ep = self.eps_pieces[idx]
        return self.mb * n * (1.0 + ep) \
            + self.cold_pressure_np(rho) / (gp - 1.0)

    def cold_rho_from_p_np(self, p):
        p = np.asarray(p, dtype=np.float64)
        idx = np.searchsorted(self.pressure_pieces[1:], p, side="right")
        dp = self.density_pieces[idx]
        gp = self.gamma_pieces[idx]
        pp = self.pressure_pieces[idx]
        return np.maximum(dp * (p / pp) ** (1.0 / gp), 0.0) * self.mb


# ----------------------------------------------------------------- compose
class CompOSEPS:
    """Tabulated 3-parameter EOS: trilinear interpolation in
    (log n, log T, Ye) of log P, log e, cs^2 — the reference's EOSCompOSE
    (reference: eos_compose.{hpp,cpp}), with either exact or NQT fast
    logs (reference: logs.hpp:68).

    Tables are regular in (log2 n, log2 T, Ye).  ``from_function`` builds
    a synthetic table from any analytic policy — used by the unit tests,
    mirroring the reference's ut_compose pgen — and ``from_npz`` loads a
    dumped table.
    """

    name = "compose"

    def __init__(self, log2_n, log2_T, ye, log2_P, log2_e, csq,
                 mb: float = 1.0, use_nqt: bool = False) -> None:
        self.mb = mb
        self.logs = NQTLogs() if use_nqt else NormalLogs()
        self.ln = np.asarray(log2_n, dtype=np.float64)
        self.lt = np.asarray(log2_T, dtype=np.float64)
        self.ye = np.asarray(ye, dtype=np.float64)
        # tables indexed [iy, it, in_]
        self.tab_lp = np.asarray(log2_P, dtype=np.float64)
        self.tab_le = np.asarray(log2_e, dtype=np.float64)
        self.tab_cs = np.asarray(csq, dtype=np.float64)
        self.min_n = float(2.0 ** self.ln[0])
        self.max_n = float(2.0 ** self.ln[-1])
        self.min_T = float(2.0 ** self.lt[0])
        self.max_T = float(2.0 ** self.lt[-1])
        self._min_h = None

    # -- constructors ---------------------------------------------------
    @classmethod
    def from_function(cls, policy, n_lo, n_hi, T_lo, T_hi,
                      nn=64, nt=64, ny=3, use_nqt=False):
        """Sample an analytic policy onto a regular (log n, log T, Ye)
        grid (the unit-test path; reference: pgen/unit_tests/eos_compose)."""
        ln = np.linspace(np.log2(n_lo), np.log2(n_hi), nn)
        lt = np.linspace(np.log2(T_lo), np.log2(T_hi), nt)
        ye = np.linspace(0.0, 0.5, ny)
        n = 2.0 ** ln[None, None, :]
        T = 2.0 ** lt[None, :, None]
        nb = np.broadcast_to(n, (ny, nt, nn))
        Tb = np.broadcast_to(T, (ny, nt, nn))
        P = np.asarray(policy.pressure(jnp.asarray(nb), jnp.asarray(Tb)))
        e = np.asarray(policy.energy(jnp.asarray(nb), jnp.asarray(Tb)))
        cs = np.asarray(policy.sound_speed(jnp.asarray(nb),
                                           jnp.asarray(Tb)))
        return cls(ln, lt, ye, np.log2(P), np.log2(e), cs ** 2,
                   mb=policy.mb, use_nqt=use_nqt)

    @classmethod
    def from_npz(cls, fname, use_nqt=False):
        d = np.load(fname)
        return cls(d["log2_n"], d["log2_T"], d["ye"], d["log2_P"],
                   d["log2_e"], d["csq"], mb=float(d["mb"]),
                   use_nqt=use_nqt)

    @classmethod
    def from_input(cls, pin, block: str):
        fname = pin.get_string(block, "eos_file")
        use_nqt = pin.get_or_add_boolean(block, "use_nqt", False)
        return cls.from_npz(fname, use_nqt=use_nqt)

    # -- interpolation core ----------------------------------------------
    def _weights(self, grid, x):
        dx = grid[1] - grid[0]
        f = (x - grid[0]) / dx
        i0 = jnp.clip(jnp.floor(f).astype(jnp.int32), 0, len(grid) - 2)
        w = jnp.clip(f - i0, 0.0, 1.0)
        return i0, w

    def _interp(self, table, n, T, Y):
        ln = self.logs.log2(n)
        lt = self.logs.log2(T)
        yv = jnp.zeros_like(n) if Y is None else Y
        i_n, w_n = self._weights(jnp.asarray(self.ln), ln)
        i_t, w_t = self._weights(jnp.asarray(self.lt), lt)
        i_y, w_y = self._weights(jnp.asarray(self.ye), yv)
        tab = jnp.asarray(table)
        nn = tab.shape[2]
        nt = tab.shape[1]
        flat = tab.reshape(-1)

        def at(dy, dt, dn):
            idx = ((i_y + dy) * nt + (i_t + dt)) * nn + (i_n + dn)
            return jnp.take(flat, idx)

        out = 0.0
        for dy, wy in ((0, 1.0 - w_y), (1, w_y)):
            for dt, wt in ((0, 1.0 - w_t), (1, w_t)):
                for dn, wn in ((0, 1.0 - w_n), (1, w_n)):
                    out = out + wy * wt * wn * at(dy, dt, dn)
        return out

    def _clip_nT(self, n, T):
        return (jnp.clip(n, self.min_n, self.max_n),
                jnp.clip(T, self.min_T, self.max_T))

    # -- thermodynamics ----------------------------------------------------
    def pressure(self, n, T, Y=None):
        n, T = self._clip_nT(n, T)
        return self.logs.exp2(self._interp(self.tab_lp, n, T, Y))

    def energy(self, n, T, Y=None):
        n, T = self._clip_nT(n, T)
        return self.logs.exp2(self._interp(self.tab_le, n, T, Y))

    def sound_speed(self, n, T, Y=None):
        n, T = self._clip_nT(n, T)
        return jnp.sqrt(jnp.clip(self._interp(self.tab_cs, n, T, Y),
                                 0.0, 1.0 - 1e-12))

    def enthalpy(self, n, T, Y=None):
        return (self.energy(n, T, Y) + self.pressure(n, T, Y)) / n

    def min_enthalpy(self) -> float:
        """Minimum enthalpy over the table (reference caches the same
        scan, eos_compose.cpp min_h computation)."""
        if self._min_h is None:
            n = 2.0 ** self.ln
            e = 2.0 ** self.tab_le
            p = 2.0 ** self.tab_lp
            h = (e + p) / n[None, None, :]
            self._min_h = float(h.min())
        return self._min_h

    # -- inversions: fixed-iteration bisection on the monotone T axis
    def _invert(self, table, n, target_log, Y, iters=40):
        import jax as _jax

        def body(_, carry):
            lt_lo, lt_hi = carry
            lt_mid = 0.5 * (lt_lo + lt_hi)
            val = self._interp(table, n, self.logs.exp2(lt_mid), Y)
            hi = val > target_log
            return (jnp.where(hi, lt_lo, lt_mid),
                    jnp.where(hi, lt_mid, lt_hi))

        lt_lo = jnp.full_like(n, self.lt[0])
        lt_hi = jnp.full_like(n, self.lt[-1])
        lt_lo, lt_hi = _jax.lax.fori_loop(0, iters, body, (lt_lo, lt_hi))
        return self.logs.exp2(0.5 * (lt_lo + lt_hi))

    def temperature_from_e(self, n, e, Y=None):
        n = jnp.clip(n, self.min_n, self.max_n)
        return self._invert(self.tab_le, n,
                            self.logs.log2(jnp.maximum(e, 1e-300)), Y)

    def temperature_from_p(self, n, p, Y=None):
        n = jnp.clip(n, self.min_n, self.max_n)
        return self._invert(self.tab_lp, n,
                            self.logs.log2(jnp.maximum(p, 1e-300)), Y)


# ------------------------------------------------------------------ hybrid
class HybridPS:
    """Cold 1D tabulated EOS (CompOSE-style, uniform in log2 n) plus a
    thermal Gamma-law component (reference: eos_hybrid.hpp).

    P(n,T) = P_cold(n) + n T,   e(n,T) = e_cold(n) + n T / (G_th - 1),
    cs^2   = (H_cold cs_cold^2 + G_th T) / (H_cold + G_th T/(G_th - 1))
    with the cold curves linearly interpolated in log2 n
    (reference: eos_hybrid.hpp eval_at_ln / SoundSpeed).
    """

    name = "hybrid"

    def __init__(self, log2_n, log2_P, log2_e, cs, mb: float = 1.0,
                 gamma_thermal: float = 5.0 / 3.0,
                 use_nqt: bool = False) -> None:
        self.mb = mb
        self.logs = NQTLogs() if use_nqt else NormalLogs()
        g = min(max(gamma_thermal, 1.00001), 2.0)  # reference clamp
        self.gamma_th = g
        self.gth_m1 = g - 1.0
        self.ln = np.asarray(log2_n, dtype=np.float64)
        self.tab_lp = np.asarray(log2_P, dtype=np.float64)
        self.tab_le = np.asarray(log2_e, dtype=np.float64)
        self.tab_cs = np.asarray(cs, dtype=np.float64)
        self.min_n = float(2.0 ** self.ln[0])
        self.max_n = float(2.0 ** self.ln[-1])
        self.min_T = 0.0
        self.max_T = _BIG
        # minimum enthalpy over the cold table (reference caches m_min_h
        # on table read)
        nvals = 2.0 ** self.ln
        h = (2.0 ** self.tab_le + 2.0 ** self.tab_lp) / nvals
        self._min_h = float(h.min())

    @classmethod
    def from_cold_policy(cls, policy, n_lo, n_hi, nn=256,
                         gamma_thermal=5.0 / 3.0, use_nqt=False):
        """Sample another policy's T=0 curves onto a log2-n grid (the
        unit-test path, mirroring CompOSEPS.from_function)."""
        ln = np.linspace(np.log2(n_lo), np.log2(n_hi), nn)
        n = jnp.asarray(2.0 ** ln)
        T0 = jnp.zeros_like(n)
        P = np.asarray(policy.pressure(n, T0))
        e = np.asarray(policy.energy(n, T0))
        cs = np.asarray(policy.sound_speed(n, T0))
        return cls(ln, np.log2(P), np.log2(e), cs, mb=policy.mb,
                   gamma_thermal=gamma_thermal, use_nqt=use_nqt)

    @classmethod
    def from_npz(cls, fname, gamma_thermal=5.0 / 3.0, use_nqt=False):
        d = np.load(fname)
        return cls(d["log2_n"], d["log2_P"], d["log2_e"], d["cs"],
                   mb=float(d["mb"]), gamma_thermal=gamma_thermal,
                   use_nqt=use_nqt)

    @classmethod
    def from_input(cls, pin, block: str):
        fname = pin.get_string(block, "eos_file")
        return cls.from_npz(
            fname,
            gamma_thermal=pin.get_or_add_real(block, "gamma_thermal",
                                              5.0 / 3.0),
            use_nqt=pin.get_or_add_boolean(block, "use_nqt", False))

    # -- cold-curve interpolation (eval_at_ln, eos_hybrid.hpp:255-270)
    def _eval(self, table, n):
        ln = self.logs.log2(jnp.clip(n, self.min_n, self.max_n))
        dx = self.ln[1] - self.ln[0]
        f = (ln - self.ln[0]) / dx
        i0 = jnp.clip(jnp.floor(f).astype(jnp.int32), 0, len(self.ln) - 2)
        w = jnp.clip(f - i0, 0.0, 1.0)
        tab = jnp.asarray(table)
        return (1.0 - w) * jnp.take(tab, i0) + w * jnp.take(tab, i0 + 1)

    def _cold_p(self, n):
        return self.logs.exp2(self._eval(self.tab_lp, n))

    def _cold_e(self, n):
        return self.logs.exp2(self._eval(self.tab_le, n))

    def _cold_cs(self, n):
        return self._eval(self.tab_cs, n)

    # -- thermodynamics (vectorized eos_hybrid.hpp:82-146)
    def temperature_from_e(self, n, e, Y=None):
        return jnp.maximum(
            self.gth_m1 * (e - self._cold_e(n)) / n, self.min_T)

    def temperature_from_p(self, n, p, Y=None):
        return jnp.maximum((p - self._cold_p(n)) / n, self.min_T)

    def energy(self, n, T, Y=None):
        return self._cold_e(n) + n * T / self.gth_m1

    def pressure(self, n, T, Y=None):
        return self._cold_p(n) + n * T

    def enthalpy(self, n, T, Y=None):
        return (self.energy(n, T, Y) + self.pressure(n, T, Y)) / n

    def min_enthalpy(self) -> float:
        return self._min_h

    def sound_speed(self, n, T, Y=None):
        h_cold = (self._cold_p(n) + self._cold_e(n)) / n
        h_th = self.gamma_th * T / self.gth_m1
        hcs2_cold = self._cold_cs(n) ** 2 * h_cold
        hcs2_th = self.gamma_th * T
        return jnp.sqrt((hcs2_cold + hcs2_th) / (h_cold + h_th))

    # -- host/numpy cold curves for initial-data integrators (TOV)
    def cold_pressure_np(self, rho):
        n = np.asarray(rho, dtype=np.float64) / self.mb
        return 2.0 ** np.interp(np.log2(np.clip(n, self.min_n, self.max_n)),
                                self.ln, self.tab_lp)

    def cold_energy_np(self, rho):
        n = np.asarray(rho, dtype=np.float64) / self.mb
        return 2.0 ** np.interp(np.log2(np.clip(n, self.min_n, self.max_n)),
                                self.ln, self.tab_le)

    def cold_rho_from_p_np(self, p):
        lp = np.log2(np.maximum(np.asarray(p, dtype=np.float64), 1e-300))
        return 2.0 ** np.interp(lp, self.tab_lp, self.ln) * self.mb


def make_policy(pin, block: str):
    """Factory keyed on <block>/dyn_eos (reference: BuildDynGRMHD,
    dyn_grmhd.cpp:78-120)."""
    kind = pin.get_or_add_string(block, "dyn_eos", "ideal")
    if kind == "ideal":
        return IdealGasPS.from_input(pin, block)
    if kind == "piecewise_poly":
        return PiecewisePolytropePS.from_input(pin, block)
    if kind == "compose":
        return CompOSEPS.from_input(pin, block)
    if kind == "hybrid":
        return HybridPS.from_input(pin, block)
    raise ValueError(f"{block}/dyn_eos={kind} not implemented "
                     "(ideal, piecewise_poly, compose, hybrid)")
