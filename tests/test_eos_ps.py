"""Primitive-solver EOS framework: policy thermodynamics + c2p round trip.

Mirrors the reference's unit-test strategy (reference:
src/pgen/unit_tests/eos_compose.cpp driven by
tst/test_suite/unit_tests/ with ut_compose_{log,NQT}.athinput):
prim -> cons -> prim must close across a grid of thermodynamic states,
for every EOS policy, on curved 3-metrics and with magnetization.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from athenak_jax.eos_ps import (CompOSEPS, HybridPS, IdealGasPS,
                                PiecewisePolytropePS, PrimitiveSolverPS,
                                NQTLogs, spatial_inv)

jax.config.update("jax_enable_x64", True)


def _states(rng, N, sigma_max=10.0):
    n = jnp.asarray(10.0 ** rng.uniform(-8, 0, N))
    T = jnp.asarray(10.0 ** rng.uniform(-6, 1, N))
    Wv = [jnp.asarray(rng.uniform(-2, 2, N)) for _ in range(3)]
    # physical magnetizations: sigma = b^2/rho up to ~sigma_max
    bscale = np.sqrt(np.asarray(n) * sigma_max / 3.0)
    B = [jnp.asarray(rng.uniform(-1, 1, N) * bscale) for _ in range(3)]
    g3d = [jnp.asarray(1.0 + 0.2 * rng.uniform(0, 1, N)),
           jnp.asarray(0.05 * rng.uniform(-1, 1, N)),
           jnp.asarray(0.05 * rng.uniform(-1, 1, N)),
           jnp.asarray(1.0 + 0.2 * rng.uniform(0, 1, N)),
           jnp.asarray(0.05 * rng.uniform(-1, 1, N)),
           jnp.asarray(1.0 + 0.2 * rng.uniform(0, 1, N))]
    return n, T, Wv, B, g3d, spatial_inv(g3d)


def _roundtrip(policy, tol_n, tol_p, N=2000):
    rng = np.random.default_rng(7)
    ps = PrimitiveSolverPS(policy, dfloor=1e-12)
    n, T, Wv, B, g3d, g3u = _states(rng, N)
    P = policy.pressure(n, T)
    D, S_d, tau = ps.prim_to_con(n, Wv, P, T, B, g3d)
    out = jax.jit(lambda D, S, t, B: ps.con_to_prim(D, S, t, B, g3d, g3u))(
        D, S_d, tau, B)
    nerr = np.max(np.abs(np.asarray(out["n"] - n)) / np.asarray(n))
    # pressure compared with an absolute floor: near-cold cells amplify
    # roundoff by h/T (identical conditioning in the reference solver)
    perr = np.max(np.abs(np.asarray(out["P"] - P))
                  / (np.asarray(P) + 1e-10 * np.asarray(n)))
    verr = max(np.max(np.abs(np.asarray(out["Wv_u"][a] - Wv[a])))
               for a in range(3))
    assert int(out["nfloor"]) == 0
    assert nerr < tol_n, f"n error {nerr}"
    assert perr < tol_p, f"P error {perr}"
    assert verr < 100 * tol_n, f"Wv error {verr}"


def test_ideal_gas_roundtrip():
    _roundtrip(IdealGasPS(gamma=5.0 / 3.0), 1e-7, 1e-4)


def test_piecewise_polytrope_roundtrip():
    pp = PiecewisePolytropePS([1e-8, 1e-4, 1e-2], [1.4, 5.0 / 3.0, 2.0],
                              P0=1e-6)
    _roundtrip(pp, 1e-7, 1e-4)


def test_piecewise_polytrope_pieces():
    """Continuity of P and e across dividing densities."""
    pp = PiecewisePolytropePS([1e-8, 1e-4, 1e-2], [1.4, 5.0 / 3.0, 2.0],
                              P0=1e-6)
    for rho_div in (1e-4, 1e-2):
        lo = jnp.asarray([rho_div * (1 - 1e-10)])
        hi = jnp.asarray([rho_div * (1 + 1e-10)])
        for fn in (pp.pressure, pp.energy):
            a = float(fn(lo, jnp.zeros(1))[0])
            b = float(fn(hi, jnp.zeros(1))[0])
            assert abs(a - b) / abs(a) < 1e-6


def test_compose_table_roundtrip():
    ideal = IdealGasPS(gamma=5.0 / 3.0)
    comp = CompOSEPS.from_function(ideal, 1e-9, 1e1, 1e-7, 1e2,
                                   nn=128, nt=128)
    _roundtrip(comp, 2e-2, 3e-1)


def test_compose_interp_matches_analytic():
    """Table interpolation reproduces the sampled analytic EOS."""
    ideal = IdealGasPS(gamma=5.0 / 3.0)
    comp = CompOSEPS.from_function(ideal, 1e-9, 1e1, 1e-7, 1e2,
                                   nn=256, nt=256)
    rng = np.random.default_rng(3)
    n = jnp.asarray(10.0 ** rng.uniform(-8, 0, 500))
    T = jnp.asarray(10.0 ** rng.uniform(-6, 1, 500))
    p_tab = np.asarray(comp.pressure(n, T))
    p_ref = np.asarray(ideal.pressure(n, T))
    assert np.max(np.abs(p_tab - p_ref) / p_ref) < 1e-3
    t_inv = np.asarray(comp.temperature_from_p(n, comp.pressure(n, T)))
    assert np.max(np.abs(t_inv - np.asarray(T)) / np.asarray(T)) < 1e-3


def test_hybrid_roundtrip():
    """Hybrid (cold table + thermal gamma) through the full c2p chain
    (reference: eos_hybrid.hpp)."""
    pp = PiecewisePolytropePS([1e-9, 1e-4, 1e-2], [1.4, 5.0 / 3.0, 2.0],
                              P0=1e-7)
    hyb = HybridPS.from_cold_policy(pp, 1e-9, 1e1, nn=512,
                                    gamma_thermal=1.8)
    _roundtrip(hyb, 1e-6, 1e-3)


def test_hybrid_matches_analytic_cold_plus_thermal():
    """P/e/T inversions agree with the analytic cold curve + gamma-law
    thermal decomposition it was built from."""
    pp = PiecewisePolytropePS([1e-9, 1e-4, 1e-2], [1.4, 5.0 / 3.0, 2.0],
                              P0=1e-7, gamma_thermal=1.8)
    hyb = HybridPS.from_cold_policy(pp, 1e-9, 1e1, nn=2048,
                                    gamma_thermal=1.8)
    rng = np.random.default_rng(5)
    n = jnp.asarray(10.0 ** rng.uniform(-8, 0, 500))
    T = jnp.asarray(10.0 ** rng.uniform(-6, 1, 500))
    for fn_h, fn_a in ((hyb.pressure, pp.pressure),
                       (hyb.energy, pp.energy),
                       (hyb.sound_speed, pp.sound_speed)):
        a = np.asarray(fn_h(n, T))
        b = np.asarray(fn_a(n, T))
        assert np.max(np.abs(a - b) / np.abs(b)) < 2e-3, fn_a.__name__
    # exact thermal inversions on top of the interpolated cold curve
    t_p = np.asarray(hyb.temperature_from_p(n, hyb.pressure(n, T)))
    t_e = np.asarray(hyb.temperature_from_e(n, hyb.energy(n, T)))
    np.testing.assert_allclose(t_p, np.asarray(T), rtol=1e-10)
    np.testing.assert_allclose(t_e, np.asarray(T), rtol=1e-10)


def test_nqt_logs_invertible():
    """NQT fast logs: exp2(log2(x)) == x (bit-exact round trip,
    reference: logs.hpp:68 LANL bit hack)."""
    logs = NQTLogs()
    x = jnp.asarray(10.0 ** np.random.default_rng(1).uniform(-20, 20, 1000))
    back = np.asarray(logs.exp2(logs.log2(x)))
    np.testing.assert_allclose(back, np.asarray(x), rtol=1e-12)
    # monotone
    lx = np.asarray(logs.log2(jnp.sort(x)))
    assert np.all(np.diff(lx) > 0)


def test_compose_nqt_roundtrip():
    ideal = IdealGasPS(gamma=5.0 / 3.0)
    comp = CompOSEPS.from_function(ideal, 1e-9, 1e1, 1e-7, 1e2,
                                   nn=256, nt=256, use_nqt=True)
    _roundtrip(comp, 5e-2, 5e-1)
