"""Cartesian Kerr-Schild metric, vectorized.

Parity target: the reference inline metric functions
(reference: src/coordinates/cartesian_ks.hpp:26-379): g_ab = f l_a l_b +
eta_ab with the KS null vector, its inverse, spatial derivatives, and the
ADM decomposition (used later by Z4c/DynGRMHD initial data).

Design: the metric is *recomputed inside jit* from broadcastable
coordinate arrays instead of stored — it is a handful of transcendental-free
elementwise ops that XLA fuses into the consuming kernels, trading
negligible FLOPs for zero HBM traffic.  Components are returned as nested
4x4 lists of arrays so only the components actually used are materialized.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1.0e-6


def _ks_radius(x, y, z, a):
    rad2 = x * x + y * y + z * z
    r2 = 0.5 * (rad2 - a * a
                + jnp.sqrt((rad2 - a * a) ** 2 + 4.0 * a * a * z * z))
    r = jnp.sqrt(r2)
    return jnp.where(r < _EPS, 0.5 * (_EPS + r * r / _EPS), r)


def _null_vector(x, y, z, r, a):
    qb = r * r + a * a
    return (jnp.ones_like(r) * 1.0,
            (r * x + a * y) / qb,
            (r * y - a * x) / qb,
            z / r)


def metric(x, y, z, a, minkowski=False):
    """(glower, gupper) as nested 4x4 lists of arrays
    (reference: ComputeMetricAndInverse, cartesian_ks.hpp:26-99)."""
    r = _ks_radius(x, y, z, a)
    l0, l1, l2, l3 = _null_vector(x, y, z, r, a)
    f = 2.0 * r ** 3 / (r ** 4 + a * a * z * z)
    if minkowski:
        f = jnp.zeros_like(r)

    ll = (l0, l1, l2, l3)
    eta = [[-1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0],
           [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]]
    glower = [[f * ll[i] * ll[j] + eta[i][j] for j in range(4)]
              for i in range(4)]
    # l^0 = -1, l^i = l_i; g^ab = -f l^a l^b + eta^ab
    lu = (-l0, l1, l2, l3)
    gupper = [[-f * lu[i] * lu[j] + eta[i][j] for j in range(4)]
              for i in range(4)]
    return glower, gupper


def metric_derivatives(x, y, z, a, minkowski=False):
    """(dg_dx1, dg_dx2, dg_dx3) nested 4x4 lists
    (reference: ComputeMetricDerivatives, cartesian_ks.hpp:276-379)."""
    r = _ks_radius(x, y, z, a)
    l0, l1, l2, l3 = _null_vector(x, y, z, r, a)
    rad2 = x * x + y * y + z * z
    qa = 2.0 * r * r - rad2 + a * a
    qb = r * r + a * a
    qc = 3.0 * (a * z) ** 2 - r ** 4
    f = 2.0 * r ** 3 / (r ** 4 + a * a * z * z)

    df = (f * f * x / (2.0 * r ** 3) * qc / qa,
          f * f * y / (2.0 * r ** 3) * qc / qa,
          f * f * z / (2.0 * r ** 5) * (qc * qb / qa - 2.0 * (a * r) ** 2))
    qx = a * a * x - 2.0 * a * r * y - r * r * x
    qy = a * a * y + 2.0 * a * r * x - r * r * y
    dl1 = (x * r * qx / (qb * qb * qa) + r / qb,
           y * r * qx / (qb * qb * qa) + a / qb,
           z / r * qx / (qb * qa))
    dl2 = (x * r * qy / (qb * qb * qa) - a / qb,
           y * r * qy / (qb * qb * qa) + r / qb,
           z / r * qy / (qb * qa))
    dl3 = (-x * z / (r * qa),
           -y * z / (r * qa),
           -z * z / (r ** 3) * qb / qa + 1.0 / r)
    zero = jnp.zeros_like(r)
    dl0 = (zero, zero, zero)

    if minkowski:
        f = zero
        df = (zero, zero, zero)

    ll = (l0, l1, l2, l3)
    dl = (dl0, dl1, dl2, dl3)
    out = []
    for d in range(3):
        dg = [[df[d] * ll[i] * ll[j] + f * dl[i][d] * ll[j]
               + f * ll[i] * dl[j][d]
               for j in range(4)] for i in range(4)]
        out.append(dg)
    return out[0], out[1], out[2]


def adm_decomposition(x, y, z, a, minkowski=False):
    """Lapse, shift, spatial metric of CKS
    (reference: ComputeADMDecomposition, cartesian_ks.hpp:106-268).
    Returns (alp, (bx,by,bz), g_dd 3x3 nested list)."""
    r = _ks_radius(x, y, z, a)
    _, l1, l2, l3 = _null_vector(x, y, z, r, a)
    h = r ** 3 / (r ** 4 + a * a * z * z)
    if minkowski:
        h = jnp.zeros_like(r)
    alp = 1.0 / jnp.sqrt(1.0 + 2.0 * h)
    fac = 2.0 * h / (1.0 + 2.0 * h)
    beta = (fac * l1, fac * l2, fac * l3)
    ld = (l1, l2, l3)
    eye = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    g_dd = [[2.0 * h * ld[i] * ld[j] + eye[i][j] for j in range(3)]
            for i in range(3)]
    return alp, beta, g_dd
