"""Orthonormal tetrads on Cartesian Kerr-Schild coordinates.

Parity target: reference ``ComputeTetrad`` + ``SetOrthonormalTetrad``
(reference: src/radiation/radiation_tetrad.hpp:17-175,
radiation_tetrad.cpp:26-280).  The closed-form CKS tetrad (time leg
along the coordinate normal of the KS form, spatial legs by explicit
Gram-Schmidt), its analytic derivatives, the Ricci rotation
coefficients used by the angular fluxes, and the normal-frame ->
tetrad-frame velocity transformation.

Design: all quantities are elementwise closed forms over cell/face
coordinate arrays — computed vectorized (and typically folded by XLA
when the coordinates are trace-time constants).
"""

from __future__ import annotations

import numpy as np

# Works on either numpy or jax.numpy inputs: pick the module from the
# array type at call time.


def _nmod(x):
    import jax.numpy as jnp
    return jnp if not isinstance(x, np.ndarray) else np


def tetrad(x, y, z, spin, minkowski=False):
    """Tetrad e[a][mu] = e_(a)^mu and covariant ecov[a][mu] = e_(a)_mu
    (reference: ComputeTetrad, radiation_tetrad.hpp:17-54)."""
    m = _nmod(x)
    a = spin
    rad2 = x * x + y * y + z * z
    r2 = (rad2 - a * a
          + m.sqrt((rad2 - a * a) ** 2 + 4.0 * a * a * z * z)) / 2.0
    r = m.sqrt(r2)
    r = m.maximum(r, 1.0)
    ll1 = (r * x + a * y) / (r * r + a * a)
    ll2 = (r * y - a * x) / (r * r + a * a)
    ll3 = z / r
    f = 2.0 * r ** 3 / (r ** 4 + a * a * z * z)
    if minkowski:
        f = 0.0 * f

    wa = m.sqrt(1.0 + f)
    wb = m.sqrt(1.0 + f * (ll1 * ll1 + ll2 * ll2))
    wc = m.sqrt(1.0 + f * ll2 * ll2)
    iwa, iwb, iwc = 1.0 / wa, 1.0 / wb, 1.0 / wc
    zero = 0.0 * wa
    e = [[wa, -f * iwa * ll1, -f * iwa * ll2, -f * iwa * ll3],
         [zero, iwb * wc, -f * iwb * iwc * ll1 * ll2, zero],
         [zero, zero, iwc, zero],
         [zero, -f * iwa * iwb * ll1 * ll3,
          -f * iwa * iwb * ll2 * ll3, iwa * wb]]

    # covariant tetrad: e_(a)_mu = g_mu_nu e_(a)^nu with the KS metric
    # g = eta + f l l
    ll = [1.0 + zero, ll1, ll2, ll3]
    eta = [-1.0, 1.0, 1.0, 1.0]

    def gdot(v):
        # (g v)_mu = eta_mu v^mu + f l_mu (l.v) with l_mu = (+1? ) note
        # l_mu = (1, l1, l2, l3) and l^mu = (-1? )  KS: g_munu =
        # eta_munu + f l_mu l_nu with l_mu = (1, ll1, ll2, ll3)
        lv = v[0] + ll1 * v[1] + ll2 * v[2] + ll3 * v[3]
        return [eta[mu] * v[mu] + f * ll[mu] * lv for mu in range(4)]

    ecov = [gdot(e[aa]) for aa in range(4)]
    return e, ecov


def norm_to_tet(x, y, z, spin, minkowski=False):
    """Transformation from normal-frame (gamma, u~^i) to tetrad-frame
    4-velocity: u_tet[a] = sum_mu M[a][mu] (gamma, u1, u2, u3)
    (reference: radiation_tetrad.cpp norm_to_tet block)."""
    m = _nmod(x)
    from ..gr.cks import metric
    gl, gu = metric(x, y, z, spin, minkowski)
    e, ecov = tetrad(x, y, z, spin, minkowski)
    alpha = 1.0 / m.sqrt(-gu[0][0])
    # norm_to_coord[mu][nu'] maps (gamma, uu1, uu2, uu3) -> u^mu
    n2c = [[1.0 / alpha, 0.0 * alpha, 0.0 * alpha, 0.0 * alpha],
           [-alpha * gu[0][1], 1.0 + 0.0 * alpha, 0.0 * alpha,
            0.0 * alpha],
           [-alpha * gu[0][2], 0.0 * alpha, 1.0 + 0.0 * alpha,
            0.0 * alpha],
           [-alpha * gu[0][3], 0.0 * alpha, 0.0 * alpha,
            1.0 + 0.0 * alpha]]
    # norm_to_tet[a][nu'] = eta^{ab} e_(b)_mu norm_to_coord[mu][nu']
    eta_sign = [-1.0, 1.0, 1.0, 1.0]
    out = [[sum(eta_sign[aa] * ecov[aa][mu] * n2c[mu][nu]
                for mu in range(4))
            for nu in range(4)] for aa in range(4)]
    return out


def _tetrad_derivatives(x, y, z, spin, minkowski=False):
    """Analytic coordinate derivatives de[d][a][mu] = d_d e_(a)^mu
    (reference: radiation_tetrad.hpp:55-126)."""
    m = _nmod(x)
    a = spin
    rad2 = x * x + y * y + z * z
    r2 = (rad2 - a * a
          + m.sqrt((rad2 - a * a) ** 2 + 4.0 * a * a * z * z)) / 2.0
    r = m.maximum(m.sqrt(r2), 1.0)
    ll1 = (r * x + a * y) / (r * r + a * a)
    ll2 = (r * y - a * x) / (r * r + a * a)
    ll3 = z / r
    f = 2.0 * r ** 3 / (r ** 4 + a * a * z * z)

    qa = 2.0 * r * r - rad2 + a * a
    qb = r * r + a * a
    qc = 3.0 * a * a * z * z - r ** 4
    df = [f * f * x / (2.0 * r ** 3) * qc / qa,
          f * f * y / (2.0 * r ** 3) * qc / qa,
          f * f * z / (2.0 * r ** 5) * (qc * qb / qa
                                        - 2.0 * (a * r) ** 2)]
    if minkowski:
        f = 0.0 * f
        df = [0.0 * d for d in df]

    dl1 = [x * r * (a * a * x - 2.0 * a * r * y - r * r * x)
           / (qb * qb * qa) + r / qb,
           y * r * (a * a * x - 2.0 * a * r * y - r * r * x)
           / (qb * qb * qa) + a / qb,
           z / r * (a * a * x - 2.0 * a * r * y - r * r * x) / (qb * qa)]
    dl2 = [x * r * (a * a * y + 2.0 * a * r * x - r * r * y)
           / (qb * qb * qa) - a / qb,
           y * r * (a * a * y + 2.0 * a * r * x - r * r * y)
           / (qb * qb * qa) + r / qb,
           z / r * (a * a * y + 2.0 * a * r * x - r * r * y) / (qb * qa)]
    dl3 = [-x * z / (r * qa),
           -y * z / (r * qa),
           -z * z / (r ** 3) * qb / qa + 1.0 / r]

    wa = m.sqrt(1.0 + f)
    wb = m.sqrt(1.0 + f * (ll1 * ll1 + ll2 * ll2))
    wc = m.sqrt(1.0 + f * ll2 * ll2)
    iwa, iwb, iwc = 1.0 / wa, 1.0 / wb, 1.0 / wc
    iwasq, iwbsq, iwcsq = iwa * iwa, iwb * iwb, iwc * iwc

    dwa = [0.5 * iwa * df[d] for d in range(3)]
    dwb = [0.5 * iwb * (2.0 * f * ll1 * dl1[d] + 2.0 * f * ll2 * dl2[d]
                        + (ll1 * ll1 + ll2 * ll2) * df[d])
           for d in range(3)]
    dwc = [0.5 * iwc * (2.0 * f * ll2 * dl2[d] + ll2 * ll2 * df[d])
           for d in range(3)]

    zero = 0.0 * wa
    # de[d][a][mu], d in 1..3 stored as 0..2
    de = [[[zero for _ in range(4)] for _ in range(4)] for _ in range(3)]
    dls = [dl1, dl2, dl3]
    lls = [ll1, ll2, ll3]
    for d in range(3):
        de[d][0][0] = dwa[d]
        for c in range(3):
            de[d][0][c + 1] = (-f * iwa * dls[c][d]
                               - iwa * lls[c] * df[d]
                               + f * iwasq * lls[c] * dwa[d])
        de[d][1][1] = iwb * dwc[d] - iwbsq * wc * dwb[d]
        de[d][1][2] = (-f * iwb * iwc * ll1 * dl2[d]
                       - f * iwb * iwc * ll2 * dl1[d]
                       + (-iwb * iwc * df[d] + f * iwbsq * iwc * dwb[d]
                          + f * iwb * iwcsq * dwc[d]) * ll1 * ll2)
        de[d][2][2] = -iwcsq * dwc[d]
        de[d][3][1] = (-f * iwa * iwb * ll1 * dl3[d]
                       - f * iwa * iwb * ll3 * dl1[d]
                       + (-iwa * iwb * df[d] + f * iwasq * iwb * dwa[d]
                          + f * iwa * iwbsq * dwb[d]) * ll1 * ll3)
        de[d][3][2] = (-f * iwa * iwb * ll2 * dl3[d]
                       - f * iwa * iwb * ll3 * dl2[d]
                       + (-iwa * iwb * df[d] + f * iwasq * iwb * dwa[d]
                          + f * iwa * iwbsq * dwb[d]) * ll2 * ll3)
        de[d][3][3] = iwa * dwb[d] - iwasq * wb * dwa[d]
    return de


def ricci_rotation(x, y, z, spin, minkowski=False):
    """Ricci rotation coefficients omega[i][j][k] (reference:
    ComputeTetrad tail, radiation_tetrad.hpp:127-175)."""
    m = _nmod(x)
    from ..gr.cks import metric, metric_derivatives
    gl, gu = metric(x, y, z, spin, minkowski)
    dgs = metric_derivatives(x, y, z, spin, minkowski)  # [3][4][4]
    e, ecov = tetrad(x, y, z, spin, minkowski)
    de = _tetrad_derivatives(x, y, z, spin, minkowski)

    zero = 0.0 * (x + y + z)
    # dg[d][mu][nu] with d=0 the (vanishing) time derivative
    dg = [[[zero] * 4 for _ in range(4)]] + \
        [[[dgs[d][mu][nu] for nu in range(4)] for mu in range(4)]
         for d in range(3)]
    de4 = [[[zero] * 4 for _ in range(4)]] + de  # time derivative = 0

    eta_sign = [-1.0, 1.0, 1.0, 1.0]
    # inverse tetrad ei[a][mu] = eta^{ab} e_(b)_mu  (mixed index form
    # used by the reference's contraction)
    ei = [[eta_sign[aa] * ecov[aa][mu] for mu in range(4)]
          for aa in range(4)]
    # coordinate Christoffels Gamma^l_{m n}
    gamma = [[[sum(0.5 * gu[ii][ll] * (dg[jj][ll][kk] + dg[kk][ll][jj]
                                       - dg[ll][jj][kk])
                   for ll in range(4))
               for kk in range(4)] for jj in range(4)]
             for ii in range(4)]

    omega = [[[zero for _ in range(4)] for _ in range(4)]
             for _ in range(4)]
    for ii in range(4):
        for jj in range(4):
            for kk in range(4):
                v = zero
                for ll in range(4):
                    for mm in range(4):
                        v = v + ei[ii][ll] * e[kk][mm] * de4[mm][jj][ll]
                        for nn in range(4):
                            v = v + (ei[ii][ll] * e[kk][mm]
                                     * gamma[ll][mm][nn] * e[jj][nn])
                omega[ii][jj][kk] = v
    return omega
