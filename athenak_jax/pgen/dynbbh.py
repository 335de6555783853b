"""Superposed boosted Kerr-Schild binary black holes (dynamical GRMHD
on a prescribed orbiting spacetime).

Parity target: reference src/pgen/dyn_grmhd/dynbbh.cpp — fluid (floor
atmosphere) evolving on the analytic superposed-BBH metric:

  * analytic circular trajectory: BH1 at q/(1+q) sep, BH2 at
    -sep/(1+q), angular rate Om = sep^{-3/2}, masses 1/(q+1) and
    q/(q+1) scaled by adjust_mass, fixed spin vectors from
    (a, th_a, ph_a) (find_traj_t:592-616; note the reference's
    bbh_t[X2] uses r_BH1_0 — an apparent typo this port corrects to
    r_BH2_0 so BH2 actually orbits opposite BH1);
  * each hole contributes a BOOSTED spinning Kerr-Schild term:
    rest-frame offsets via the length-contraction map
    x' = d + (gamma-1)(v.d) v/v^2, Kerr radius from
    r^4 - (|x'|^2-a^2) r^2 - (a.x')^2 = 0,
    H = m r^3/(r^4 + (a.x')^2),
    l' = (1, (r x' - a X x' + (a.x') a/r)/(r^2+a^2)),
    lab-frame l = Lambda^T l' with the velocity boost, and
    g = eta + 2 H1 l1 l1 + 2 H2 l2 l2 (SuperposedBBH:618-980);
  * the z-offset clamp inside r < |a|(1+buffer)+cutoff_floor keeps the
    ring singularity off the grid (SuperposedBBH:725-742);
  * ADM variables from the 4-metric by central differences with
    h = 5e-5 in t and x,y,z, exactly the reference's numerical_4metric
    + four_metric_to_three_metric (dynbbh.cpp:315-592), including the
    det<=0 Minkowski fallback near merger;
  * AMR: amr_condition = track (blocks within radius_thr of either
    hole refine; RefineTracker:1051-1119) or alpha_min (lapse minimum
    below alpha_thr; RefineAlphaMin:1006-1048).

Design: the metric is a closed-form jnp function of the traced
time, installed through DynGRMHD.set_adm_fn — the spacetime orbits
inside ONE compiled cycle (the reference re-runs its SetADMVariables
kernel per step; here XLA fuses it into the stage)."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

_H = 5e-5  # FD step (reference: #define h 5e-5)


def _params(pin):
    g = lambda k, d: pin.get_or_add_real("problem", k, d)  # noqa: E731
    p = dict(sep=g("sep", 20.0), q=g("q", 1.0), a1=g("a1", 0.0),
             a2=g("a2", 0.0), th_a1=g("th_a1", 0.0),
             th_a2=g("th_a2", 0.0), ph_a1=g("ph_a1", 0.0),
             ph_a2=g("ph_a2", 0.0),
             dfloor=g("dfloor", float(np.finfo(np.float32).tiny)),
             pfloor=g("pfloor", float(np.finfo(np.float32).tiny)),
             adjust_mass1=g("adjust_mass1", 1.0),
             adjust_mass2=g("adjust_mass2", 1.0),
             a1_buffer=g("a1_buffer", 0.0), a2_buffer=g("a2_buffer", 0.0),
             cutoff_floor=g("cutoff_floor", 1e-10),
             alpha_thr=g("alpha_thr", 0.6),
             radius_thr=g("radius_thr", 6.0))
    p["om"] = p["sep"] ** -1.5
    p["amr_condition"] = pin.get_or_add_string(
        "problem", "amr_condition", "track")
    return p


def _traj(t, p):
    """(xi, v, a_vec, m) per hole at time t (find_traj_t; the BH2
    x-position typo corrected — see module docstring)."""
    r1 = p["q"] / (1.0 + p["q"]) * p["sep"]
    r2 = -p["sep"] / (1.0 + p["q"])
    c, s = jnp.cos(p["om"] * t), jnp.sin(p["om"] * t)
    m1 = 1.0 / (p["q"] + 1.0)
    m2 = 1.0 - m1
    holes = []
    for r0, a, th, ph, mt, adj, buf in (
            (r1, p["a1"], p["th_a1"], p["ph_a1"], m1,
             p["adjust_mass1"], p["a1_buffer"]),
            (r2, p["a2"], p["th_a2"], p["ph_a2"], m2,
             p["adjust_mass2"], p["a2_buffer"])):
        xi = (r0 * c, r0 * s, 0.0)
        v = (-r0 * p["om"] * s + 1e-40, r0 * p["om"] * c + 1e-40, 1e-40)
        av = (a * math.sin(th) * math.cos(ph) * adj,
              a * math.sin(th) * math.sin(ph) * adj,
              a * math.cos(th) * adj)
        amag = math.sqrt(sum(x * x for x in av) + 1e-40)
        rcut = amag * (1.0 + buf) + p["cutoff_floor"]
        holes.append(dict(xi=xi, v=v, a=av, m=mt * adj, rcut=rcut))
    return holes


def _bks_term(x, y, z, hole):
    """(2H, l_mu[4]) of one boosted Kerr-Schild hole in the lab frame
    (SuperposedBBH:618-980, first-principles form)."""
    xi, v, av, m = hole["xi"], hole["v"], hole["a"], hole["m"]
    v2 = v[0] ** 2 + v[1] ** 2 + v[2] ** 2
    gam = 1.0 / jnp.sqrt(1.0 - v2)
    d = (x - xi[0], y - xi[1], z - xi[2])
    vd = v[0] * d[0] + v[1] * d[1] + v[2] * d[2]
    # rest-frame spatial offsets (length contraction along v)
    fac = (gam - 1.0) * vd / v2
    xp = [d[i] + fac * v[i] for i in range(3)]
    # z-clamp inside the cutoff sphere (keeps the ring singularity out)
    rr = jnp.sqrt(xp[0] ** 2 + xp[1] ** 2 + xp[2] ** 2)
    rcut = hole["rcut"]
    xp[2] = jnp.where(rr < rcut,
                      jnp.where(xp[2] > 0, rcut, -rcut), xp[2])
    rho2 = xp[0] ** 2 + xp[1] ** 2 + xp[2] ** 2
    asq = av[0] ** 2 + av[1] ** 2 + av[2] ** 2
    adotx = av[0] * xp[0] + av[1] * xp[1] + av[2] * xp[2]
    r2 = 0.5 * ((rho2 - asq)
                + jnp.sqrt((rho2 - asq) ** 2 + 4.0 * adotx ** 2))
    r = jnp.sqrt(jnp.maximum(r2, 1e-30))
    H = m * r2 * r / jnp.maximum(r2 * r2 + adotx ** 2, 1e-30)
    # rest-frame null covector l' = (1, (r x' - a X x' + (a.x')a/r)
    #                                    / (r^2 + a^2))
    cross = (av[1] * xp[2] - av[2] * xp[1],
             av[2] * xp[0] - av[0] * xp[2],
             av[0] * xp[1] - av[1] * xp[0])
    den = r2 + asq
    lsp = [(r * xp[i] - cross[i] + adotx * av[i] / r) / den
           for i in range(3)]
    # boost to the lab frame: l_mu = l'_nu Lambda^nu_mu with
    # Lambda = diag boost for velocity v (covariant components)
    lv = v[0] * lsp[0] + v[1] * lsp[1] + v[2] * lsp[2]
    l0 = gam * 1.0 - gam * lv
    fac2 = (gam - 1.0) / v2
    ll = [lsp[i] + fac2 * v[i] * lv - gam * v[i] * 1.0 for i in range(3)]
    return 2.0 * H, (l0, ll[0], ll[1], ll[2])


def _g4(t, x, y, z, p):
    """Superposed covariant 4-metric, 10 components in the order
    (tt,tx,ty,tz,xx,xy,xz,yy,yz,zz)."""
    eta = [-1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 1.0, 0.0, 1.0]
    comps = [jnp.asarray(e) + 0.0 * x for e in eta]
    idx = [(0, 0), (0, 1), (0, 2), (0, 3), (1, 1), (1, 2), (1, 3),
           (2, 2), (2, 3), (3, 3)]
    for hole in _traj(t, p):
        th, l = _bks_term(x, y, z, hole)
        for n, (a, b) in enumerate(idx):
            comps[n] = comps[n] + th * l[a] * l[b]
    return comps


def make_adm_fn(mesh, p, lb):
    """fn(t) -> adm dict: numerical 4-metric derivatives + 3+1 split
    (numerical_4metric + four_metric_to_three_metric)."""
    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    xs = np.empty((nmb, 1, 1, mbi.ncells1))
    ys = np.empty((nmb, 1, mbi.ncells2, 1))
    zs = np.empty((nmb, mbi.ncells3, 1, 1))
    for g in range(nmb):
        c1, c2, c3 = mesh.cell_centers(g)
        xs[g, 0, 0], ys[g, 0, :, 0], zs[g, :, 0, 0] = c1, c2, c3

    def adm_fn(t):
        X = jnp.asarray(lb(xs))
        Y = jnp.asarray(lb(ys))
        Z = jnp.asarray(lb(zs))
        g0 = _g4(t, X, Y, Z, p)
        gt = [(a - b) / (2 * _H) for a, b in
              zip(_g4(t + _H, X, Y, Z, p), _g4(t - _H, X, Y, Z, p))]
        gx = [(a - b) / (2 * _H) for a, b in
              zip(_g4(t, X + _H, Y, Z, p), _g4(t, X - _H, Y, Z, p))]
        gy = [(a - b) / (2 * _H) for a, b in
              zip(_g4(t, X, Y + _H, Z, p), _g4(t, X, Y - _H, Z, p))]
        gz = [(a - b) / (2 * _H) for a, b in
              zip(_g4(t, X, Y, Z + _H, p), _g4(t, X, Y, Z - _H, p))]
        (tt, tx, ty, tz, xx, xy, xz, yy, yz, zz) = g0
        det = (xx * (yy * zz - yz * yz) - xy * (xy * zz - yz * xz)
               + xz * (xy * yz - yy * xz))
        bad = det <= 0.0  # near-merger fallback: Minkowski
        one = jnp.ones_like(det)
        zero = jnp.zeros_like(det)
        gxx = jnp.where(bad, one, xx)
        gxy = jnp.where(bad, zero, xy)
        gxz = jnp.where(bad, zero, xz)
        gyy = jnp.where(bad, one, yy)
        gyz = jnp.where(bad, zero, yz)
        gzz = jnp.where(bad, one, zz)
        det = jnp.where(bad, one, det)
        bdx = jnp.where(bad, zero, tx)
        bdy = jnp.where(bad, zero, ty)
        bdz = jnp.where(bad, zero, tz)
        sel = lambda q: jnp.where(bad, zero, q)  # noqa: E731
        dtg = [sel(q) for q in gt[4:]]
        dgx = [sel(q) for q in gx[4:]]
        dgy = [sel(q) for q in gy[4:]]
        dgz = [sel(q) for q in gz[4:]]
        # d_j beta_i (lowered): spatial derivatives of g_{t i}
        dbxx, dbyx, dbzx = sel(gx[1]), sel(gx[2]), sel(gx[3])
        dbxy, dbyy_, dbzy = sel(gy[1]), sel(gy[2]), sel(gy[3])
        dbxz, dbyz, dbzz = sel(gz[1]), sel(gz[2]), sel(gz[3])

        ixx = (-gyz * gyz + gyy * gzz) / det
        ixy = (gxz * gyz - gxy * gzz) / det
        ixz = (-(gxz * gyy) + gxy * gyz) / det
        iyy = (-gxz * gxz + gxx * gzz) / det
        iyz = (gxy * gxz - gxx * gyz) / det
        izz = (-gxy * gxy + gxx * gyy) / det
        bx = bdx * ixx + bdy * ixy + bdz * ixz
        by = bdx * ixy + bdy * iyy + bdz * iyz
        bz = bdx * ixz + bdy * iyz + bdz * izz
        b2 = bdx * bx + bdy * by + bdz * bz
        alpha = jnp.sqrt(jnp.abs(b2 - jnp.where(bad, -one, tt)))
        (dgxxx, dgxyx, dgxzx, dgyyx, dgyzx, dgzzx) = dgx
        (dgxxy, dgxyy, dgxzy, dgyyy, dgyzy, dgzzy) = dgy
        (dgxxz, dgxyz, dgxzz, dgyyz, dgyzz, dgzzz) = dgz
        (dtgxx, dtgxy, dtgxz, dtgyy, dtgyz, dtgzz) = dtg
        ia = 1.0 / (2.0 * alpha)
        # K_ij (four_metric_to_three_metric:517-545 verbatim)
        kxx = -(-2 * dbxx - bx * dgxxx - by * dgxxy - bz * dgxxz
                + 2 * (bx * dgxxx + by * dgxyx + bz * dgxzx)
                + dtgxx) * ia
        kxy = -(-dbxy - dbyx + bx * dgxxy - bz * dgxyz + bz * dgxzy
                + by * dgyyx + bz * dgyzx + dtgxy) * ia
        kxz = -(-dbxz - dbzx + bx * dgxxz + by * dgxyz - by * dgxzy
                + by * dgyzx + bz * dgzzx + dtgxz) * ia
        kyy = -(-2 * dbyy_ - bx * dgyyx - by * dgyyy - bz * dgyyz
                + 2 * (bx * dgxyy + by * dgyyy + bz * dgyzy)
                + dtgyy) * ia
        kyz = -(-dbyz - dbzy + bx * dgxyz + bx * dgxzy + by * dgyyz
                - bx * dgyzx + bz * dgzzy + dtgyz) * ia
        kzz = -(-2 * dbzz - bx * dgzzx - by * dgzzy - bz * dgzzz
                + 2 * (bx * dgxzz + by * dgyzz + bz * dgzzz)
                + dtgzz) * ia
        return {"g3d": [gxx, gxy, gxz, gyy, gyz, gzz],
                "alpha": alpha, "beta_u": [bx, by, bz],
                "K_dd": [kxx, kxy, kxz, kyy, kyz, kzz]}

    return adm_fn


def init(pin, mesh, phys):
    if not phys.fixed_evolution:
        raise ValueError("dynbbh prescribes the spacetime analytically; "
                         "remove the <z4c> block (reference runs it "
                         "with the ADM background only)")
    p = _params(pin)
    from ..comm import local_blocks

    def lb(tab):
        return local_blocks(tab, pad_edge=True)

    phys.set_adm_fn(make_adm_fn(mesh, p, lb))

    # ---- AMR criteria (RefineTracker / RefineAlphaMin) ----
    if p["amr_condition"] == "alpha_min":
        def refine(state, mesh_now):
            adm = phys.adm_of(state)
            mbi = mesh_now.mb_indcs
            a = np.asarray(adm["alpha"])[
                :, mbi.ks:mbi.ke + 1, mbi.js:mbi.je + 1,
                mbi.is_:mbi.ie + 1]
            amin = a.min(axis=(1, 2, 3))
            flags = np.zeros(a.shape[0], dtype=np.int64)
            flags[amin < p["alpha_thr"]] = 1
            flags[amin > 1.25 * p["alpha_thr"]] = -1
            return flags
    else:
        def refine(state, mesh_now):
            t = float(state.get("t", mesh_now.time))
            nmb = mesh_now.nmb_total
            flags = np.full(nmb, -1, dtype=np.int64)
            sz = mesh_now.mb_size
            for hole in _traj(jnp.asarray(t), p):
                hx = float(hole["xi"][0])
                hy = float(hole["xi"][1])
                hz = float(hole["xi"][2])
                cx = np.clip(hx, sz["x1min"], sz["x1max"])
                cy = np.clip(hy, sz["x2min"], sz["x2max"])
                cz = np.clip(hz, sz["x3min"], sz["x3max"])
                d2 = (cx - hx) ** 2 + (cy - hy) ** 2 + (cz - hz) ** 2
                flags[d2 < p["radius_thr"] ** 2] = 1
            return flags

    phys.user_refine_func = refine

    # ---- floor atmosphere ICs (pgen_hydro/pgen_shock1) ----
    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    w = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2,
                  mbi.ncells1))
    w[:, 0] = p["dfloor"]
    w[:, 4] = p["pfloor"]
    wj = jnp.asarray(w, dtype=dtype)
    bfc = {k: jnp.zeros(s, dtype=dtype)
           for k, s in phys.fc_shapes.items()}
    bcc = phys.compute_bcc(bfc)
    adm = phys.adm_of({"t": jnp.asarray(0.0, dtype)})
    n = wj[:, 0] / phys.ps.mb
    T = phys.policy.temperature_from_p(jnp.maximum(n, phys.ps.n_atm),
                                       wj[:, 4])
    u = phys.prim_to_cons_state(wj, T, bcc, adm)
    return phys.make_state(u, wj, bfc, T=T)
