"""Output variable registry: base + derived quantities.

Parity target: the reference's 154-entry ``var_choice`` table and the
derived-variable kernels (reference: src/outputs/outputs.hpp:31-105,
src/outputs/basetype_output.cpp:196-640,
src/outputs/derived_variables.cpp).

Design: every entry resolves to a jitted device computation
returning ``[nmb, nvar, n3, n2, n1]`` slices; the caller fetches only
the interior cells of the requested channels (no full-state host
readback — the reference likewise computes derived vars on device).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import jax.numpy as jnp
import numpy as np

from ..indices import IDN, IEN, IVX, IVY, IVZ

_HYDRO_U = ["dens", "mom1", "mom2", "mom3", "ener"]
_HYDRO_W = ["dens", "velx", "vely", "velz", "eint"]

_Z4C_LABELS = [
    "z4c_chi",
    "z4c_gxx", "z4c_gxy", "z4c_gxz", "z4c_gyy", "z4c_gyz", "z4c_gzz",
    "z4c_Khat",
    "z4c_Axx", "z4c_Axy", "z4c_Axz", "z4c_Ayy", "z4c_Ayz", "z4c_Azz",
    "z4c_Gamx", "z4c_Gamy", "z4c_Gamz",
    "z4c_Theta", "z4c_alpha", "z4c_betax", "z4c_betay", "z4c_betaz"]

_ADM_LABELS = [
    "adm_gxx", "adm_gxy", "adm_gxz", "adm_gyy", "adm_gyz", "adm_gzz",
    "adm_Kxx", "adm_Kxy", "adm_Kxz", "adm_Kyy", "adm_Kyz", "adm_Kzz",
    "adm_alpha", "adm_betax", "adm_betay", "adm_betaz"]

_TMUNU_LABELS = [
    "tmunu_Sxx", "tmunu_Sxy", "tmunu_Sxz", "tmunu_Syy", "tmunu_Syz",
    "tmunu_Szz", "tmunu_E", "tmunu_Sx", "tmunu_Sy", "tmunu_Sz"]


def _curl_cc(v1, v2, v3, mesh, ndim):
    """Cell-centered curl with centered differences (valid in the
    interior; reference: derived_variables.cpp vorticity/current)."""
    dx1 = np.asarray(mesh.mb_size["dx1"]).reshape(-1, 1, 1, 1)
    dx2 = np.asarray(mesh.mb_size["dx2"]).reshape(-1, 1, 1, 1)
    dx3 = np.asarray(mesh.mb_size["dx3"]).reshape(-1, 1, 1, 1)

    def d(f, ax, dx):
        return (jnp.roll(f, -1, axis=ax) - jnp.roll(f, 1, axis=ax)) \
            / (2.0 * dx)

    c1 = d(v3, 2, dx2) - (d(v2, 1, dx3) if ndim == 3 else 0.0)
    c2 = (d(v1, 1, dx3) if ndim == 3 else 0.0) - d(v3, 3, dx1)
    c3 = d(v2, 3, dx1) - d(v1, 2, dx2)
    return c1, c2, c3


def _divb_cc(bfc, mesh):
    dx1 = np.asarray(mesh.mb_size["dx1"]).reshape(-1, 1, 1, 1)
    dx2 = np.asarray(mesh.mb_size["dx2"]).reshape(-1, 1, 1, 1)
    dx3 = np.asarray(mesh.mb_size["dx3"]).reshape(-1, 1, 1, 1)
    x1f, x2f, x3f = bfc["x1f"], bfc["x2f"], bfc["x3f"]
    div = (x1f[..., 1:] - x1f[..., :-1]) / dx1
    if x2f.shape[2] > 2:
        div = div + (x2f[:, :, 1:, :] - x2f[:, :, :-1, :]) / dx2
    if x3f.shape[1] > 2:
        div = div + (x3f[:, 1:, :, :] - x3f[:, :-1, :, :]) / dx3
    return div


def resolve(variable: str, phys, state, mesh
            ) -> Tuple[List[str], "jnp.ndarray"]:
    """Resolve an output variable name to (labels, device array
    [nmb, nvar, n3, n2, n1]).  Raises ValueError for unknown names."""
    u = state.get("u")
    w = state.get("w")
    bcc = state.get("bcc")
    ndim = 3 if mesh.mb_indcs.nx3 > 1 else (
        2 if mesh.mb_indcs.nx2 > 1 else 1)

    # strip the rad_ prefix: radiation-coupled runs expose the same
    # fluid fields (reference: rad_hydro_* / rad_mhd_* rows)
    name = variable
    if name.startswith("rad_hydro_") or name.startswith("rad_mhd_"):
        name = name[4:]

    for phys_name in ("hydro", "mhd"):
        pre = phys_name + "_"
        if not name.startswith(pre):
            continue
        key = name[len(pre):]
        nh = getattr(phys, "nhydro", getattr(phys, "nmhd", 5))
        base = {"u_d": (u, [IDN], ["dens"]),
                "u_m1": (u, [1], ["mom1"]),
                "u_m2": (u, [2], ["mom2"]),
                "u_m3": (u, [3], ["mom3"]),
                "u_e": (u, [IEN], ["ener"]),
                "u": (u, list(range(min(nh, 5))), _HYDRO_U[:nh]),
                "w_d": (w, [IDN], ["dens"]),
                "w_vx": (w, [IVX], ["velx"]),
                "w_vy": (w, [IVY], ["vely"]),
                "w_vz": (w, [IVZ], ["velz"]),
                "w_e": (w, [IEN], ["eint"]),
                "w": (w, list(range(min(nh, 5))), _HYDRO_W[:nh])}
        if key in base:
            arr, chans, labels = base[key]
            return labels, arr[:, chans]
        if key in ("u_s", "w_s"):
            ns = phys.nscalars
            if ns == 0:
                raise ValueError(f"{variable}: no scalars configured")
            arr = u if key == "u_s" else w
            return ([f"s{i:02d}" for i in range(ns)],
                    arr[:, phys.nvar - ns:phys.nvar])
        if key in ("bcc1", "bcc2", "bcc3"):
            i = int(key[-1]) - 1
            return [key], bcc[:, i:i + 1]
        if key == "bcc":
            return ["bcc1", "bcc2", "bcc3"], bcc
        if key in ("u_bcc", "w_bcc"):
            arr = u if key == "u_bcc" else w
            labels = (_HYDRO_U if key == "u_bcc" else _HYDRO_W)[:nh]
            return (labels + ["bcc1", "bcc2", "bcc3"],
                    jnp.concatenate([arr[:, :nh], bcc], axis=1))
        if key == "t":
            return ["temp"], state["T"][:, None]
        if key == "wz":
            _, _, c3 = _curl_cc(w[:, IVX], w[:, IVY], w[:, IVZ],
                                mesh, ndim)
            return ["vort_z"], c3[:, None]
        if key == "w2":
            c1, c2, c3 = _curl_cc(w[:, IVX], w[:, IVY], w[:, IVZ],
                                  mesh, ndim)
            return ["vort2"], (c1 * c1 + c2 * c2 + c3 * c3)[:, None]
        if key == "jz":
            _, _, c3 = _curl_cc(bcc[:, 0], bcc[:, 1], bcc[:, 2],
                                mesh, ndim)
            return ["curr_z"], c3[:, None]
        if key == "j2":
            c1, c2, c3 = _curl_cc(bcc[:, 0], bcc[:, 1], bcc[:, 2],
                                  mesh, ndim)
            return ["curr2"], (c1 * c1 + c2 * c2 + c3 * c3)[:, None]
        if key == "bmag":
            return ["bmag"], jnp.sqrt(
                bcc[:, 0] ** 2 + bcc[:, 1] ** 2 + bcc[:, 2] ** 2)[:, None]
        if key == "divb":
            return ["divb"], _divb_cc(state["bfc"], mesh)[:, None]
        if key in ("curv", "curv_alt", "k_jxb", "curv_perp"):
            return _mhd_curvature(key, bcc, mesh, ndim)
        if key == "jcon":
            return _mhd_jcon(phys, w, bcc, mesh, ndim)
        if key == "dynamo_ks":
            return _dynamo_ks(w, bcc, state["bfc"], mesh)
        if key == "sgs":
            return _sgs(phys_name, u, bcc)
        raise ValueError(f"output variable '{variable}' not implemented")

    if name.startswith("z4c"):
        z = state.get("z", state.get("u"))
        if name == "z4c":
            return list(_Z4C_LABELS), z[:, :len(_Z4C_LABELS)]
        i = _Z4C_LABELS.index(name)
        return [name], z[:, i:i + 1]

    if name.startswith("adm"):
        adm = _adm_fields(phys, state)
        fields = adm["g3d"] + adm["K_dd"] \
            + [adm["alpha"]] + adm["beta_u"]
        if name == "adm":
            return list(_ADM_LABELS), jnp.stack(fields, axis=1)
        if name == "adm_psi4":
            from ..z4c.z4c import spatial_det
            det = spatial_det(adm["g3d"])
            return ["adm_psi4"], (det ** (1.0 / 6.0))[:, None]
        i = _ADM_LABELS.index(name)
        return [name], fields[i][:, None]

    if name.startswith("con"):
        zmod = phys if not hasattr(phys, "z4c") else phys.z4c
        z = state.get("z", state.get("u"))
        if name == "con_H":
            H, _ = zmod.adm_constraints(z)
            return ["con_H"], H[:, None]
        if name == "con_M":
            _, M2 = zmod.adm_constraints(z)
            return ["con_M"], jnp.sqrt(M2)[:, None]
        con = zmod.adm_constraints(z, full=True)
        if name == "con_C":
            return ["con_C"], con["C"][:, None]
        if name == "con_Z":
            return ["con_Z"], con["Z"][:, None]
        if name in ("con_Mx", "con_My", "con_Mz"):
            a = {"con_Mx": 0, "con_My": 1, "con_Mz": 2}[name]
            return [name], con["M_d"][a][:, None]
        if name == "con":
            # full monitor set (reference: z4c.hpp:61-67 I_CON_* order)
            fields = [con["C"], con["H"], jnp.sqrt(con["M2"]),
                      con["Z"]] + list(con["M_d"])
            return (["con_C", "con_H", "con_M", "con_Z",
                     "con_Mx", "con_My", "con_Mz"],
                    jnp.stack(fields, axis=1))
        raise ValueError(f"constraint variable '{name}' not implemented "
                         "(available: con, con_C, con_H, con_M, con_Z, "
                         "con_Mx, con_My, con_Mz)")

    if name.startswith("weyl"):
        from ..z4c.weyl import weyl_scalars
        zmod = phys if not hasattr(phys, "z4c") else phys.z4c
        z = state.get("z", state.get("u"))
        rp, ip = weyl_scalars(zmod, z)
        if name == "weyl_rpsi4":
            return ["r_psi4"], rp[:, None]
        if name == "weyl_ipsi4":
            return ["i_psi4"], ip[:, None]
        return ["r_psi4", "i_psi4"], jnp.stack([rp, ip], axis=1)

    if name.startswith("tmunu"):
        adm = _adm_fields(phys, state)
        tm = phys.set_tmunu(state["u"], state["w"], state["bcc"], adm)
        fields = tm["S_dd"] + [tm["E"]] + tm["S_d"]
        if name == "tmunu":
            return list(_TMUNU_LABELS), jnp.stack(fields, axis=1)
        i = _TMUNU_LABELS.index(name)
        return [name], fields[i][:, None]

    if name in ("rad_coord", "rad_fluid", "rad_coord_fluid"):
        # radiation moments R^{munu}: coordinate and/or fluid frame
        # (reference: derived_variables.cpp:1076-1260)
        rad = phys.rad if hasattr(phys, "rad") else phys
        i0 = state["i0"] if "i0" in state else state["u"]
        parts, labels = [], []
        if name in ("rad_coord", "rad_coord_fluid"):
            lc, mc = rad.coord_moments({"u": i0})
            labels += lc
            parts.append(mc)
        if name in ("rad_fluid", "rad_coord_fluid"):
            if w is None:
                raise ValueError(f"{name}: fluid-frame moments need a "
                                 "coupled fluid (w)")
            lf, mf = rad.fluid_moments(i0, w)
            labels += lf
            parts.append(mf)
        return labels, (parts[0] if len(parts) == 1
                        else jnp.concatenate(parts, axis=1))

    if name == "turb_force":
        f = state["force"]
        return ["force1", "force2", "force3"], f

    if name == "grav_phi":
        phi = phys.pgrav.solve(state["u"], phys.bvals)
        return ["phi"], phi[:, None]

    if name == "prtcl_d":
        return ["prtcl_d"], _prtcl_density(phys, state, mesh)[:, None]

    raise ValueError(f"output variable '{variable}' unknown")


def _grad_cc(f, mesh, ndim):
    """Centered-difference gradient tuple (d/dx1, d/dx2, d/dx3) of a
    cell-centered field (valid in the interior)."""
    dx1 = np.asarray(mesh.mb_size["dx1"]).reshape(-1, 1, 1, 1)
    dx2 = np.asarray(mesh.mb_size["dx2"]).reshape(-1, 1, 1, 1)
    dx3 = np.asarray(mesh.mb_size["dx3"]).reshape(-1, 1, 1, 1)

    def d(ax, dx):
        return (jnp.roll(f, -1, axis=ax) - jnp.roll(f, 1, axis=ax)) \
            / (2.0 * dx)

    return (d(3, dx1),
            d(2, dx2) if ndim >= 2 else jnp.zeros_like(f),
            d(1, dx3) if ndim == 3 else jnp.zeros_like(f))


def _mhd_curvature(key, bcc, mesh, ndim):
    """Field-line curvature diagnostics (reference:
    derived_variables.cpp:208-359,781-900): curv = |(B.grad B)_perp|/B^2,
    curv_alt = |bhat.grad bhat|, k_jxb = |J x B|/B^2, curv_perp =
    |J x B / B^2 - bhat.grad bhat|."""
    bx, by, bz = bcc[:, 0], bcc[:, 1], bcc[:, 2]
    b2 = jnp.maximum(bx * bx + by * by + bz * bz, 1e-300)
    grads = [_grad_cc(c, mesh, ndim) for c in (bx, by, bz)]

    def bdotgrad(c):
        gx, gy, gz = grads[c]
        return bx * gx + by * gy + bz * gz

    if key == "curv":
        # (B.grad B) projected perpendicular to bhat, over B^2
        k = [bdotgrad(c) for c in range(3)]
        bdk = (bx * k[0] + by * k[1] + bz * k[2]) / b2
        p = [k[c] - bdk * (bx, by, bz)[c] for c in range(3)]
        val = jnp.sqrt(p[0] ** 2 + p[1] ** 2 + p[2] ** 2) / b2
        return ["curv"], val[:, None]

    bmag = jnp.sqrt(b2)
    ux, uy, uz = bx / bmag, by / bmag, bz / bmag
    ugrads = [_grad_cc(c, mesh, ndim) for c in (ux, uy, uz)]
    kappa = [ux * g[0] + uy * g[1] + uz * g[2] for g in ugrads]
    if key == "curv_alt":
        val = jnp.sqrt(kappa[0] ** 2 + kappa[1] ** 2 + kappa[2] ** 2)
        return ["curv_alt"], val[:, None]

    # current J = curl B (cell-centered)
    j1, j2, j3 = _curl_cc(bx, by, bz, mesh, ndim)
    jxb = ((j2 * bz - j3 * by) / b2,
           (j3 * bx - j1 * bz) / b2,
           (j1 * by - j2 * bx) / b2)
    if key == "k_jxb":
        val = jnp.sqrt(jxb[0] ** 2 + jxb[1] ** 2 + jxb[2] ** 2)
        return ["k_jxb"], val[:, None]
    # curv_perp
    val = jnp.sqrt(sum((jxb[c] - kappa[c]) ** 2 for c in range(3)))
    return ["curv_perp"], val[:, None]


def _dynamo_ks(w, bcc, bfc, mesh):
    """Dynamo wavenumber-scale moments (reference:
    derived_variables.cpp:945-1040 mhd_dynamo_ks): 8 channels of B/U
    magnitudes and gradient contractions whose volume averages give the
    characteristic wavenumbers of the field."""
    bx, by, bz = bcc[:, 0], bcc[:, 1], bcc[:, 2]
    b2 = bx * bx + by * by + bz * bz
    dx = np.asarray(mesh.mb_size["dx1"]).reshape(-1, 1, 1, 1)
    dx2_sq = dx * dx

    def dc(f, ax):  # un-normalized centered difference (reference form)
        return 0.5 * (jnp.roll(f, -1, axis=ax) - jnp.roll(f, 1, axis=ax))

    def df(face, ax):  # face difference across the cell
        sl = [slice(None)] * face.ndim
        sl[ax] = slice(1, None)
        hi = face[tuple(sl)]
        sl[ax] = slice(0, -1)
        lo = face[tuple(sl)]
        return hi - lo

    dbx = (df(bfc["x1f"], 3), dc(bx, 2), dc(bx, 1))
    dby = (dc(by, 3), df(bfc["x2f"], 2), dc(by, 1))
    dbz = (dc(bz, 3), dc(bz, 2), df(bfc["x3f"], 1))
    grad2 = sum(d ** 2 for trip in (dbx, dby, dbz) for d in trip) / dx2_sq
    bdb = [(bx * d[0] + by * d[1] + bz * d[2]) for d in (dbx, dby, dbz)]
    bdb2 = (bdb[0] ** 2 + bdb[1] ** 2 + bdb[2] ** 2) / dx2_sq
    jx = dc(bz, 2) - dc(by, 1)
    jy = dc(bx, 1) - dc(bz, 3)
    jz = dc(by, 3) - dc(bx, 2)
    bxj2 = ((by * jz - bz * jy) ** 2 + (bz * jx - bx * jz) ** 2
            + (bx * jy - by * jx) ** 2) / dx2_sq
    bdj2 = (bx * jx + by * jy + bz * jz) ** 2 / dx2_sq
    vx, vy, vz = w[:, IVX], w[:, IVY], w[:, IVZ]
    u2 = vx * vx + vy * vy + vz * vz
    du2 = sum(dc(v, ax) ** 2 for v in (vx, vy, vz)
              for ax in (3, 2, 1)) / dx2_sq
    labels = ["B2", "B4", "dB2", "BdB2", "BxJ2", "BdJ2", "U2", "dU2"]
    return labels, jnp.stack(
        [b2, b2 * b2, grad2, bdb2, bxj2, bdj2, u2, du2], axis=1)


def _sgs(phys_name, u, bcc):
    """Subgrid-scale analysis products (reference:
    derived_variables.cpp:528-700 mhd_sgs/hydro_sgs): state variables
    plus all quadratic/cubic flux products used to measure SGS terms —
    23 channels for hydro, 59 for MHD (same ordering)."""
    rho = u[:, IDN]
    mx, my, mz = u[:, 1], u[:, 2], u[:, 3]
    eint = u[:, IEN]
    chans = [rho, mx, my, mz, eint]
    labels = ["rho", "mx", "my", "mz", "eint"]
    if phys_name == "mhd":
        bx, by, bz = bcc[:, 0], bcc[:, 1], bcc[:, 2]
        chans += [bx, by, bz]
        labels += ["Bx", "By", "Bz"]
    ms = [mx, my, mz]
    mlab = ["x", "y", "z"]
    for a in range(3):
        for b in range(a, 3):
            chans.append(ms[a] * ms[b] / rho)
            labels.append(f"mv{mlab[a]}{mlab[b]}")
    if phys_name == "mhd":
        bs = [bx, by, bz]
        for a in range(3):
            for b in range(a, 3):
                chans.append(bs[a] * bs[b])
                labels.append(f"BB{mlab[a]}{mlab[b]}")
        for a in range(3):
            for b in range(3):
                chans.append(ms[a] * bs[b] / rho)
                labels.append(f"vB{mlab[a]}{mlab[b]}")
    for a in range(3):
        chans.append(ms[a] * eint / rho)
        labels.append(f"vT{mlab[a]}")
    for a in range(3):
        for b in range(3):
            chans.append(ms[a] * ms[b] * ms[b] / (rho * rho))
            labels.append(f"vvv{mlab[a]}{mlab[b]}")
    if phys_name == "mhd":
        for a in range(3):
            for b in range(3):
                chans.append(ms[a] * bs[b] * bs[b] / rho)
                labels.append(f"vBB{mlab[a]}{mlab[b]}")
        for a in range(3):
            for b in range(3):
                chans.append(ms[a] * bs[a] * bs[b] / rho)
                labels.append(f"vBiBj{mlab[a]}{mlab[b]}")
    return labels, jnp.stack(chans, axis=1)


def _build_eps4():
    import itertools
    eps = np.zeros((4, 4, 4, 4))
    for p in itertools.permutations(range(4)):
        s = 1
        for i in range(4):
            for j in range(i + 1, 4):
                if p[i] > p[j]:
                    s = -s
        eps[p] = s
    return eps


_EPS4 = _build_eps4()


def _ucov_bcov(w, bcc, gl, gu):
    """Covariant 4-velocity and 4-magnetic field from primitives
    (reference: ComputeUcBcFromPrimitive, derived_variables.cpp:36-70)."""
    uu = (w[:, IVX], w[:, IVY], w[:, IVZ])
    q = (gl[1][1] * uu[0] ** 2 + gl[2][2] * uu[1] ** 2
         + gl[3][3] * uu[2] ** 2
         + 2.0 * (gl[1][2] * uu[0] * uu[1] + gl[1][3] * uu[0] * uu[2]
                  + gl[2][3] * uu[1] * uu[2]))
    alp = jnp.sqrt(-1.0 / gu[0][0])
    lor = jnp.sqrt(1.0 + q)
    ucon = [lor / alp] + [uu[i] - alp * lor * gu[0][i + 1]
                          for i in range(3)]
    ucov = [sum(gl[m][n] * ucon[n] for n in range(4)) for m in range(4)]
    bb = (bcc[:, 0], bcc[:, 1], bcc[:, 2])
    b0 = sum(bb[i] * ucov[i + 1] for i in range(3))
    bcon = [b0] + [(bb[i] + b0 * ucon[i + 1]) / ucon[0]
                   for i in range(3)]
    bcov = [sum(gl[m][n] * bcon[n] for n in range(4)) for m in range(4)]
    return ucov, bcov


def _detg_fcon(mu, nu, ucov, bcov):
    """detg F^{mu nu} = -eps^{mu nu kap lam} u_kap b_lam
    (reference: utils/current.hpp get_detg_Fcon)."""
    out = 0.0
    for kap in range(4):
        for lam in range(4):
            s = _EPS4[mu, nu, kap, lam]
            if s:
                out = out - s * ucov[kap] * bcov[lam]
    return out


def _mhd_jcon(phys, w, bcc, mesh, ndim):
    """Contravariant 4-current j^mu = (1/(detg sqrt(4pi)))
    d_nu (detg F^{nu mu}) with a time-centered Faraday tensor
    (reference: derived_variables.cpp:364-527 'mhd_jcon').  Needs the
    previous cycle's (w, bcc, dt) saved by the driver
    (driver.save_wbcc); without a prior state returns zeros like the
    reference's have_prior=False branch."""
    if getattr(phys, "is_gr", False):
        gl, gu = phys.geom.metric("cc")
    else:
        z = jnp.zeros_like(w[:, 0])
        eta = [-1.0, 1.0, 1.0, 1.0]
        gl = [[(eta[i] + z) if i == j else z for j in range(4)]
              for i in range(4)]
        gu = gl
    prev = getattr(phys, "_jcon_prev", None)
    labels = ["j0", "j1", "j2", "j3"]
    if prev is None:
        zero = jnp.zeros_like(w[:, :1])
        return labels, jnp.concatenate([zero] * 4, axis=1)
    w_old, bcc_old, dt_last = prev

    uc_new, bc_new = _ucov_bcov(w, bcc, gl, gu)
    uc_old, bc_old = _ucov_bcov(w_old, bcc_old, gl, gu)
    w_mid = 0.5 * (w + w_old)
    b_mid = 0.5 * (bcc + bcc_old)

    dxs = [np.asarray(mesh.mb_size[f"dx{d}"]).reshape(-1, 1, 1, 1)
           for d in (1, 2, 3)]
    detg = jnp.sqrt(-1.0 / gu[0][0]) * jnp.sqrt(
        _det3(gl))  # alpha * sqrt(det g_ij) = sqrt(-g)

    axes = [3, 2, 1][:ndim]
    out = []
    for mu in range(4):
        j = (_detg_fcon(mu, 0, uc_new, bc_new)
             - _detg_fcon(mu, 0, uc_old, bc_old)) / dt_last
        for d, ax in enumerate(axes):
            # metric at the shifted cells: roll the time-centered
            # fields AND evaluate u,b there with the local metric
            glp = [[jnp.roll(gl[a][b], -1, axis=ax)
                    if hasattr(gl[a][b], "ndim") and gl[a][b].ndim >= 3
                    else gl[a][b] for b in range(4)] for a in range(4)]
            glm = [[jnp.roll(gl[a][b], 1, axis=ax)
                    if hasattr(gl[a][b], "ndim") and gl[a][b].ndim >= 3
                    else gl[a][b] for b in range(4)] for a in range(4)]
            gup = [[jnp.roll(gu[a][b], -1, axis=ax)
                    if hasattr(gu[a][b], "ndim") and gu[a][b].ndim >= 3
                    else gu[a][b] for b in range(4)] for a in range(4)]
            gum = [[jnp.roll(gu[a][b], 1, axis=ax)
                    if hasattr(gu[a][b], "ndim") and gu[a][b].ndim >= 3
                    else gu[a][b] for b in range(4)] for a in range(4)]
            wp = jnp.roll(w_mid, -1, axis=ax + 1)
            wm = jnp.roll(w_mid, 1, axis=ax + 1)
            bp = jnp.roll(b_mid, -1, axis=ax + 1)
            bm = jnp.roll(b_mid, 1, axis=ax + 1)
            ucp, bcp = _ucov_bcov(wp, bp, glp, gup)
            ucm, bcm = _ucov_bcov(wm, bm, glm, gum)
            j = j + (_detg_fcon(mu, d + 1, ucp, bcp)
                     - _detg_fcon(mu, d + 1, ucm, bcm)) / (2.0 * dxs[d])
        out.append(j / (detg * np.sqrt(4.0 * np.pi)))
    return labels, jnp.stack(out, axis=1)


def _det3(gl):
    """det of the spatial part of a 4x4 metric list."""
    a, b, c = gl[1][1], gl[1][2], gl[1][3]
    d, e = gl[2][2], gl[2][3]
    f = gl[3][3]
    return a * (d * f - e * e) - b * (b * f - e * c) \
        + c * (b * e - d * c)


def _prtcl_density(phys, state, mesh):
    """Particle number density deposited NGP onto cells (reference:
    'prtcl_d' row, outputs.hpp:151-152)."""
    mbi = mesh.mb_indcs
    x = state["prtcl_x"]
    ppart = phys.ppart
    gid = ppart.gids(x)
    ms = mesh.mesh_size
    mins = np.stack([np.asarray(mesh.mb_size["x1min"]),
                     np.asarray(mesh.mb_size["x2min"]),
                     np.asarray(mesh.mb_size["x3min"])], axis=1)
    dxs = np.array([ms.dx1, ms.dx2, ms.dx3])
    nx = np.array([mbi.nx1, max(mbi.nx2, 1), max(mbi.nx3, 1)])
    lo = jnp.take(jnp.asarray(mins), gid, axis=0)
    ijk = jnp.clip(((x - lo) / jnp.asarray(dxs)).astype(jnp.int32),
                   0, jnp.asarray(nx - 1))
    shape = (mesh.nmb_total, mbi.ncells3, mbi.ncells2, mbi.ncells1)
    off = np.array([mbi.is_, mbi.js if mbi.nx2 > 1 else 0,
                    mbi.ks if mbi.nx3 > 1 else 0])
    flat = ((gid * shape[1] + ijk[:, 2] + off[2]) * shape[2]
            + ijk[:, 1] + off[1]) * shape[3] + ijk[:, 0] + off[0]
    dens = jnp.zeros(int(np.prod(shape)),
                     dtype=x.dtype).at[flat].add(1.0)
    vol = float(ms.dx1) * (float(ms.dx2) if mbi.nx2 > 1 else 1.0) \
        * (float(ms.dx3) if mbi.nx3 > 1 else 1.0)
    return dens.reshape(shape) / vol


def _adm_fields(phys, state) -> Dict:
    """ADM fields for output: evolved Z4c, fixed background, or pure-Z4c
    conversion (reference: coordinates/adm.cpp)."""
    if hasattr(phys, "adm_of"):
        return phys.adm_of(state)
    from ..dyngr import adm_from_z4c
    return adm_from_z4c(phys, state.get("z", state["u"]))
