"""External initial-data importers: gridded ADM / BNS data -> state.

Parity target: the reference's external-solver problem generators —
SpECTRE BBH volume data (reference: src/pgen/z4c/spectre/
z4c_spectre_bbh.cpp, which links the SpECTRE Exporter to interpolate
lapse/shift/spatial metric/K onto the grid then calls ADMToZ4c) and the
LORENE/SGRID/Elliptica BNS importers (src/pgen/dyn_grmhd/lorene/
lorene_bns.cpp etc., which interpolate (rho, p, v^i, ADM)).

Replacement: the external solvers' libraries are not
linkable here, so both pgens read a *resampled volume file* — the
standard export step every one of those pipelines already performs —
and do the interpolation + ADM->Z4c conversion natively:

  file format (.npz, or .h5 with the same dataset names):
    x, y, z                      1-D coordinate arrays
    g_xx g_xy g_xz g_yy g_yz g_zz   [nz, ny, nx] spatial metric
    K_xx K_xy K_xz K_yy K_yz K_zz   [nz, ny, nx] extrinsic curvature
    alpha                        [nz, ny, nx] lapse (optional)
    beta_x beta_y beta_z         [nz, ny, nx] shift (optional)
  and for BNS (dyngr) additionally:
    rho, press                   [nz, ny, nx] rest-mass density, pressure
    vel_x vel_y vel_z            [nz, ny, nx] Eulerian velocity u^i_(n)

Registry names: ``z4c_adm_import`` and ``dyngr_bns_import``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..z4c.adm_ic import adm_to_z4c

_SYM = ["xx", "xy", "xz", "yy", "yz", "zz"]


def _load(fname: str):
    """Dict of numpy arrays from .npz or .h5."""
    if fname.endswith((".h5", ".hdf5")):
        import h5py
        out = {}
        with h5py.File(fname, "r") as f:
            def walk(name, obj):
                if isinstance(obj, h5py.Dataset):
                    out[name.split("/")[-1]] = np.asarray(obj)
            f.visititems(walk)
        return out
    return dict(np.load(fname))


def _trilerp(data, xs, ys, zs, X, Y, Z):
    """Trilinear sample of data [nz, ny, nx] at points X, Y, Z
    (broadcastable arrays); clamps to the donor-grid hull."""
    def frac(v, grid):
        f = (v - grid[0]) / (grid[1] - grid[0])
        f = np.clip(f, 0.0, len(grid) - 1.0 - 1e-12)
        i = np.floor(f).astype(np.int64)
        return i, f - i

    ix, fx = frac(X, xs)
    iy, fy = frac(Y, ys)
    iz, fz = frac(Z, zs)
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                wgt = ((fz if dz else 1 - fz) * (fy if dy else 1 - fy)
                       * (fx if dx else 1 - fx))
                out = out + wgt * data[iz + dz, iy + dy, ix + dx]
    return out


def _sample_fields(fname, mesh, names, optional=()):
    """Interpolate the named donor fields to every block's cell centers
    (ghosts included).  Returns dict name -> [nmb, n3, n2, n1]."""
    raw = _load(fname)
    for c in ("x", "y", "z"):
        if c not in raw:
            raise ValueError(f"import file {fname} lacks coordinate '{c}'")
    xs, ys, zs = (np.asarray(raw[c], dtype=np.float64)
                  for c in ("x", "y", "z"))
    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    shp = (nmb, mbi.ncells3, mbi.ncells2, mbi.ncells1)
    out = {}
    for name in names:
        if name not in raw:
            if name in optional:
                continue
            raise ValueError(f"import file {fname} lacks field '{name}'")
        out[name] = np.empty(shp)
    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        X = np.broadcast_to(x1v[None, None, :], shp[1:])
        Y = np.broadcast_to(x2v[None, :, None], shp[1:])
        Z = np.broadcast_to(x3v[:, None, None], shp[1:])
        for name in out:
            out[name][gid] = _trilerp(
                np.asarray(raw[name], dtype=np.float64), xs, ys, zs,
                X, Y, Z)
    return out


def _adm_arrays(f, mesh):
    nmb = mesh.nmb_total
    mbi = mesh.mb_indcs
    shp = (nmb, mbi.ncells3, mbi.ncells2, mbi.ncells1)
    g_dd = np.stack([f[f"g_{s}"] for s in _SYM], axis=1)
    K_dd = np.stack([f[f"K_{s}"] for s in _SYM], axis=1)
    alpha = f.get("alpha")
    beta = None
    if "beta_x" in f:
        beta = np.stack([f[f"beta_{c}"] for c in "xyz"], axis=1)
    else:
        beta = np.zeros((nmb, 3) + shp[1:])
    return g_dd, K_dd, alpha, beta


def init(pin, mesh, phys):
    """Dispatch on pgen_name: z4c_adm_import / dyngr_bns_import."""
    if pin.get_string("problem", "pgen_name") == "dyngr_bns_import":
        return init_bns(pin, mesh, phys)
    return init_adm(pin, mesh, phys)


def init_adm(pin, mesh, phys):
    """z4c_adm_import: gridded ADM data -> Z4c state."""
    fname = pin.get_string("problem", "id_filename")
    names = [f"g_{s}" for s in _SYM] + [f"K_{s}" for s in _SYM] \
        + ["alpha", "beta_x", "beta_y", "beta_z"]
    f = _sample_fields(fname, mesh, names,
                       optional=("alpha", "beta_x", "beta_y", "beta_z"))
    g_dd, K_dd, alpha, beta = _adm_arrays(f, mesh)
    u = adm_to_z4c(mesh, g_dd, K_dd, alpha=alpha, beta_u=beta,
                   chi_psi_power=phys.opt.chi_psi_power)
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    return phys.make_state(jnp.asarray(u, dtype=dtype))


def init_bns(pin, mesh, phys):
    """dyngr_bns_import: gridded (fluid + ADM) data -> DynGRMHD state."""
    fname = pin.get_string("problem", "id_filename")
    d_atm = pin.get_or_add_real("mhd", "dfloor", 1e-12)
    p_atm = pin.get_or_add_real("mhd", "pfloor", 1e-15)
    names = ([f"g_{s}" for s in _SYM] + [f"K_{s}" for s in _SYM]
             + ["alpha", "beta_x", "beta_y", "beta_z",
                "rho", "press", "vel_x", "vel_y", "vel_z"])
    f = _sample_fields(fname, mesh, names,
                       optional=("alpha", "beta_x", "beta_y", "beta_z",
                                 "vel_x", "vel_y", "vel_z"))
    g_dd, K_dd, alpha, beta = _adm_arrays(f, mesh)

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    shp = (nmb, mbi.ncells3, mbi.ncells2, mbi.ncells1)
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    w = np.zeros((nmb, 5) + shp[1:])
    w[:, 0] = np.maximum(f["rho"], d_atm)
    w[:, 4] = np.maximum(f["press"], p_atm)
    # Eulerian velocity -> the code's projected 4-velocity u^i_(n)
    # (LORENE exports u_euler; the reference multiplies by the Lorentz
    # factor W computed from g_ij v^i v^j, lorene_bns.cpp)
    if "vel_x" in f:
        v = [f["vel_x"], f["vel_y"], f["vel_z"]]
        v2 = 0.0
        for a in range(3):
            for b in range(3):
                s = _SYM.index("".join(sorted(("xyz"[a], "xyz"[b]))))
                v2 = v2 + g_dd[:, s] * v[a] * v[b]
        v2 = np.clip(v2, 0.0, 1.0 - 1e-12)
        W = 1.0 / np.sqrt(1.0 - v2)
        for a in range(3):
            w[:, 1 + a] = W * v[a]
    wj = jnp.asarray(w, dtype=dtype)

    bfc = {k: jnp.zeros(s, dtype=dtype)
           for k, s in phys.fc_shapes.items()}
    bcc = phys.compute_bcc(bfc)

    g3d = [g_dd[:, s] for s in range(6)]
    Kdd = [K_dd[:, s] for s in range(6)]
    if alpha is None:
        detg = (g3d[0] * (g3d[3] * g3d[5] - g3d[4] ** 2)
                - g3d[1] * (g3d[1] * g3d[5] - g3d[4] * g3d[2])
                + g3d[2] * (g3d[1] * g3d[4] - g3d[3] * g3d[2]))
        alpha = detg ** (-1.0 / 6.0)
    if phys.fixed_evolution:
        phys.set_fixed_adm(g3d, alpha, [beta[:, a] for a in range(3)],
                           K_dd=Kdd)
        adm = phys.adm_of({})
        z = None
    else:
        zst = adm_to_z4c(mesh, g_dd, K_dd, alpha=alpha, beta_u=beta,
                         chi_psi_power=phys.z4c.opt.chi_psi_power)
        z = jnp.asarray(zst, dtype=dtype)
        adm = {"g3d": [jnp.asarray(c, dtype=dtype) for c in g3d],
               "alpha": jnp.asarray(alpha, dtype=dtype),
               "beta_u": [jnp.asarray(beta[:, a], dtype=dtype)
                          for a in range(3)],
               "K_dd": [jnp.asarray(c, dtype=dtype) for c in Kdd]}

    n = wj[:, 0] / phys.ps.mb
    T = phys.policy.temperature_from_p(jnp.maximum(n, phys.ps.n_atm),
                                       wj[:, 4])
    u = phys.prim_to_cons_state(wj, T, bcc, adm)
    return phys.make_state(u, wj, bfc, T=T, z=z)
