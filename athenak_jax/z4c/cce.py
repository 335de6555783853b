"""CCE shell dumps and horizon cube dumps for Z4c runs.

Parity targets:
  - CCE worldtube extraction for the PITTNull characteristic code
    (reference: src/z4c/cce/cce.{hpp,cpp}): ten metric/gauge fields
    (alpha, beta^i, g_ij) interpolated onto Gauss-Legendre spheres at
    Chebyshev-second-kind collocation radii in [rin, rout], decomposed
    in scalar spherical harmonics up to num_l_modes, written as one
    binary file per dump time.
  - Horizon cube dumps for Einstein-Toolkit style post-processing
    (reference: src/z4c/horizon_dump.cpp): sixteen fields (alpha,
    beta^i, g_ij, K_ij) trilinearly interpolated onto an Nx^3 Cartesian
    cube centered on a compact-object tracker, written with an ETK
    parameter file for AHFinderDirect/QuasiLocalMeasures.

Note: both are host-side analysis paths (one device->host fetch of
the Z4c state per dump time); the heavy decomposition is a dense
[nangles] x [nlm] matmul done once per shell in numpy.
"""

from __future__ import annotations

import math
import os

import numpy as np

from .ahf import interp_fields
from .z4c import (I_ALPHA, I_BETAX, I_BETAY, I_BETAZ)


# --------------------------------------------------------------- quadrature
def chebyshev2_points(xmin: float, xmax: float, N: int) -> np.ndarray:
    """Collocation points of the Chebyshev polynomial of the second kind
    mapped to [xmin, xmax] (reference: utils/chebyshev.hpp:16-21)."""
    k = np.arange(N)
    xk = np.cos(math.pi * (k + 1) / (N + 2))
    return 0.5 * ((xmin - xmax) * xk + (xmin + xmax))


def gauss_legendre_sphere(ntheta: int):
    """Gauss-Legendre sphere: ntheta GL nodes in cos(theta) x 2*ntheta
    equally spaced phi (reference: geodesic-grid/gauss_legendre.cpp:26-75).

    Returns (theta[nangles], phi[nangles], weights[nangles]) with the
    same point ordering as the reference (theta fastest) and weights
    that integrate over the unit sphere (sum = 4 pi)."""
    roots, wgl = np.polynomial.legendre.leggauss(ntheta)
    nangles = 2 * ntheta * ntheta
    n = np.arange(nangles)
    theta = np.arccos(roots[n % ntheta])
    phi = 2.0 * math.pi / (2 * ntheta) * (n // ntheta)
    weights = wgl[n % ntheta] * math.pi / ntheta
    return theta, phi, weights


def ylm_scalar(l: int, m: int, theta, phi):
    """Scalar (spin-0) spherical harmonic via the Wigner-d sum,
    vectorized over points; matches the reference convention
    (reference: utils/spherical_harm.hpp SWSphericalHarm with s=0).
    Returns (Re, Im)."""
    theta = np.asarray(theta, dtype=np.float64)
    cth = np.cos(theta / 2.0)
    sth = np.sin(theta / 2.0)
    fac = math.factorial
    d = np.zeros_like(theta)
    for k in range(max(0, m), min(l + m, l) + 1):
        d = d + ((-1.0) ** k
                 * cth ** (2 * l + m - 2 * k) * sth ** (2 * k - m)
                 / (fac(l + m - k) * fac(l - k) * fac(k) * fac(k - m)))
    d = d * (math.sqrt((2 * l + 1) / (4.0 * math.pi))
             * fac(l) * math.sqrt(fac(l + m)) * math.sqrt(fac(l - m)))
    return d * np.cos(m * np.asarray(phi)), d * np.sin(m * np.asarray(phi))


# ---------------------------------------------------------------------- CCE
class CCE:
    """One CCE worldtube: shells between rin_<index> and rout_<index>.

    Deck parameters follow the reference <cce> block
    (reference: cce.cpp:40-74): rin_N/rout_N per worldtube,
    num_l_modes (default 16), num_radial_modes (default 7), cce_dt.
    """

    NVARS = 10  # alpha, beta^i, g_ij

    def __init__(self, pin, mesh, index: int) -> None:
        self.index = index
        self.rin = pin.get_or_add_real("cce", f"rin_{index}", 20.0)
        self.rout = pin.get_or_add_real("cce", f"rout_{index}", 40.0)
        self.num_l_modes = pin.get_or_add_integer("cce", "num_l_modes", 16)
        self.nr = pin.get_or_add_integer("cce", "num_radial_modes", 7)
        self.num_angular_modes = (self.num_l_modes + 1) ** 2
        ntheta = self.num_l_modes + 1

        theta, phi, w = gauss_legendre_sphere(ntheta)
        self.radii = chebyshev2_points(self.rin, self.rout, self.nr)
        # cartesian sample points per shell [nr][nangles, 3]
        sin_t = np.sin(theta)
        unit = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi),
                         np.cos(theta)], axis=1)
        self.points = [r * unit for r in self.radii]
        # weighted Ylm projection matrices [nlm, nangles]
        yr = np.empty((self.num_angular_modes, len(theta)))
        yi = np.empty_like(yr)
        for l in range(self.num_l_modes + 1):
            for m in range(-l, l + 1):
                re, im = ylm_scalar(l, m, theta, phi)
                yr[l * l + l + m] = re * w
                yi[l * l + l + m] = im * w
        self._proj_r = yr
        self._proj_i = yi

    def decompose(self, mesh, fields):
        """Interpolate the ten fields to every shell and project on Ylm.

        ``fields``: list of NVARS block arrays [nmb, n3, n2, n1].
        Returns (data_real, data_imag), each [nr * NVARS * nlm] in the
        reference's flattened ordering (radius, variable, l*l+l+m)
        (reference: cce.cpp:95-128)."""
        nlm = self.num_angular_modes
        data_r = np.empty(self.nr * self.NVARS * nlm)
        data_i = np.empty_like(data_r)
        for k in range(self.nr):
            vals = interp_fields(mesh, fields, self.points[k])
            cr = vals @ self._proj_r.T   # [NVARS, nlm]
            ci = vals @ self._proj_i.T
            base = k * self.NVARS * nlm
            for nv in range(self.NVARS):
                data_r[base + nv * nlm:base + (nv + 1) * nlm] = cr[nv]
                data_i[base + nv * nlm:base + (nv + 1) * nlm] = ci[nv]
        return data_r, data_i

    def dump(self, mesh, z4c_mod, z, outdir: str = "cce") -> str:
        """Write cce/cce_<time>.bin (reference format, cce.cpp:143-177:
        int32 nr, int32 num_l_modes, f64 time, f64 rin, f64 rout,
        f64 data_real[count], f64 data_imag[count])."""
        fields = cce_fields(z4c_mod, z)
        data_r, data_i = self.decompose(mesh, fields)
        os.makedirs(outdir, exist_ok=True)
        tstr = f"{mesh.time:g}".zfill(8)
        fname = os.path.join(outdir, f"cce_{tstr}.bin")
        with open(fname, "wb") as f:
            np.asarray([self.nr, self.num_l_modes],
                       dtype=np.int32).tofile(f)
            np.asarray([mesh.time, self.rin, self.rout],
                       dtype=np.float64).tofile(f)
            data_r.astype(np.float64).tofile(f)
            data_i.astype(np.float64).tofile(f)
        return fname


def cce_fields(z4c_mod, z):
    """The ten CCE fields as numpy block arrays: alpha, beta^i from the
    evolved state; ADM g_ij reconstructed from the conformal variables
    (reference: cce.cpp:64-73 variable_to_dump)."""
    import jax.numpy as jnp

    from ..dyngr import adm_from_z4c

    zn = np.asarray(z)
    adm = adm_from_z4c(z4c_mod, jnp.asarray(z))
    g3d = [np.asarray(c) for c in adm["g3d"]]
    return [zn[:, I_ALPHA], zn[:, I_BETAX], zn[:, I_BETAY],
            zn[:, I_BETAZ]] + g3d


def read_cce(fname: str):
    """Reader for the CCE dump format (round-trip test + user tooling)."""
    with open(fname, "rb") as f:
        nr, num_l = np.fromfile(f, dtype=np.int32, count=2)
        time, rin, rout = np.fromfile(f, dtype=np.float64, count=3)
        nlm = (int(num_l) + 1) ** 2
        count = int(nr) * CCE.NVARS * nlm
        data_r = np.fromfile(f, dtype=np.float64, count=count)
        data_i = np.fromfile(f, dtype=np.float64, count=count)
    shape = (int(nr), CCE.NVARS, nlm)
    return {"nr": int(nr), "num_l_modes": int(num_l), "time": float(time),
            "rin": float(rin), "rout": float(rout),
            "real": data_r.reshape(shape), "imag": data_i.reshape(shape)}


# ------------------------------------------------------------- horizon dump
class HorizonDump:
    """Nx^3 Cartesian cube dump of (alpha, beta^i, g_ij, K_ij) around a
    compact-object tracker (reference: horizon_dump.cpp:35-156).

    Deck parameters (reference names): <z4c> dump_horizon_N = true,
    co_N_dump_radius, horizon_N_Nx, horizon_dt, horizonNr_guess.
    """

    NVARS = 16

    def __init__(self, pin, mesh, n: int, common: int = 0) -> None:
        self.horizon_ind = n
        self.common_horizon = common
        self.pos = np.array([pin.get_or_add_real("z4c", f"co_{n}_x", 0.0),
                             pin.get_or_add_real("z4c", f"co_{n}_y", 0.0),
                             pin.get_or_add_real("z4c", f"co_{n}_z", 0.0)])
        self.extent = pin.get_or_add_real("z4c", f"co_{n}_dump_radius", 2.0)
        self.nx = pin.get_or_add_integer("z4c", f"horizon_{n}_Nx", 10)
        self.horizon_dt = pin.get_or_add_real("z4c", "horizon_dt", 1.0)
        self.r_guess = pin.get_or_add_real("z4c", f"horizon{n}r_guess", 0.5)
        self.output_count = 0

    def _cube_points(self, center):
        ax = np.linspace(-self.extent, self.extent, self.nx)
        # ordering matches the reference buffer: x slowest, z fastest
        # (horizon_dump.cpp:106-114)
        X, Y, Z = np.meshgrid(ax + center[0], ax + center[1],
                              ax + center[2], indexing="ij")
        return np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def dump(self, mesh, z4c_mod, z, center=None, outdir: str = ".") -> str:
        """Interpolate the 16 fields to the cube and write
        horizon_<n>/output_<count>/etk_output_file.dat
        (int32 common_horizon, f64 time, f64 data[16*Nx^3]) plus the
        Einstein-Toolkit parameter file."""
        import jax.numpy as jnp

        from ..dyngr import adm_from_z4c

        if center is not None:
            self.pos = np.asarray(center, dtype=np.float64)
        zn = np.asarray(z)
        adm = adm_from_z4c(z4c_mod, jnp.asarray(z))
        fields = ([zn[:, I_ALPHA], zn[:, I_BETAX], zn[:, I_BETAY],
                   zn[:, I_BETAZ]]
                  + [np.asarray(c) for c in adm["g3d"]]
                  + [np.asarray(c) for c in adm["K_dd"]])
        vals = interp_fields(mesh, fields, self._cube_points(self.pos))

        folder = os.path.join(
            outdir, f"horizon_{self.horizon_ind}",
            f"output_{self.output_count}")
        os.makedirs(folder, exist_ok=True)
        fname = os.path.join(folder, "etk_output_file.dat")
        with open(fname, "wb") as f:
            np.asarray([self.common_horizon], dtype=np.int32).tofile(f)
            np.asarray([mesh.time], dtype=np.float64).tofile(f)
            vals.astype(np.float64).tofile(f)
        self._write_etk_parfile(folder)
        self.output_count += 1
        return fname

    def _write_etk_parfile(self, folder: str) -> None:
        """Einstein-Toolkit driver parameter file consumed by the
        readBHaHdata/AHFinderDirect analysis pipeline (condensed from
        the reference template, horizon_dump.cpp:158-283)."""
        n = self.horizon_ind
        lines = [
            'ActiveThorns = "PUGH SymBase CartGrid3D"',
            "cactus::cctk_itlast = 0",
            'cactus::cctk_show_schedule = "no"',
            'cactus::cctk_show_banners  = "no"',
            "Driver::ghost_size = 0",
            f"Driver::global_nsize = {self.nx}",
            "Driver::info = load",
            "grid::type = byrange",
            f"grid::xmin = {-self.extent:e}",
            f"grid::xmax = {self.extent:e}",
            f"grid::ymin = {-self.extent:e}",
            f"grid::ymax = {self.extent:e}",
            f"grid::zmin = {-self.extent:e}",
            f"grid::zmax = {self.extent:e}",
            "ActiveThorns = ADMBase",
            'ActiveThorns = "AHFinderDirect SphericalSurface SpaceMask'
            ' StaticConformal IOUtil AEILocalInterp PUGHInterp PUGHReduce'
            ' QuasiLocalMeasures IOBasic TmunuBase LocalReduce"',
            'ActiveThorns = "readBHaHdata"',
            'ADMBase::metric_type = "physical"',
            "AHFinderDirect::find_every = 1",
            'AHFinderDirect::geometry_interpolator_name ='
            ' "Hermite polynomial interpolation"',
            'AHFinderDirect::geometry_interpolator_pars = "order=3"',
            "AHFinderDirect::max_Newton_iterations__initial = 100",
            "AHFinderDirect::max_Newton_iterations__subsequent = 10",
            "AHFinderDirect::N_horizons = 1",
            'AHFinderDirect::output_BH_diagnostics = "yes"',
            'AHFinderDirect::reset_horizon_after_not_finding[1] = "no"',
            'AHFinderDirect::set_mask_for_individual_horizon[1] = "no"',
            'AHFinderDirect::surface_interpolator_name ='
            ' "Hermite polynomial interpolation"',
            'AHFinderDirect::surface_interpolator_pars = "order=3"',
            'AHFinderDirect::verbose_level = "physics details"',
            "AHFinderDirect::which_surface_to_store_info[1] = 0",
            "AHFinderDirect::run_at_CCTK_POSTSTEP = false",
            "AHFinderDirect::run_at_CCTK_ANALYSIS = true",
            'QuasiLocalMeasures::interpolator ='
            ' "Hermite polynomial interpolation"',
            'QuasiLocalMeasures::interpolator_options = "order=3"',
            "QuasiLocalMeasures::killing_vector_method = axial",
            "QuasiLocalMeasures::num_surfaces = 1",
            "QuasiLocalMeasures::spatial_order = 2",
            "QuasiLocalMeasures::surface_index[0] = 0",
            "QuasiLocalMeasures::verbose = yes",
            "SphericalSurface::nsurfaces = 1",
            "SphericalSurface::maxntheta = 161",
            "SphericalSurface::maxnphi = 324",
            "SphericalSurface::ntheta      [0] = 161",
            "SphericalSurface::nphi        [0] = 324",
            "SphericalSurface::nghoststheta[0] = 2",
            "SphericalSurface::nghostsphi  [0] = 2",
            "IOBasic::outInfo_every = 1",
            'IOBasic::outInfo_vars = "',
            "        QuasiLocalMeasures::qlm_scalars",
            "        QuasiLocalMeasures::qlm_spin[0]",
            "        QuasiLocalMeasures::qlm_radius[0]",
            "        QuasiLocalMeasures::qlm_mass[0]",
            '        QuasiLocalMeasures::qlm_3det[0] "',
            f'IOUtil::out_dir = "AHET_out_horizon_BH_{n}_ahf_ihf_diags"',
            f'readBHaHdata::outfilename = "horizon_BH_{n}_ahf_ihf_diags.txt"',
            'readBHaHdata::recent_ah_radius_max_filename ='
            f' "ah_radius_max_BH_{n}.txt"',
            'AHFinderDirect::initial_guess_method[1] = "coordinate sphere"',
            "AHFinderDirect::initial_guess__coord_sphere__radius[1] ="
            f" {self.r_guess:e}",
        ]
        with open(os.path.join(folder,
                               "ET_analyze_BHaH_data_horizon.par"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")


def read_horizon_dump(fname: str, nx: int):
    """Reader for the horizon cube dump (round-trip test)."""
    with open(fname, "rb") as f:
        common = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        time = float(np.fromfile(f, dtype=np.float64, count=1)[0])
        data = np.fromfile(f, dtype=np.float64,
                           count=HorizonDump.NVARS * nx ** 3)
    return {"common_horizon": common, "time": time,
            "data": data.reshape(HorizonDump.NVARS, nx, nx, nx)}
