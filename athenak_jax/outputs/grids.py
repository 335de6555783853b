"""Derived-grid and statistics outputs: cbin, pdf, cartgrid, sphsurf.

Parity targets:
  - CoarsenedBinaryOutput: reference src/outputs/coarsened_binary.cpp
    (preheader with "number of moments"/"coarsening factor" lines,
    float32 payload of factor^3 block means, optionally the first four
    raw moments), byte-readable by vis/python/bin_convert.py
    read_coarsened_binary (tested).
  - PDFOutput: reference src/outputs/pdf.cpp (1D/2D volume- or
    mass-weighted histograms with under/overflow bins, linear or log10
    spacing, bins file + per-dump tables).
  - CartesianGridOutput: reference src/outputs/cartgrid.cpp +
    src/utils/cart_grid.cpp (trilinear resample onto a uniform or
    Chebyshev-spaced box, packed-struct binary format).
  - SphericalSurfaceOutput: reference src/outputs/spherical_surface.cpp
    + src/utils/spherical_surface.cpp (uniform-mu x uniform-phi sphere
    set, legacy-VTK STRUCTURED_GRID file with weights + variables).

All four interpolate/reduce from the Z-ordered block arrays on the host
after a single device->host transfer of the resolved variable family
(the transfer is the cost that matters; the reductions are tiny).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..indices import IDN
from . import BaseOutput, BinaryOutput


def _resolve_host(out, mesh, u, w, bcc, state, variable):
    """Resolve an output variable family to (labels, host float64 array
    [nmb, nvar, n3, n2, n1]) including ghosts (interpolation needs them)."""
    try:
        from .variables import resolve
        st = state if state is not None else {"u": u, "w": w, "bcc": bcc}
        labels, dev = resolve(variable, out.phys, st, mesh)
        return labels, np.asarray(dev, dtype=np.float64)
    except ValueError:
        kind, labels = BinaryOutput._VARIABLES.get(
            variable, ("w", ["dens", "velx", "vely", "velz", "eint"]))
        if kind in ("u", "w"):
            dev = u if kind == "u" else w
            arr = np.asarray(dev, dtype=np.float64)
            nvar = min(arr.shape[1], 5)
            return labels[:nvar], arr[:, :nvar]
        base = np.asarray(u if kind == "u_bcc" else w, dtype=np.float64)
        return labels, np.concatenate(
            [base[:, :5], np.asarray(bcc, dtype=np.float64)], axis=1)


class CoarsenedBinaryOutput(BinaryOutput):
    """Coarsened binary dumps ('cbin').

    Reference: src/outputs/coarsened_binary.cpp:149-470 — per-variable
    factor^3 block means (plus raw 2nd/3rd/4th moments when
    compute_moments=true, labelled var_1st..var_4th), written in the
    v1.1 binary layout with a 7-line preheader carrying "number of
    moments" and "coarsening factor".  Files go to
    cbin_{variable}_{factor}/{basename}.{variable}.NNNNN.cbin and are
    read back by the reference's bin_convert.read_coarsened_binary.
    """

    def __init__(self, pin, mesh, phys, block: str) -> None:
        super().__init__(pin, mesh, phys, block)
        self.factor = pin.get_or_add_integer(block, "coarsen_factor", 2)
        self.moments = pin.get_or_add_boolean(block, "compute_moments",
                                              False)
        mbi = mesh.mb_indcs
        for n, lab in ((mbi.nx1, "nx1"), (mbi.nx2, "nx2"),
                       (mbi.nx3, "nx3")):
            if n > 1 and n % self.factor != 0:
                raise ValueError(
                    f"meshblock/{lab}={n} not divisible by "
                    f"coarsen_factor={self.factor}")

    def write(self, mesh, u, w, bcc=None, state=None) -> None:
        p = self.params
        mbi = mesh.mb_indcs
        labels, arr = _resolve_host(self, mesh, u, w, bcc, state,
                                    p.variable)
        arr = arr[:, :, mbi.ks:mbi.ke + 1, mbi.js:mbi.je + 1,
                  mbi.is_:mbi.ie + 1]
        F = self.factor
        nmb, nvar, n3, n2, n1 = arr.shape
        f3 = F if n3 > 1 else 1
        f2 = F if n2 > 1 else 1
        c3, c2, c1 = n3 // f3, n2 // f2, n1 // F
        blocks = arr.reshape(nmb, nvar, c3, f3, c2, f2, c1, F)
        # reference normalizes every moment by coarsen_factor^3 (the
        # full cube count) regardless of collapsed dimensions
        norm = F ** 3 / (f3 * f2 * F)
        powers = [1, 2, 3, 4] if self.moments else [1]
        moms = [blocks.__pow__(q).mean(axis=(3, 5, 7)) / norm
                for q in powers]
        # interleave moments per variable: v0_1st v0_2nd ... v1_1st ...
        out = np.stack(moms, axis=2).reshape(nmb, nvar * len(powers),
                                             c3, c2, c1)
        if self.moments:
            sfx = ["_1st", "_2nd", "_3rd", "_4th"]
            labels = [lab + s for lab in labels for s in sfx]
        nout = out.shape[1]

        base_dir = os.path.dirname(self.basename) or "."
        dname = os.path.join(base_dir, f"cbin_{p.variable}_{F}")
        os.makedirs(dname, exist_ok=True)
        fname = os.path.join(
            dname, os.path.basename(self.basename)
            + f".{p.variable}.{p.file_number:05d}.cbin")
        header_bytes = self.pin.dump().encode()

        with open(fname, "wb") as f:
            f.write(b"Athena binary output version=1.1\n")
            f.write(b"  size of preheader=7\n")
            f.write(f"  time={mesh.time:.16e}\n".encode())
            f.write(f"  cycle={mesh.ncycle}\n".encode())
            f.write(f"  number of moments={len(powers)}\n".encode())
            f.write(f"  coarsening factor={F}\n".encode())
            f.write(b"  size of location=8\n")
            f.write(b"  size of variable=4\n")
            f.write(f"  number of variables={nout}\n".encode())
            f.write(("  variables:  " + "  ".join(labels)
                     + "\n").encode())
            f.write(f"  header offset={len(header_bytes)}\n".encode())
            f.write(header_bytes)

            for gid in range(mesh.nmb_total):
                idx = np.array(
                    [mbi.is_, mbi.is_ + c1 - 1, mbi.js, mbi.js + c2 - 1,
                     mbi.ks, mbi.ks + c3 - 1], dtype=np.int32)
                f.write(idx.tobytes())
                loc = mesh.lloc_eachmb[gid]
                level = int(mesh.mb_lev[gid]) \
                    if hasattr(mesh, "mb_lev") else 0
                f.write(np.array([loc[0], loc[1], loc[2], level],
                                 dtype=np.int32).tobytes())
                geom = np.array(
                    [mesh.mb_size["x1min"][gid],
                     mesh.mb_size["x1max"][gid],
                     mesh.mb_size["x2min"][gid],
                     mesh.mb_size["x2max"][gid],
                     mesh.mb_size["x3min"][gid],
                     mesh.mb_size["x3max"][gid]], dtype=np.float64)
                f.write(geom.tobytes())
                f.write(np.ascontiguousarray(out[gid],
                                             dtype=np.float32).tobytes())


class PDFOutput(BaseOutput):
    """1D/2D probability-distribution histograms ('pdf').

    Reference: src/outputs/pdf.cpp — nbin(+2 outlier) bins over
    [bin_min, bin_max] (log10-spaced by default), optionally a second
    variable (variable_2/nbin2/bin2_*) for a joint pdf, weighted by cell
    volume or by mass (mass_weighted=true).  Writes a one-off
    {basename}.bins.pdf edge table and per-dump
    {basename}.NNNNN.pdf matrices into pdf_{variable}[_{variable_2}]/.
    """

    def __init__(self, pin, mesh, phys, block: str) -> None:
        super().__init__(pin, mesh, phys, block)
        p = self.params
        self.bin_min = pin.get_real(block, "bin_min")
        self.bin_max = pin.get_real(block, "bin_max")
        self.nbin = pin.get_integer(block, "nbin")
        self.logscale = pin.get_or_add_boolean(block, "logscale", True)
        self.mass_weighted = pin.get_or_add_boolean(
            block, "mass_weighted", False)
        self.var2 = None
        if pin.does_parameter_exist(block, "variable_2"):
            self.var2 = pin.get_string(block, "variable_2")
            self.bin2_min = pin.get_real(block, "bin2_min")
            self.bin2_max = pin.get_real(block, "bin2_max")
            self.nbin2 = pin.get_or_add_integer(block, "nbin2", 0)
            self.logscale2 = pin.get_or_add_boolean(block, "logscale2",
                                                    True)
        if self.logscale and self.bin_min <= 0.0:
            raise ValueError("pdf: logscale=true requires bin_min > 0")
        self.bins = self._edges(self.bin_min, self.bin_max, self.nbin,
                                self.logscale)
        if self.var2 is not None:
            self.bins2 = self._edges(self.bin2_min, self.bin2_max,
                                     self.nbin2, self.logscale2)
        base_dir = os.path.dirname(self.basename) or "."
        dn = f"pdf_{p.variable}"
        if self.var2 is not None:
            dn += f"_{self.var2}"
        self.dname = os.path.join(base_dir, dn)
        os.makedirs(self.dname, exist_ok=True)
        self._bins_written = False

    @staticmethod
    def _edges(lo, hi, n, log):
        if log:
            return np.logspace(np.log10(lo), np.log10(hi), n + 1)
        return np.linspace(lo, hi, n + 1)

    def _bin_index(self, vals, lo, hi, n, log):
        """Reference binning (pdf.cpp:246-260): 0 = underflow,
        n+1 = overflow, interior index from the uniform (log-)step."""
        if log:
            step = (np.log10(hi) - np.log10(lo)) / n
            idx = (np.log10(np.maximum(vals, 1e-300) / lo)
                   / step).astype(np.int64) + 1
        else:
            step = (hi - lo) / n
            idx = ((vals - lo) / step).astype(np.int64) + 1
        idx = np.clip(idx, 0, n + 1)
        idx[vals < lo] = 0
        idx[vals >= hi] = n + 1
        return idx

    def maybe_write(self, mesh, u, w, force=False, state=None):
        if force or self.due(mesh):
            self.write(mesh, u, w, state=state)
            if self.params.dt > 0.0:
                if self.params.last_time < -1e299:
                    self.params.last_time = mesh.time
                else:
                    self.params.last_time += self.params.dt
            self.params.file_number += 1

    def write(self, mesh, u, w, state=None) -> None:
        p = self.params
        mbi = mesh.mb_indcs
        sl = (slice(None), slice(None), slice(mbi.ks, mbi.ke + 1),
              slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
        bcc = state.get("bcc") if state is not None else None
        _, x = _resolve_host(self, mesh, u, w, bcc, state, p.variable)
        xv = x[sl][:, 0]
        xb = self._bin_index(xv.reshape(xv.shape[0], -1), self.bin_min,
                             self.bin_max, self.nbin, self.logscale)
        vol = (np.asarray(mesh.mb_size["dx1"], dtype=np.float64)
               * np.asarray(mesh.mb_size["dx2"])
               * np.asarray(mesh.mb_size["dx3"]))
        wgt = np.broadcast_to(vol[:, None], xb.shape).copy()
        if self.mass_weighted:
            dens = np.asarray(u, dtype=np.float64)[sl][:, IDN]
            wgt *= dens.reshape(dens.shape[0], -1)

        if self.var2 is None:
            result = np.zeros((1, self.nbin + 2))
            np.add.at(result[0], xb.reshape(-1), wgt.reshape(-1))
        else:
            _, y = _resolve_host(self, mesh, u, w, bcc, state, self.var2)
            yv = y[sl][:, 0]
            yb = self._bin_index(yv.reshape(yv.shape[0], -1),
                                 self.bin2_min, self.bin2_max,
                                 self.nbin2, self.logscale2)
            result = np.zeros((self.nbin2 + 2, self.nbin + 2))
            np.add.at(result, (yb.reshape(-1), xb.reshape(-1)),
                      wgt.reshape(-1))

        fmt = p.data_format
        base = os.path.basename(self.basename)
        if not self._bins_written:
            with open(os.path.join(self.dname, base + ".bins.pdf"),
                      "w") as f:
                f.write("# pdf bins \n")
                f.write(f"# [1]= {p.variable} \n")
                if self.var2 is not None:
                    f.write(f"# [2]= {self.var2} \n")
                f.write(" ".join(fmt % b for b in self.bins) + "\n")
                if self.var2 is not None:
                    f.write(" ".join(fmt % b for b in self.bins2) + "\n")
            self._bins_written = True
        fname = os.path.join(self.dname,
                             base + f".{p.file_number:05d}.pdf")
        with open(fname, "w") as f:
            f.write("# time= " + (fmt % mesh.time) + "\n")
            for row in result:
                f.write(" ".join(fmt % v for v in row) + "\n")
            f.write("\n")


class CartesianGridOutput(BaseOutput):
    """Interpolation onto a Cartesian sub-grid ('cartgrid').

    Reference: src/outputs/cartgrid.cpp + src/utils/cart_grid.cpp —
    numpoints_{x,y,z} points spanning center +- extent (half-width) per
    axis, uniformly or at Chebyshev nodes (chebyshev=true:
    x_i = c + e*cos(i*pi/(N-1))), trilinearly interpolated from the
    (possibly refined) mesh.  Binary layout matches the reference's
    packed MetaData struct: int cycle, float time, float center[3],
    float extent[3], int numpoints[3], bool is_cheb (+3 pad), int
    noutvars; then [int len][space-joined labels]; then float32 data in
    (var, z, y, x) order.  Files: cart/{basename}.{variable}.NNNNN.bin.
    """

    def __init__(self, pin, mesh, phys, block: str) -> None:
        super().__init__(pin, mesh, phys, block)
        self.center = [pin.get_or_add_real(block, f"center_{d}", 0.0)
                       for d in "xyz"]
        self.extent = [pin.get_or_add_real(block, f"extent_{d}", 2.0)
                       for d in "xyz"]
        self.npts = [pin.get_or_add_integer(block, f"numpoints_{d}", 32)
                     for d in "xyz"]
        self.cheb = pin.get_or_add_boolean(block, "chebyshev", False)
        self.dname = os.path.join(
            os.path.dirname(self.basename) or ".", "cart")
        os.makedirs(self.dname, exist_ok=True)

    def _axis(self, d):
        c, e, n = self.center[d], self.extent[d], self.npts[d]
        if self.cheb:
            return c + e * np.cos(np.arange(n) * np.pi / max(n - 1, 1))
        return np.linspace(c - e, c + e, n)

    def maybe_write(self, mesh, u, w, force=False, state=None):
        if force or self.due(mesh):
            self.write(mesh, u, w, state=state)
            if self.params.dt > 0.0:
                if self.params.last_time < -1e299:
                    self.params.last_time = mesh.time
                else:
                    self.params.last_time += self.params.dt
            self.params.file_number += 1

    def write(self, mesh, u, w, state=None) -> None:
        from ..z4c.ahf import interp_fields
        p = self.params
        bcc = state.get("bcc") if state is not None else None
        labels, arr = _resolve_host(self, mesh, u, w, bcc, state,
                                    p.variable)
        xs, ys, zs = self._axis(0), self._axis(1), self._axis(2)
        Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
        pts = np.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)],
                       axis=1)
        fields = [arr[:, n] for n in range(arr.shape[1])]
        vals = interp_fields(mesh, fields, pts).reshape(
            len(fields), len(zs), len(ys), len(xs))

        fname = os.path.join(
            self.dname, os.path.basename(self.basename)
            + f".{p.variable}.{p.file_number:05d}.bin")
        with open(fname, "wb") as f:
            f.write(struct.pack(
                "=if3f3f3i?3xi", mesh.ncycle, float(mesh.time),
                *[float(c) for c in self.center],
                *[float(e) for e in self.extent],
                *self.npts, self.cheb, len(labels)))
            names = " ".join(labels).encode()
            f.write(struct.pack("=i", len(names)))
            f.write(names)
            f.write(vals.astype(np.float32).tobytes())


class SphericalSurfaceOutput(BaseOutput):
    """Interpolation onto spherical surfaces ('sphsurf').

    Reference: src/outputs/spherical_surface.cpp +
    src/utils/spherical_surface.cpp — nangles = 2*ntheta^2 directions
    (uniform mu in [-1,1] x uniform phi with step pi/ntheta) on one
    radius (radius=) or a linear/log ladder (nradii/r_min/r_max/
    r_spacing), centered at (xc, yc, zc).  Writes the reference's
    legacy-VTK STRUCTURED_GRID file (big-endian float payloads): points
    as (r, theta, phi) triplets, TIME/CYCLE/RADII field data, r^2-scaled
    quadrature weights, then one SCALARS record per variable, all
    ordered radius-fastest.  Files: sph/{basename}.r=...NNNNN.vtk.
    """

    def __init__(self, pin, mesh, phys, block: str) -> None:
        super().__init__(pin, mesh, phys, block)
        self.ntheta = pin.get_or_add_integer(block, "ntheta", 32)
        self.center = [pin.get_or_add_real(block, c, 0.0)
                       for c in ("xc", "yc", "zc")]
        if pin.does_parameter_exist(block, "radius"):
            self.radii = [pin.get_real(block, "radius")]
        else:
            nr = pin.get_integer(block, "nradii")
            rmin = pin.get_real(block, "r_min")
            rmax = pin.get_real(block, "r_max")
            spacing = pin.get_or_add_string(block, "r_spacing", "linear")
            fr = np.arange(nr) / max(nr - 1, 1)
            if spacing == "log":
                self.radii = list(rmin * (rmax / rmin) ** fr)
            else:
                self.radii = list(rmin + (rmax - rmin) * fr)
        nt = self.ntheta
        mu = -1.0 + 2.0 * np.arange(nt) / (nt - 1)
        phi = np.pi / nt * np.arange(2 * nt)
        # angle index n = i_phi * ntheta + j_mu (spherical_surface.cpp:84)
        self.theta = np.repeat(np.arccos(np.clip(mu, -1, 1))[None, :],
                               2 * nt, axis=0).reshape(-1)
        self.phi = np.repeat(phi[:, None], nt, axis=1).reshape(-1)
        self.weight = (np.pi / nt) * (2.0 / nt)
        self.dname = os.path.join(
            os.path.dirname(self.basename) or ".", "sph")
        os.makedirs(self.dname, exist_ok=True)

    def maybe_write(self, mesh, u, w, force=False, state=None):
        if force or self.due(mesh):
            self.write(mesh, u, w, state=state)
            if self.params.dt > 0.0:
                if self.params.last_time < -1e299:
                    self.params.last_time = mesh.time
                else:
                    self.params.last_time += self.params.dt
            self.params.file_number += 1

    def write(self, mesh, u, w, state=None) -> None:
        from ..z4c.ahf import interp_fields
        p = self.params
        bcc = state.get("bcc") if state is not None else None
        labels, arr = _resolve_host(self, mesh, u, w, bcc, state,
                                    p.variable)
        nang = len(self.theta)
        nrad = len(self.radii)
        st, ct = np.sin(self.theta), np.cos(self.theta)
        cp, sp = np.cos(self.phi), np.sin(self.phi)
        # point index = r * nangles + angle (radius slowest in memory;
        # the file is written radius-fastest below)
        pts = np.empty((nrad * nang, 3))
        for r, rad in enumerate(self.radii):
            s = slice(r * nang, (r + 1) * nang)
            pts[s, 0] = self.center[0] + rad * st * cp
            pts[s, 1] = self.center[1] + rad * st * sp
            pts[s, 2] = self.center[2] + rad * ct
        fields = [arr[:, n] for n in range(arr.shape[1])]
        vals = interp_fields(mesh, fields, pts).reshape(
            len(fields), nrad, nang)

        if nrad == 1:
            rtag = f"r={self.radii[0]:.2f}"
        else:
            rtag = f"r={self.radii[0]:.2f}-{self.radii[-1]:.2f}"
        fname = os.path.join(
            self.dname, os.path.basename(self.basename)
            + f".{rtag}.{p.variable}.{p.file_number:05d}.vtk")
        with open(fname, "wb") as f:
            f.write(b"# vtk DataFile Version 3.0\n")
            f.write((f"# AthenaK data at time={mesh.time:g}"
                     f" cycle={mesh.ncycle} nradii={nrad}"
                     f" rmin={self.radii[0]:g} rmax={self.radii[-1]:g}"
                     f" xc={self.center[0]:g} yc={self.center[1]:g}"
                     f" zc={self.center[2]:g}\n").encode())
            f.write(b"BINARY\nDATASET STRUCTURED_GRID\n")
            f.write((f"DIMENSIONS {nrad} {self.ntheta}"
                     f" {2 * self.ntheta}\n").encode())
            f.write(f"POINTS {nrad * nang} float\n".encode())
            # (r, theta, phi) triplets, radius varying fastest
            tri = np.empty((nang, nrad, 3), dtype=np.float64)
            tri[:, :, 0] = np.asarray(self.radii)[None, :]
            tri[:, :, 1] = self.theta[:, None]
            tri[:, :, 2] = self.phi[:, None]
            f.write(tri.astype(">f4").tobytes())
            f.write(b"\nFIELD FieldData 3\nTIME 1 1 float\n")
            f.write(np.float32(mesh.time).astype(">f4").tobytes())
            f.write(b"\nCYCLE 1 1 int\n")
            f.write(np.int32(mesh.ncycle).astype(">i4").tobytes())
            f.write(f"\nRADII 1 {nrad} float\n".encode())
            f.write(np.asarray(self.radii).astype(">f4").tobytes())
            f.write(f"\nPOINT_DATA {nrad * nang}\n".encode())
            f.write(b"SCALARS weights float 1\nLOOKUP_TABLE default\n")
            wts = (np.asarray(self.radii)[None, :] ** 2
                   * self.weight) * np.ones((nang, 1))
            f.write(wts.astype(">f4").tobytes())
            for n, lab in enumerate(labels):
                f.write(f"\nSCALARS {lab} float 1\n".encode())
                f.write(b"LOOKUP_TABLE default\n")
                f.write(vals[n].T.astype(">f4").tobytes())
