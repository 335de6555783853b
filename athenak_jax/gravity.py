"""Self-gravity: Poisson solve for the potential + momentum/energy sources.

Parity target: the reference multigrid self-gravity
(reference: src/gravity/mg_gravity.cpp, src/multigrid/ FAS driver; solved
every RK stage, driver.cpp:406-408) with the Mullen, Hanawa & Gammie
(2020) source terms already implemented in srcterms.py.

Design: on uniform periodic meshes the Poisson solve is a
global FFT — one batched XLA FFT keeps the device busy and
replaces the reference's ~8 kLoC multigrid hierarchy (SURVEY.md §7 step 8
explicitly plans FFT-first, MG later for AMR).  Blocks are assembled into
the global grid with a host-precomputed Z-order permutation, solved in
k-space with the discrete (finite-difference-consistent) Green's
function, and scattered back.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np


def make_gravity(pin, mesh):
    """Solver selection: global-FFT Poisson on uniform periodic meshes
    (the fast path), FAS multigrid otherwise or when requested
    (reference: MGGravityDriver, src/gravity/mg_gravity.cpp)."""
    uniform = not getattr(mesh, "multilevel", False) \
        and not getattr(mesh, "adaptive", False)
    periodic = all(v == "periodic" for v in mesh.mesh_bcs.values())
    default = "fft" if (uniform and periodic) else "multigrid"
    solver = pin.get_or_add_string("gravity", "solver", default)
    if solver == "fft":
        return SelfGravity(pin, mesh)
    if solver == "multigrid":
        from .multigrid import MGPoisson
        return MGPoisson(pin, mesh)
    raise ValueError(f"gravity/solver={solver} (fft|multigrid)")


class SelfGravity:
    def __init__(self, pin, mesh) -> None:
        self.mesh = mesh
        self.four_pi_G = pin.get_or_add_real("gravity", "four_pi_G", -1.0)
        if self.four_pi_G <= 0.0:
            raise ValueError(
                "gravity/four_pi_G must be set (reference: "
                "src/gravity/gravity.cpp:41-50)")
        for key in ("ix1", "ox1", "ix2", "ox2", "ix3", "ox3"):
            if mesh.mesh_bcs[key] != "periodic":
                raise NotImplementedError(
                    "FFT self-gravity requires fully periodic boundaries "
                    "(multigrid for other BCs lands with AMR)")

        mbi = mesh.mb_indcs
        gn = mesh.mesh_indcs
        # block (lx3, lx2, lx1) -> gid permutation for global assembly
        order = np.empty((mesh.nmb_x3, mesh.nmb_x2, mesh.nmb_x1),
                         dtype=np.int32)
        for gid, loc in enumerate(mesh.lloc_eachmb):
            order[loc[2], loc[1], loc[0]] = gid
        self._order = order.ravel()  # row-major (lx3, lx2, lx1)
        inv = np.empty_like(self._order)
        inv[self._order] = np.arange(len(self._order))
        self._inv_order = inv

        # discrete Laplacian eigenvalues for the 2nd-order FD stencil:
        # lam = sum_d (2 cos(k_d dx_d) - 2)/dx_d^2  (so that the FD
        # gradient of phi matches the FD source discretization)
        ms = mesh.mesh_size
        kx = 2.0 * math.pi * np.fft.fftfreq(gn.nx1)
        ky = 2.0 * math.pi * np.fft.fftfreq(max(gn.nx2, 1))
        kz = 2.0 * math.pi * np.fft.fftfreq(max(gn.nx3, 1))
        lam = ((2.0 * np.cos(kx)[None, None, :] - 2.0) / ms.dx1 ** 2
               + (2.0 * np.cos(ky)[None, :, None] - 2.0) / ms.dx2 ** 2
               + (2.0 * np.cos(kz)[:, None, None] - 2.0) / ms.dx3 ** 2)
        lam[0, 0, 0] = 1.0  # mean mode removed separately
        self._inv_lam = (1.0 / lam)
        self._inv_lam[0, 0, 0] = 0.0

    # ------------------------------------------------------------------
    def _to_global(self, f):
        """[nmb, n3a, n2a, n1a] active-cell block array -> global grid."""
        mesh = self.mesh
        mbi = mesh.mb_indcs
        nb3, nb2, nb1 = mesh.nmb_x3, mesh.nmb_x2, mesh.nmb_x1
        g = f[self._order].reshape(nb3, nb2, nb1,
                                   mbi.nx3, mbi.nx2, mbi.nx1)
        g = jnp.transpose(g, (0, 3, 1, 4, 2, 5))
        return g.reshape(nb3 * mbi.nx3, nb2 * mbi.nx2, nb1 * mbi.nx1)

    def _to_blocks(self, g):
        mesh = self.mesh
        mbi = mesh.mb_indcs
        nb3, nb2, nb1 = mesh.nmb_x3, mesh.nmb_x2, mesh.nmb_x1
        g = g.reshape(nb3, mbi.nx3, nb2, mbi.nx2, nb1, mbi.nx1)
        g = jnp.transpose(g, (0, 2, 4, 1, 3, 5))
        f = g.reshape(nb3 * nb2 * nb1, mbi.nx3, mbi.nx2, mbi.nx1)
        return f[self._inv_order]

    # ------------------------------------------------------------------
    def solve(self, u, bvals, phi0=None):
        """phi with filled ghosts, [nmb, 1, n3, n2, n1].

        Solves lap(phi) = four_pi_G (rho - rho_mean) on the global grid
        (the mean is removed: Jeans swindle for a periodic box, exactly as
        the reference's periodic multigrid does)."""
        mbi = self.mesh.mb_indcs
        act = (slice(None),
               slice(mbi.ks, mbi.ke + 1),
               slice(mbi.js, mbi.je + 1),
               slice(mbi.is_, mbi.ie + 1))
        rho = u[:, 0][act]
        g = self._to_global(rho)
        src = self.four_pi_G * (g - jnp.mean(g))
        src_k = jnp.fft.fftn(src)
        phi_k = src_k * jnp.asarray(self._inv_lam, dtype=src_k.dtype)
        phi_g = jnp.real(jnp.fft.ifftn(phi_k)).astype(u.dtype)
        phi_act = self._to_blocks(phi_g)

        phi = jnp.zeros((u.shape[0], 1) + u.shape[2:], dtype=u.dtype)
        phi = phi.at[(slice(None), 0) + act[1:]].set(phi_act)
        return bvals.fill_ghosts(phi)
