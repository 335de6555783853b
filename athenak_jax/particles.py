"""Test particles: drift pusher + block assignment + tracked output.

Parity target: the reference ``Particles`` module
(reference: src/particles/particles.hpp:23-95, particles_pushers.cpp:19-59,
bvals_part.cpp, particles_tasks.cpp).  This snapshot of the reference
implements only the ``drift`` pusher (two half-drifts around the
communication step); migration between blocks updates the particle's
parent gid.

Design: particles are global fixed-capacity SoA device arrays
(positions [np,3], velocities [np,3]) living in the state pytree.  The
push is one fused elementwise kernel with periodic wrapping; "migration"
reduces to recomputing each particle's owner gid from its position with
the Z-order block map — a gather, not point-to-point messages.  Under
block-axis sharding the arrays are replicated (particle counts are tiny
compared with the grid; a bucketed ppermute exchange is the planned
scale-out path, mirroring SURVEY.md §2 row 15).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


class Particles:
    def __init__(self, pin, mesh) -> None:
        self.mesh = mesh
        self.particle_type = pin.get_or_add_string(
            "particles", "particle_type", "cosmic_ray")
        self.pusher = pin.get_or_add_string("particles", "pusher", "drift")
        if self.pusher != "drift":
            raise NotImplementedError(
                "only the drift pusher exists in the reference snapshot "
                "(reference: particles_pushers.cpp:32-51)")
        ppc = pin.get_or_add_real("particles", "ppc", 1.0)
        mbi = mesh.mb_indcs
        ncells = mbi.nx1 * max(mbi.nx2, 1) * max(mbi.nx3, 1)
        self.nprtcl = max(1, int(ppc * mesh.nmb_total * ncells))
        self.ntrack = pin.get_or_add_integer("particles", "ntrack", 10)

        # host tables for gid lookup: block index grid (Z-order -> gid)
        ms = mesh.mesh_size
        self._xmin = np.array([ms.x1min, ms.x2min, ms.x3min])
        self._xmax = np.array([ms.x1max, ms.x2max, ms.x3max])
        mb1 = mbi.nx1 * ms.dx1
        mb2 = mbi.nx2 * ms.dx2
        mb3 = mbi.nx3 * ms.dx3
        self._mb_width = np.array([mb1, mb2, mb3])
        self._nmb_xyz = np.array([mesh.nmb_x1, mesh.nmb_x2, mesh.nmb_x3])
        # map (lx1,lx2,lx3) -> gid as a dense int array
        lut = np.zeros((mesh.nmb_x3, mesh.nmb_x2, mesh.nmb_x1),
                       dtype=np.int32)
        for gid, loc in enumerate(mesh.lloc_eachmb):
            lut[loc[2], loc[1], loc[0]] = gid
        self._gid_lut = lut

    # ------------------------------------------------------------------
    def init_state_entries(self, dtype, seed: int = 0):
        """Random particles (reference: pgen/particles/part_random.cpp)."""
        key = jax.random.PRNGKey(seed)
        kx, kv = jax.random.split(key)
        span = self._xmax - self._xmin
        pos = self._xmin + span * np.asarray(
            jax.random.uniform(kx, (self.nprtcl, 3)))
        vel = 2.0 * (np.asarray(jax.random.uniform(kv, (self.nprtcl, 3)))
                     - 0.5)
        return {
            "prtcl_x": jnp.asarray(pos, dtype=dtype),
            "prtcl_v": jnp.asarray(vel, dtype=dtype),
        }

    # ------------------------------------------------------------------
    def push(self, state, dt):
        """Drift push with periodic wrapping.  The reference splits the
        drift into two half-steps around the particle communication
        (particles_tasks.cpp); with gather-based migration the two halves
        compose into one full drift."""
        x = state["prtcl_x"] + dt * state["prtcl_v"]
        span = self._xmax - self._xmin
        x = self._xmin + jnp.mod(x - self._xmin, span)
        return dict(state, prtcl_x=x)

    # ------------------------------------------------------------------
    def gids(self, x):
        """Owner block gid for each particle (the migration step's
        destination computation, reference: bvals_part.cpp per-particle
        destination GID).  Uniform meshes use the root-grid LUT; on
        SMR/AMR the owner is the containing leaf (AABB test over the
        per-block bounds)."""
        xi = np.asarray(x)
        if getattr(self.mesh, "multilevel", False):
            sz = self.mesh.mb_size
            lo = np.stack([sz["x1min"], sz["x2min"], sz["x3min"]], axis=1)
            hi = np.stack([sz["x1max"], sz["x2max"], sz["x3max"]], axis=1)
            inside = np.all((xi[:, None, :] >= lo[None])
                            & (xi[:, None, :] <= hi[None]), axis=-1)
            return np.argmax(inside, axis=1).astype(np.int32)
        loc = np.floor((xi - self._xmin) / self._mb_width).astype(np.int64)
        loc = np.clip(loc, 0, self._nmb_xyz - 1)
        return self._gid_lut[loc[:, 2], loc[:, 1], loc[:, 0]]

    # ------------------------------------------------------------------
    def new_dt(self):
        """dt = min cell crossing at |v|<=1 (reference:
        part_random.cpp:82-86); finest spacing on multilevel meshes."""
        from .diffusion import _dx_min
        mbi = self.mesh.mb_indcs
        dt = _dx_min(self.mesh, "x1")
        if mbi.nx2 > 1:
            dt = min(dt, _dx_min(self.mesh, "x2"))
        if mbi.nx3 > 1:
            dt = min(dt, _dx_min(self.mesh, "x3"))
        return dt
