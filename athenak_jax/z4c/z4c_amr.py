"""Z4c refinement strategies and on-device compact-object trackers.

Reference: src/z4c/z4c_amr.{hpp,cpp} (<z4c_amr> method = trivial /
tracker / chi / dchi plus radius_N_rad shells) and
src/z4c/compact_object_tracker.cpp (shift-ODE puncture tracker).

Design: tracker positions are DEVICE state
(``state["co_pos"]``, [nco, 3]) integrated inside the jitted cycle with
an on-device multi-block trilinear interpolation of the shift — the
reference's per-cycle host interpolation would serialize dispatch and
read back megabytes per cycle.  Only the AMR
check (already host-side, like the reference's refine_flag sync) and
the waveform/horizon outputs fetch the [nco, 3] positions.
"""

from __future__ import annotations

from typing import List

import numpy as np

import jax
import jax.numpy as jnp

from .z4c import I_CHI


# ---------------------------------------------------------------------------
# on-device multi-block trilinear interpolation
# ---------------------------------------------------------------------------
def device_interp(mesh, u, chans: List[int], pos):
    """Trilinear interpolation of channels of a block array on device.

    ``u``: [nmb, nch, n3, n2, n1] (ghosts included, filled);
    ``pos``: [npts, 3] traced positions.  Returns [npts, len(chans)].
    Works on any leaf tiling (uniform/SMR/AMR): the owning block is
    found by AABB containment over the per-block bounds (static per
    tree, so they trace as constants and retrace on tree changes, like
    every other per-block table).
    """
    from ..comm import current_comm, local_blocks

    mbi = mesh.mb_indcs
    sz = mesh.mb_size
    dt = u.dtype
    lo_np = np.stack([sz["x1min"], sz["x2min"], sz["x3min"]], axis=1)
    hi_np = np.stack([sz["x1max"], sz["x2max"], sz["x3max"]], axis=1)
    dx_np = np.stack([sz["dx1"], sz["dx2"], sz["dx3"]], axis=1)
    # inside the shard_map cycle the tables localize to the device's
    # block rows; ownership is half-open so exactly one device owns a
    # point and the psum-combine below is exact
    lo = jnp.asarray(local_blocks(lo_np, pad_edge=True), dt)   # [L, 3]
    hi = jnp.asarray(local_blocks(hi_np, pad_edge=True), dt)
    dx = jnp.asarray(local_blocks(dx_np, pad_edge=True), dt)
    ms = mesh.mesh_size
    top = np.array([ms.x1max, ms.x2max, ms.x3max])
    eps = 1e-6 * dx_np.min(axis=0)
    pos = jnp.clip(pos.astype(dt), None,
                   jnp.asarray(top - eps, dt)[None, :])
    inside = jnp.all((pos[:, None, :] >= lo[None])
                     & (pos[:, None, :] < hi[None]), axis=-1)   # [np, L]
    own = jnp.any(inside, axis=1)                               # [np]
    gid = jnp.argmax(inside, axis=1)                            # [np]

    ng = mbi.ng
    ncell = (mbi.ncells1, mbi.ncells2, mbi.ncells3)
    act = (mbi.nx1 > 1, mbi.nx2 > 1, mbi.nx3 > 1)
    i0 = []
    w = []
    for d in range(3):
        if not act[d]:
            i0.append(jnp.zeros_like(gid))
            w.append(jnp.zeros_like(pos[:, 0]))
            continue
        # cell centers: x = lo + (i - ng + 0.5) * dx
        fi = (pos[:, d] - lo[gid, d]) / dx[gid, d] + (ng - 0.5)
        ii = jnp.clip(jnp.floor(fi), 0, ncell[d] - 2).astype(jnp.int32)
        i0.append(ii)
        w.append(fi - ii.astype(dt))
    ch = jnp.asarray(chans)
    out = jnp.zeros((pos.shape[0], len(chans)), dt)
    for dk in range(2):
        for dj in range(2):
            for di in range(2):
                jj = i0[1] + dj
                ii = i0[0] + di
                c = u[gid[:, None], ch[None, :],
                      (i0[2] + dk)[:, None], jj[:, None],
                      ii[:, None]]
                wt = ((w[2] if dk else 1.0 - w[2])
                      * (w[1] if dj else 1.0 - w[1])
                      * (w[0] if di else 1.0 - w[0]))
                out = out + wt[:, None] * c
    cc = current_comm()
    if cc is not None:
        # non-owning devices gathered garbage rows: zero them and
        # psum so every device sees the owner's value
        out = jax.lax.psum(out * own[:, None].astype(dt), cc.axis)
    return out


# ---------------------------------------------------------------------------
# <z4c_amr> refinement strategies
# ---------------------------------------------------------------------------
class Z4cAMR:
    """Parsed <z4c_amr> block (reference: Z4c_AMR::Z4c_AMR,
    z4c_amr.cpp:27-57): one exclusive method (trivial/tracker/chi/dchi)
    plus optional radius_N_rad / radius_N_reflevel minimum-level
    shells."""

    def __init__(self, pin) -> None:
        self.method = pin.get_or_add_string("z4c_amr", "method", "trivial")
        # deck-compat aliases (reference inputs/z4c decks use chi_min /
        # dchi_max for what z4c_amr.cpp:30-43 calls chi / dchi)
        self.method = {"chi_min": "chi", "dchi_max": "dchi"}.get(
            self.method, self.method)
        if self.method not in ("trivial", "tracker", "chi", "dchi"):
            raise ValueError(
                f"<z4c_amr> method={self.method} unknown "
                "(trivial/tracker/chi/dchi)")
        self.chi_thresh = pin.get_or_add_real("z4c_amr", "chi_min", 0.2) \
            if self.method == "chi" else None
        self.dchi_thresh = pin.get_or_add_real(
            "z4c_amr", "dchi_max", 0.01) if self.method == "dchi" else None
        self.radius: List[float] = []
        self.reflevel: List[int] = []
        for nr in range(16):
            name = f"radius_{nr}_rad"
            if not pin.does_parameter_exist("z4c_amr", name):
                break
            self.radius.append(pin.get_real("z4c_amr", name))
            self.reflevel.append(pin.get_or_add_integer(
                "z4c_amr", f"radius_{nr}_reflevel", -1))

    # -- device part: chi / dchi block reductions -----------------------
    def device_flags(self, u, mesh):
        """Jittable int32 [nmb] flags for the chi/dchi methods
        (reference: RefineChiMin / RefineDchiMax,
        z4c_amr.cpp:133-226)."""
        mbi = mesh.mb_indcs
        ng = mbi.ng
        chi = u[:, I_CHI]
        nblk = chi.shape[0]
        zero = jnp.zeros(nblk, dtype=jnp.int32)
        act = []
        if mbi.nx1 > 1:
            act.append((3, mbi.nx1))
        if mbi.nx2 > 1:
            act.append((2, mbi.nx2))
        if mbi.nx3 > 1:
            act.append((1, mbi.nx3))

        def interior(q):
            for ax, nx in act:
                q = jax.lax.slice_in_dim(q, ng, ng + nx, axis=ax)
            return q

        if self.method == "chi":
            qmin = jnp.min(interior(chi), axis=(1, 2, 3))
            t = self.chi_thresh
            return jnp.where(qmin < t, 1,
                             jnp.where(qmin > 1.25 * t, -1, zero))
        if self.method == "dchi":
            d2 = 0.0
            for ax, _ in act:
                d2 = d2 + (jnp.roll(chi, -1, axis=ax)
                           - jnp.roll(chi, 1, axis=ax)) ** 2
            dmax = jnp.max(interior(jnp.sqrt(d2)), axis=(1, 2, 3))
            t = self.dchi_thresh
            return jnp.where(dmax > t, 1,
                             jnp.where(dmax < 0.5 * t, -1, zero))
        return zero

    # -- host part: tracker boxes + radial shells ------------------------
    def host_flags(self, flags, state, mesh, phys) -> np.ndarray:
        """Apply the tracker method (exact AABB-clamped min distance,
        reference: RefineTracker, z4c_amr.cpp:72-131) and the
        RefineRadii minimum-level shells (z4c_amr.cpp:228-275)."""
        sz = mesh.mb_size
        lev = np.asarray(mesh.mb_lev)
        x1min, x1max = sz["x1min"], sz["x1max"]
        x2min, x2max = sz["x2min"], sz["x2max"]
        x3min, x3max = sz["x3min"], sz["x3max"]

        if self.method == "tracker" and getattr(phys, "nco", 0) > 0:
            if "co_pos" in state:
                pos = np.asarray(state["co_pos"], dtype=np.float64)
            else:
                pos = np.asarray(phys.tracker_pos0, dtype=np.float64)
            rad = np.asarray(phys.tracker_radius)
            rl = np.asarray(phys.tracker_reflevel)
            px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
            cx = np.clip(px[None, :], x1min[:, None], x1max[:, None])
            cy = np.clip(py[None, :], x2min[:, None], x2max[:, None])
            cz = np.clip(pz[None, :], x3min[:, None], x3max[:, None])
            dmin2 = ((px[None] - cx) ** 2 + (py[None] - cy) ** 2
                     + (pz[None] - cz) ** 2)
            contained = ((px[None] >= x1min[:, None])
                         & (px[None] <= x1max[:, None])
                         & (py[None] >= x2min[:, None])
                         & (py[None] <= x2max[:, None])
                         & (pz[None] >= x3min[:, None])
                         & (pz[None] <= x3max[:, None]))
            hit = (dmin2 < rad[None] ** 2) | contained
            lv = lev[:, None]
            per = np.where(
                hit,
                np.where((rl[None] < 0) | (lv < rl[None]), 1,
                         np.where(lv == rl[None], 0, -1)),
                -1)
            flags = per.max(axis=1).astype(flags.dtype)

        if self.radius:
            corners = [x1min ** 2 + x2min ** 2 + x3min ** 2]
            for cx in (x1min, x1max):
                for cy in (x2min, x2max):
                    for cz in (x3min, x3max):
                        corners.append(cx ** 2 + cy ** 2 + cz ** 2)
            rmin2 = np.min(np.stack(corners), axis=0)
            for r, rl in zip(self.radius, self.reflevel):
                sel = rmin2 < r * r
                flags[sel & (lev < rl)] = 1
                flags[sel & (lev == rl) & (flags == -1)] = 0
        return flags
