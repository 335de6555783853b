"""Coordinates / relativity mode flags (+ GR metric later layers).

Parity target: the reference ``Coordinates`` class construction flags
(reference: src/coordinates/coordinates.cpp:30-60): <coord>/special_rel
and <coord>/general_rel select the SR/GR variants of every physics kernel.
"""

from __future__ import annotations


class CoordData:
    """GR coordinate parameters
    (reference: src/coordinates/coordinates.cpp:46-71)."""

    def __init__(self, pin) -> None:
        self.is_minkowski = pin.get_or_add_boolean("coord", "minkowski",
                                                   False)
        if not self.is_minkowski:
            self.bh_spin = pin.get_real("coord", "a")
            self.bh_excise = pin.get_or_add_boolean("coord", "excise", True)
        else:
            self.bh_spin = 0.0
            self.bh_excise = False
        if self.bh_excise:
            self.dexcise = pin.get_real("coord", "dexcise")
            self.pexcise = pin.get_real("coord", "pexcise")
            self.rexcise = 1.0
        else:
            self.dexcise = self.pexcise = -1.0
            self.rexcise = 0.0


class GRGeometry:
    """Broadcastable coordinate arrays + metric evaluation helpers.

    Replacement for the reference's per-cell metric calls: the
    1-D coordinate arrays are baked as host constants and the metric is
    recomputed inside jit (fused by XLA, zero HBM traffic); see
    athenak_jax/gr/cks.py.
    """

    def __init__(self, mesh, coord_data: CoordData) -> None:
        import numpy as np
        self.cd = coord_data
        mbi = mesh.mb_indcs
        nmb = mesh.nmb_total
        xc = np.empty((nmb, 1, 1, mbi.ncells1))
        yc = np.empty((nmb, 1, mbi.ncells2, 1))
        zc = np.empty((nmb, mbi.ncells3, 1, 1))
        xf = np.empty((nmb, 1, 1, mbi.ncells1))
        yf = np.empty((nmb, 1, mbi.ncells2, 1))
        zf = np.empty((nmb, mbi.ncells3, 1, 1))
        for gid in range(nmb):
            x1v, x2v, x3v = mesh.cell_centers(gid)
            x1e, x2e, x3e = mesh.face_edges(gid)
            xc[gid, 0, 0, :] = x1v
            yc[gid, 0, :, 0] = x2v
            zc[gid, :, 0, 0] = x3v
            xf[gid, 0, 0, :] = x1e[:mbi.ncells1]
            yf[gid, 0, :, 0] = x2e[:mbi.ncells2]
            zf[gid, :, 0, 0] = x3e[:mbi.ncells3]
        self.xc, self.yc, self.zc = xc, yc, zc
        self.xf, self.yf, self.zf = xf, yf, zf

    def _pos(self, where: str):
        from .comm import local_blocks

        if where == "cc":
            xyz = self.xc, self.yc, self.zc
        elif where == "x1":  # x1-face positions (left edges), cell-indexed
            xyz = self.xf, self.yc, self.zc
        elif where == "x2":
            xyz = self.xc, self.yf, self.zc
        elif where == "x3":
            xyz = self.xc, self.yc, self.zf
        else:
            raise ValueError(where)
        # inside a shard_map region each device gets its own blocks' rows
        return tuple(local_blocks(a, pad_edge=True) for a in xyz)

    def metric(self, where: str = "cc"):
        from .gr.cks import metric
        x, y, z = self._pos(where)
        return metric(x, y, z, self.cd.bh_spin, self.cd.is_minkowski)

    def metric_derivatives(self):
        from .gr.cks import metric_derivatives
        x, y, z = self._pos("cc")
        return metric_derivatives(x, y, z,
                                  self.cd.bh_spin, self.cd.is_minkowski)

    def ks_radius_cc(self):
        """Spherical KS radius at cell centers (numpy, for excision masks)
        (reference: KSRX, src/coordinates/excision.cpp:20-24)."""
        import numpy as np
        x, y, z = self.xc, self.yc, self.zc
        a = self.cd.bh_spin
        rad2 = x * x + y * y + z * z
        return np.sqrt((rad2 - a * a
                        + np.sqrt((rad2 - a * a) ** 2
                                  + 4 * a * a * z * z)) / 2.0)

    def excision_floor_mask(self):
        """Cells with r_ks <= rexcise (host numpy bool, broadcast shape)
        (reference: Coordinates::SetExcisionMasks, excision.cpp:52-95)."""
        return self.ks_radius_cc() <= self.cd.rexcise


class Coordinates:
    def __init__(self, pin) -> None:
        if pin.does_block_exist("coord"):
            self.is_special_relativistic = pin.get_or_add_boolean(
                "coord", "special_rel", False)
            self.is_general_relativistic = pin.get_or_add_boolean(
                "coord", "general_rel", False)
        else:
            self.is_special_relativistic = False
            self.is_general_relativistic = False
        if self.is_special_relativistic and self.is_general_relativistic:
            raise ValueError("cannot specify both special_rel and general_rel")
        self.coord_data = CoordData(pin) \
            if self.is_general_relativistic else None
