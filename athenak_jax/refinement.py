"""Static mesh refinement: octree leaves, mixed-level neighbor tables,
and the restriction/prolongation operators.

Parity targets: tree construction from ``<refined_regionN>`` blocks
(reference: src/mesh/build_tree.cpp:62-229), 2:1 level balance
(reference: src/mesh/meshblock_tree.cpp refinement flags), the
piecewise-linear min-mod prolongation operator ProlongCC (reference:
src/mesh/prolongation.hpp:19-59) and conservative cell-averaging
restriction RestrictCC (reference: src/mesh/restriction.hpp).

Design: the tree is built once on host with plain Python/
numpy; the per-cycle compute path sees only static gather-index tables
(same-level / coarse / fine donors per face) and fixed-shape reshape-
mean / interleave kernels.  No per-buffer pack/unpack machinery — each
axis sweep rebuilds the array with one concatenate, selecting between
donor candidates with masked ``where``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .comm import gather_blocks, local_blocks

# transverse axes (in mesh naming) for each sweep axis; the first entry
# is the fast quadrant index
_TRANSVERSE = {"x1": ("x2", "x3"), "x2": ("x1", "x3"), "x3": ("x1", "x2")}
# mesh-axis -> component index in the (l1, l2, l3) logical location
_AXIS_ID = {"x1": 0, "x2": 1, "x3": 2}


# ---------------------------------------------------------------------------
# tree construction (host side)
# ---------------------------------------------------------------------------
def build_static_tree(pin, nrbx: Tuple[int, int, int],
                      active: Tuple[bool, bool, bool],
                      domain: Tuple[float, float, float, float, float, float],
                      ) -> List[Tuple[int, int, int, int]]:
    """Build the leaf list for a statically refined mesh.

    Reads every ``<refined_region*>`` input block (level = levels finer
    than root, region bounds in physical coordinates), refines all root
    blocks intersecting each region to its level, then enforces 2:1
    balance across face/edge/corner neighbors (reference:
    build_tree.cpp:95-229).  Returns leaves as (l1, l2, l3, level)
    tuples with level relative to root, in Z-order.
    """
    x1min, x1max, x2min, x2max, x3min, x3max = domain
    ndim = 1 + int(active[1]) + int(active[2])

    # leaf set: dict (lev, l1, l2, l3) -> True
    leaves = {}
    for l3 in range(nrbx[2]):
        for l2 in range(nrbx[1]):
            for l1 in range(nrbx[0]):
                leaves[(0, l1, l2, l3)] = True

    def block_bounds(lev, l1, l2, l3):
        n1 = nrbx[0] << lev
        n2 = nrbx[1] << lev if active[1] else nrbx[1]
        n3 = nrbx[2] << lev if active[2] else nrbx[2]
        return (x1min + (x1max - x1min) * l1 / n1,
                x1min + (x1max - x1min) * (l1 + 1) / n1,
                x2min + (x2max - x2min) * l2 / n2,
                x2min + (x2max - x2min) * (l2 + 1) / n2,
                x3min + (x3max - x3min) * l3 / n3,
                x3min + (x3max - x3min) * (l3 + 1) / n3)

    def split(key):
        lev, l1, l2, l3 = key
        del leaves[key]
        for o3 in range(2 if active[2] else 1):
            for o2 in range(2 if active[1] else 1):
                for o1 in range(2):
                    leaves[(lev + 1, 2 * l1 + o1,
                            (2 * l2 + o2) if active[1] else l2,
                            (2 * l3 + o3) if active[2] else l3)] = True

    # ---- refine regions
    regions = []
    for block in list(pin.blocks.keys()):
        if not block.startswith("refined_region"):
            continue
        lev = pin.get_integer(block, "level")
        if lev < 1:
            raise ValueError(f"<{block}> level must be >= 1")
        reg = (pin.get_real(block, "x1min"), pin.get_real(block, "x1max"),
               pin.get_or_add_real(block, "x2min", x2min),
               pin.get_or_add_real(block, "x2max", x2max),
               pin.get_or_add_real(block, "x3min", x3min),
               pin.get_or_add_real(block, "x3max", x3max))
        regions.append((lev, reg))
    if not regions:
        raise ValueError("refinement=static requires at least one "
                         "<refined_regionN> block")

    for target, reg in regions:
        changed = True
        while changed:
            changed = False
            for key in list(leaves.keys()):
                lev = key[0]
                if lev >= target:
                    continue
                b = block_bounds(*key)
                inter = (max(b[0], reg[0]) < min(b[1], reg[1]))
                if active[1]:
                    inter &= (max(b[2], reg[2]) < min(b[3], reg[3]))
                if active[2]:
                    inter &= (max(b[4], reg[4]) < min(b[5], reg[5]))
                if inter:
                    split(key)
                    changed = True

    # ---- 2:1 balance over face+edge+corner neighbors
    max_lev = max(k[0] for k in leaves)

    def covering(lev, l1, l2, l3):
        """The leaf covering cell (l1,l2,l3) of level lev, or None."""
        for up in range(lev, -1, -1):
            s = lev - up
            key = (up, l1 >> s,
                   (l2 >> s) if active[1] else l2,
                   (l3 >> s) if active[2] else l3)
            if key in leaves:
                return key
        return None

    def extent(lev):
        return (nrbx[0] << lev,
                (nrbx[1] << lev) if active[1] else nrbx[1],
                (nrbx[2] << lev) if active[2] else nrbx[2])

    changed = True
    while changed:
        changed = False
        for key in list(leaves.keys()):
            if key not in leaves:
                continue
            lev, l1, l2, l3 = key
            if lev <= 1:
                continue  # neighbors of level-<=1 leaves can always comply
            n1, n2, n3 = extent(lev)
            for d3 in ((-1, 0, 1) if active[2] else (0,)):
                for d2 in ((-1, 0, 1) if active[1] else (0,)):
                    for d1 in (-1, 0, 1):
                        if d1 == 0 and d2 == 0 and d3 == 0:
                            continue
                        t1, t2, t3 = l1 + d1, l2 + d2, l3 + d3
                        # periodic wrap always applied for balance checks:
                        # non-periodic out-of-domain cells have no leaf
                        if not (0 <= t1 < n1):
                            t1 %= n1
                            if not _wraps(pin, "x1"):
                                continue
                        if not (0 <= t2 < n2):
                            t2 %= n2
                            if not _wraps(pin, "x2"):
                                continue
                        if not (0 <= t3 < n3):
                            t3 %= n3
                            if not _wraps(pin, "x3"):
                                continue
                        cov = covering(lev, t1, t2, t3)
                        if cov is not None and cov[0] < lev - 1:
                            split(cov)
                            changed = True

    # ---- Z-order (Morton at the finest level = tree-traversal order)
    max_lev = max(k[0] for k in leaves)
    nb = max(extent(max_lev))
    nbits = max(1, (nb - 1).bit_length())

    def zkey(key):
        lev, l1, l2, l3 = key
        s = max_lev - lev
        u1 = l1 << s
        u2 = (l2 << s) if active[1] else l2
        u3 = (l3 << s) if active[2] else l3
        out = 0
        for i in range(nbits):
            out |= ((u1 >> i) & 1) << (3 * i)
            out |= ((u2 >> i) & 1) << (3 * i + 1)
            out |= ((u3 >> i) & 1) << (3 * i + 2)
        return out

    order = sorted(leaves.keys(), key=zkey)
    return [(l1, l2, l3, lev) for (lev, l1, l2, l3) in order]


def _wraps(pin, ax: str) -> bool:
    flag = pin.get_or_add_string("mesh", f"i{ax}_bc", "periodic")
    return flag in ("periodic", "shear_periodic")


# ---------------------------------------------------------------------------
# neighbor tables (host side)
# ---------------------------------------------------------------------------
def build_ml_tables(leaves, nrbx, active, wraps) -> Dict[str, Dict]:
    """Per-(axis, side) donor tables for the mixed-level halo exchange.

    For each block: a same-level donor gid (self when none / physical
    boundary — the uniform fast-path table), a coarse donor gid +
    transverse parities (this block's position within the coarse
    neighbor's face), and 2^(n_transverse) fine donor gids.
    """
    nmb = len(leaves)
    loc2gid = {}
    for gid, (l1, l2, l3, lev) in enumerate(leaves):
        loc2gid[(lev, l1, l2, l3)] = gid

    def extent(lev):
        return (nrbx[0] << lev,
                (nrbx[1] << lev) if active[1] else nrbx[1],
                (nrbx[2] << lev) if active[2] else nrbx[2])

    axes = [("x1", 0)]
    if active[1]:
        axes.append(("x2", 1))
    if active[2]:
        axes.append(("x3", 2))

    tables: Dict[str, Dict] = {}
    any_multi = any(lev > 0 for (_, _, _, lev) in leaves)
    for name, ax in axes:
        t_names = [t for t in _TRANSVERSE[name]
                   if active[_AXIS_ID[t]]]
        nq = 1 << len(t_names)
        for side, delta in (("m", -1), ("p", +1)):
            key = f"{name}{side}"
            same = np.empty(nmb, dtype=np.int32)
            phys = np.zeros(nmb, dtype=bool)
            coarse = np.zeros(nmb, dtype=np.int32)
            co_mask = np.zeros(nmb, dtype=bool)
            fine = np.zeros((nmb, nq), dtype=np.int32)
            fi_mask = np.zeros(nmb, dtype=bool)
            par = {t: np.zeros(nmb, dtype=np.int64) for t in t_names}
            # corner-strip guards for the prolongation write: on concave
            # trees a coarse-donor face can have a SAME-or-FINER diagonal
            # neighbor; the ghost corner strip then belongs to that donor
            # (filled transitively by the sweeps), and the prolongation
            # must not overwrite it (the reference enumerates corner
            # buffers by actual neighbor level, src/bvals/bvals.hpp:61-101)
            pkeep = {t: {"m": np.ones(nmb, dtype=bool),
                         "p": np.ones(nmb, dtype=bool)} for t in t_names}

            def _covering_lev(lev, c1, c2, c3):
                """Level of the leaf covering cell (c1,c2,c3) of lev, or
                None when covered by finer leaves."""
                for up in range(lev, -1, -1):
                    s = lev - up
                    k = (up, c1 >> s,
                         (c2 >> s) if active[1] else c2,
                         (c3 >> s) if active[2] else c3)
                    if k in loc2gid:
                        return up
                return None

            for gid, (l1, l2, l3, lev) in enumerate(leaves):
                n = extent(lev)
                tgt = [l1, l2, l3]
                tgt[ax] += delta
                if not (0 <= tgt[ax] < n[ax]):
                    if wraps[name]:
                        tgt[ax] %= n[ax]
                    else:
                        same[gid] = gid
                        phys[gid] = True
                        continue
                k_same = (lev, tgt[0], tgt[1], tgt[2])
                if k_same in loc2gid:
                    same[gid] = loc2gid[k_same]
                    continue
                # coarser neighbor?
                k_co = (lev - 1, tgt[0] >> 1,
                        (tgt[1] >> 1) if active[1] else tgt[1],
                        (tgt[2] >> 1) if active[2] else tgt[2])
                if lev > 0 and k_co in loc2gid:
                    same[gid] = gid  # masked out
                    coarse[gid] = loc2gid[k_co]
                    co_mask[gid] = True
                    my = (l1, l2, l3)
                    for t in t_names:
                        par[t][gid] = my[_AXIS_ID[t]] & 1
                        # diagonal neighbor level at each transverse end:
                        # prolongation may only write a corner strip whose
                        # diagonal is strictly coarser
                        for s2name, s2 in (("m", -1), ("p", +1)):
                            d = list(tgt)
                            ta = _AXIS_ID[t]
                            d[ta] += s2
                            if not (0 <= d[ta] < n[ta]):
                                if wraps[t]:
                                    d[ta] %= n[ta]
                                else:
                                    continue  # physical corner: keep
                            clev = _covering_lev(lev, d[0], d[1], d[2])
                            if not (clev is not None and clev < lev):
                                pkeep[t][s2name][gid] = False
                    continue
                # finer neighbors: children of tgt at lev+1 touching my face
                same[gid] = gid
                fi_mask[gid] = True
                base = [tgt[0] << 1,
                        (tgt[1] << 1) if active[1] else tgt[1],
                        (tgt[2] << 1) if active[2] else tgt[2]]
                # near half along the normal axis
                base[ax] += (1 if side == "m" else 0)
                for q in range(nq):
                    child = list(base)
                    for bt, t in enumerate(t_names):
                        child[_AXIS_ID[t]] += (q >> bt) & 1
                    k_fi = (lev + 1, child[0], child[1], child[2])
                    if k_fi not in loc2gid:
                        raise RuntimeError(
                            f"tree not 2:1 balanced at {key} of gid {gid}")
                    fine[gid, q] = loc2gid[k_fi]

            tables[key] = {
                "same": same, "phys": phys,
                "coarse": coarse, "coarse_mask": co_mask,
                "fine": fine, "fine_mask": fi_mask,
                "par": par, "t_names": t_names, "pkeep": pkeep,
                "any_coarse": bool(co_mask.any()),
                "any_fine": bool(fi_mask.any()),
            }
    # ---- edge-diagonal fine donors (for single-valued corner EMFs):
    # for each axis pair (d1, d2) and corner (s1, s2), the finer leaves
    # covering the diagonal neighbor cell; the remaining axis is the edge
    # direction (2 donors stacked along it in 3D, 1 in 2D/edge-inactive)
    pairs = [(a1, a2) for i, (a1, x1) in enumerate(axes)
             for (a2, x2) in axes[i + 1:]]
    for d1, d2 in pairs:
        a1, a2 = _AXIS_ID[d1], _AXIS_ID[d2]
        ec = ({0, 1, 2} - {a1, a2}).pop()  # edge-direction axis id
        ec_active = active[ec]
        nq = 2 if ec_active else 1
        for s1, e1 in (("m", -1), ("p", +1)):
            for s2, e2 in (("m", -1), ("p", +1)):
                key = f"e_{d1}{s1}{d2}{s2}"
                fine = np.zeros((nmb, nq), dtype=np.int32)
                mask = np.zeros(nmb, dtype=bool)
                same_gid = np.zeros(nmb, dtype=np.int32)
                same_mask = np.zeros(nmb, dtype=bool)
                for gid, (l1, l2, l3) in enumerate(
                        [(a, b, c) for a, b, c, _ in leaves]):
                    lev = leaves[gid][3]
                    n = extent(lev)
                    tgt = [l1, l2, l3]
                    tgt[a1] += e1
                    tgt[a2] += e2
                    ok = True
                    for ax_id, nm in ((a1, d1), (a2, d2)):
                        if not (0 <= tgt[ax_id] < n[ax_id]):
                            if wraps[nm]:
                                tgt[ax_id] %= n[ax_id]
                            else:
                                ok = False
                    if not ok:
                        continue
                    k_same = (lev, tgt[0], tgt[1], tgt[2])
                    if k_same in loc2gid:
                        # same-level diagonal: recorded for the EMF
                        # edge-averaging sync (reference: corner buffers of
                        # flux_correct_fc.cpp SumBoundaryFluxes)
                        same_gid[gid] = loc2gid[k_same]
                        same_mask[gid] = True
                        continue
                    # finer children touching my corner edge?
                    base = [t << 1 if active[i] else t
                            for i, t in enumerate(tgt)]
                    # the donor's NEAR half touches my corner: its minus
                    # children when it sits on my plus side, and vice versa
                    base[a1] += (0 if e1 > 0 else 1)
                    base[a2] += (0 if e2 > 0 else 1)
                    found = True
                    for q in range(nq):
                        child = list(base)
                        if ec_active:
                            child[ec] += q
                        k_fi = (lev + 1, child[0], child[1], child[2])
                        if k_fi not in loc2gid:
                            found = False
                            break
                        fine[gid, q] = loc2gid[k_fi]
                    if found:
                        mask[gid] = True
                tables[key] = {"fine": fine, "mask": mask,
                               "edge_axis": ec,
                               "same_gid": same_gid,
                               "same_mask": same_mask,
                               "any_same": bool(same_mask.any()),
                               "any": bool(mask.any())}
    # ---- 3D vertex (triple-diagonal) donors for the corner-fill pass
    if all(active):
        for s1, e1 in (("m", -1), ("p", +1)):
            for s2, e2 in (("m", -1), ("p", +1)):
                for s3, e3 in (("m", -1), ("p", +1)):
                    key = f"v_{s1}{s2}{s3}"
                    same_gid = np.zeros(nmb, dtype=np.int32)
                    same_mask = np.zeros(nmb, dtype=bool)
                    fine_gid = np.zeros(nmb, dtype=np.int32)
                    fine_mask = np.zeros(nmb, dtype=bool)
                    for gid, (l1, l2, l3, lev) in enumerate(leaves):
                        n = extent(lev)
                        tgt = [l1 + e1, l2 + e2, l3 + e3]
                        ok = True
                        for ax_id, nm in ((0, "x1"), (1, "x2"),
                                          (2, "x3")):
                            if not (0 <= tgt[ax_id] < n[ax_id]):
                                if wraps[nm]:
                                    tgt[ax_id] %= n[ax_id]
                                else:
                                    ok = False
                        if not ok:
                            continue
                        k_same = (lev, tgt[0], tgt[1], tgt[2])
                        if k_same in loc2gid:
                            same_gid[gid] = loc2gid[k_same]
                            same_mask[gid] = True
                            continue
                        # finer: the single child touching my corner
                        child = (lev + 1,
                                 2 * tgt[0] + (0 if e1 > 0 else 1),
                                 2 * tgt[1] + (0 if e2 > 0 else 1),
                                 2 * tgt[2] + (0 if e3 > 0 else 1))
                        if child in loc2gid:
                            fine_gid[gid] = loc2gid[child]
                            fine_mask[gid] = True
                    tables[key] = {
                        "same_gid": same_gid, "same_mask": same_mask,
                        "fine_gid": fine_gid, "fine_mask": fine_mask,
                        "any_same": bool(same_mask.any()),
                        "any_fine": bool(fine_mask.any())}
    tables["multilevel"] = any_multi
    return tables


# ---------------------------------------------------------------------------
# conservative flux correction (traced, shape-static)
# ---------------------------------------------------------------------------
# mesh axis -> array axis in [nmb, nvar, n3, n2, n1]
_CC_AXIS = {"x1": 4, "x2": 3, "x3": 2}


def flux_correct_cc(flx, mesh, dir_names):
    """SMR flux correction: on every coarse face abutting finer blocks,
    replace the coarse flux with the transverse cell-average of the fine
    donors' boundary-face fluxes (reference:
    src/bvals/flux_correction_cc.cpp).  Restores exact telescoping
    conservation across refinement boundaries.  ``flx[name][..., i]``
    holds the flux at the left face of cell i."""
    import jax.numpy as jnp

    mbi = mesh.mb_indcs
    ng, h = mbi.ng, mbi.ng // 2
    nx_of = {"x1": mbi.nx1, "x2": mbi.nx2, "x3": mbi.nx3}
    out = dict(flx)
    for name in dir_names:
        f = out[name]
        nd = f.ndim
        axis = _CC_AXIS[name] - (5 - nd)
        n = f.shape[axis]
        for side in ("m", "p"):
            t = mesh.ml[f"{name}{side}"]
            if not t["any_fine"]:
                continue
            nxa = nx_of[name]
            my_idx = ng if side == "m" else ng + nxa
            dn_idx = ng + nxa if side == "m" else ng

            def slc(i, axis=axis, nd=nd):
                idx = [slice(None)] * nd
                idx[axis] = slice(i, i + 1)
                return tuple(idx)

            dn_slab = f[slc(dn_idx)]
            # restrict transverse-only (the flux lives ON the face)
            t_axes = [_CC_AXIS[a] - 5 for a in t["t_names"]]
            parts = [restrict_cc(
                gather_blocks(dn_slab, t["fine"][:, q]), t_axes)
                     for q in range(t["fine"].shape[1])]
            # quadrant assembly over my transverse INTERIOR: the restricted
            # donor interior [h, h+nx_t/2) tiles it exactly
            for a2 in t["t_names"]:
                t_axis = _CC_AXIS[a2] - (5 - nd)
                half = nx_of[a2] // 2
                merged = []
                for b in range(0, len(parts), 2):
                    lo = jnp.take(parts[b], np.arange(h, h + half),
                                  axis=t_axis)
                    hi = jnp.take(parts[b + 1], np.arange(h, h + half),
                                  axis=t_axis)
                    merged.append(jnp.concatenate([lo, hi], axis=t_axis))
                parts = merged
            assembled = parts[0]
            my_slab = f[slc(my_idx)]
            region = [slice(None)] * nd
            for a2 in t["t_names"]:
                region[_CC_AXIS[a2] - (5 - nd)] = slice(ng, ng + nx_of[a2])
            region = tuple(region)
            fmask = local_blocks(
                t["fine_mask"]).reshape((-1,) + (1,) * (nd - 1))
            my_slab = my_slab.at[region].set(
                jnp.where(fmask, assembled, my_slab[region]))
            pre = [slice(None)] * nd
            pre[axis] = slice(0, my_idx)
            post = [slice(None)] * nd
            post[axis] = slice(my_idx + 1, n)
            f = jnp.concatenate(
                [f[tuple(pre)], my_slab, f[tuple(post)]], axis=axis)
        out[name] = f
    return out


# ---------------------------------------------------------------------------
# restriction / prolongation array operators (traced, shape-static)
# ---------------------------------------------------------------------------
def restrict_cc(x, cell_axes):
    """Conservative 2x cell-average restriction along ``cell_axes``
    (negative array-axis indices; reference: restriction.hpp RestrictCC)."""
    import jax.numpy as jnp
    for ax in cell_axes:
        a = ax % x.ndim
        sh = x.shape
        new = sh[:a] + (sh[a] // 2, 2) + sh[a + 1:]
        x = x.reshape(new).mean(axis=a + 1)
    return x


def _minmod_slope(c, a):
    import jax.numpy as jnp
    n = c.shape[a]
    lo = jnp.take(c, np.arange(0, n - 2), axis=a)
    mi = jnp.take(c, np.arange(1, n - 1), axis=a)
    hi = jnp.take(c, np.arange(2, n), axis=a)
    dl = mi - lo
    dr = hi - mi
    # full min-mod slope (magnitude min(|dl|,|dr|) when signs agree);
    # the fine offsets are +/- slope/4, matching reference ProlongCC's
    # dvar = 0.125*(SIGN(dl)+SIGN(dr))*min(|dl|,|dr|) applied as c +/- dvar
    return 0.5 * (jnp.sign(dl) + jnp.sign(dr)) \
        * jnp.minimum(jnp.abs(dl), jnp.abs(dr))


def _interleave(lo, hi, a):
    import jax.numpy as jnp
    st = jnp.stack((lo, hi), axis=a + 1)
    sh = lo.shape
    return st.reshape(sh[:a] + (2 * sh[a],) + sh[a + 1:])


# 4th-order Lagrange interpolation weights at the fine-cell centers
# x = -1/4 and +1/4 (in coarse cells) over the 5-point stencil -2..2
# (reference: HighOrderProlongCC + InitInterpWghts,
# src/mesh/prolongation.hpp:247-283, mesh_refinement.cpp weights)
def _lagrange_w(x, nodes=(-2.0, -1.0, 0.0, 1.0, 2.0)):
    import numpy as _np
    w = _np.ones(len(nodes))
    for i, xi in enumerate(nodes):
        for j, xj in enumerate(nodes):
            if i != j:
                w[i] *= (x - xj) / (xi - xj)
    return w


_W4_M = _lagrange_w(-0.25)
_W4_P = _lagrange_w(+0.25)


def prolong_cc4(c, cell_axes):
    """4th-order Lagrange prolongation (reference HighOrderProlongCC for
    Z4c/dyngr fields).  ``c`` carries TWO guard cells on each end of
    every axis in ``cell_axes``; the result doubles the trimmed
    interior."""
    import jax.numpy as jnp

    axes = [ax % c.ndim for ax in cell_axes]

    def conv(f, a, w):
        n = f.shape[a]
        out = None
        for o, wi in zip((-2, -1, 0, 1, 2), w):
            t = wi * jnp.take(f, np.arange(2 + o, n - 2 + o), axis=a)
            out = t if out is None else out + t
        return out

    for a in axes:
        lo = conv(c, a, _W4_M)
        hi = conv(c, a, _W4_P)
        c = _interleave(lo, hi, a)
        # restore the 2-cell guards on the axes not yet processed: conv
        # trimmed only axis a; the others keep their guards
    return c


def prolong_cc_order(c, cell_axes, order: int):
    if order == 4:
        return prolong_cc4(c, cell_axes)
    return prolong_cc(c, cell_axes)


def prolong_guard(order: int) -> int:
    """Coarse guard cells needed per side by the prolongation stencil."""
    return 2 if order == 4 else 1


def prolong_cc(c, cell_axes):
    """Piecewise-linear min-mod prolongation (reference ProlongCC).

    ``c`` carries one guard cell on each end of every axis in
    ``cell_axes``; the result doubles the trimmed interior of those axes.
    """
    import jax.numpy as jnp
    axes = [ax % c.ndim for ax in cell_axes]
    slopes = {}
    for a in axes:
        s = _minmod_slope(c, a)
        # trim the other axes' guard cells from this slope array
        for b in axes:
            if b != a:
                s = jnp.take(s, np.arange(1, s.shape[b] - 1), axis=b)
        slopes[a] = s
    for a in axes:
        c = jnp.take(c, np.arange(1, c.shape[a] - 1), axis=a)
    for a in axes:
        s = slopes.pop(a)
        c = _interleave(c - 0.25 * s, c + 0.25 * s, a)
        for b in list(slopes.keys()):
            slopes[b] = _interleave(slopes[b], slopes[b], a)
    return c
