"""Adaptive mesh refinement: criteria kernels, tree updates, and the
device-side data remap.

Parity target: the reference ``MeshRefinement`` + ``RefinementCriteria``
stack (reference: src/mesh/mesh_refinement.cpp:142-610,
src/mesh/refinement_criteria.cpp:28-390, src/mesh/load_balance.cpp).

Design:

  * Criteria are one jitted per-block reduction pass (max/min/slope/
    second-derivative over each block's active cells) producing an
    ``[nmb]`` flag vector; only that tiny vector crosses to the host.
  * The tree update runs on host in plain Python (split flagged leaves,
    2:1 ripple, coarsen complete families) exactly like the reference's
    ``UpdateMeshBlockTree`` — this is inherently serial logic.
  * The data remap is device-side and fully vectorized: for every block
    of the NEW tree we compute three candidates in parallel — same-gid
    copy, min-mod prolongation from the old parent octant (ProlongCC /
    ProlongFCShared* + Toth & Roe 2002 divergence-preserving internal
    faces), and conservative restriction of the old children — and
    select per block.  No per-block host loops, no host readback of
    field data.
  * After a tree change the mesh/bvals/physics objects are rebuilt and
    the jitted cycle recompiles (the reference likewise rebuilds its
    MeshBlockPack and flushes its buffers; XLA's compilation cache
    amortizes repeated tree shapes).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .indices import IDN
from .refinement import prolong_cc, restrict_cc

# mesh axis name -> cell axis in [nmb, nvar, n3, n2, n1]
_AXIS5 = {"x1": 4, "x2": 3, "x3": 2}


# ---------------------------------------------------------------------------
# refinement criteria (device)
# ---------------------------------------------------------------------------
class Criterion:
    """One parsed <amr_criterionN> block (reference:
    refinement_criteria.cpp:33-65)."""

    def __init__(self, pin, block: str) -> None:
        self.method = pin.get_string(block, "method")
        if self.method not in ("min_max", "slope", "second_deriv",
                               "location", "user"):
            raise ValueError(f"<{block}> method={self.method} unknown")
        self.variable = None
        if self.method not in ("location", "user"):
            self.variable = pin.get_string(block, "variable")
        self.value_min = pin.get_or_add_real(block, "value_min",
                                             -np.finfo(np.float32).max)
        self.value_max = pin.get_or_add_real(block, "value_max",
                                             np.finfo(np.float32).max)
        self.loc_x1 = pin.get_or_add_real(block, "location_x1", 0.0)
        self.loc_x2 = pin.get_or_add_real(block, "location_x2", 0.0)
        self.loc_x3 = pin.get_or_add_real(block, "location_x3", 0.0)
        self.loc_rad = pin.get_or_add_real(block, "location_rad", 0.0)


def _crit_data(crit: Criterion, state, phys):
    """The [nmb, n3, n2, n1] array a criterion reduces over (reference:
    SetRefinementData, refinement_criteria.cpp:120-175)."""
    v = crit.variable
    if v in ("hydro_u_d", "mhd_u_d"):
        return state["u"][:, IDN]
    if v in ("hydro_w_d", "mhd_w_d"):
        return state["w"][:, IDN]
    if v == "rad_coord_e":
        # coordinate-frame energy density R^00 (radiation AMR)
        return phys.coord_energy_density(state)
    raise ValueError(f"unknown refinement variable '{v}'")


def make_flag_fn(criteria: List[Criterion], phys, mesh,
                 z4c_amr=None) -> Callable:
    """Jitted flags(state) -> int32 [nmb]: +1 refine, -1 derefinable, 0
    keep (reference: CheckMinMax/CheckSlope/CheckSecondDeriv kernels)."""
    mbi = mesh.mb_indcs
    ng = mbi.ng
    act = []
    if mbi.nx1 > 1:
        act.append((3, mbi.nx1))
    if mbi.nx2 > 1:
        act.append((2, mbi.nx2))
    if mbi.nx3 > 1:
        act.append((1, mbi.nx3))
    red_axes = (1, 2, 3)
    flt_max = float(np.finfo(np.float32).max)

    def interior(q):
        for ax, nx in act:
            q = jax.lax.slice_in_dim(q, ng, ng + nx, axis=ax)
        return q

    def flags(state):
        flag = jnp.zeros(state["u"].shape[0], dtype=jnp.int32)
        if z4c_amr is not None and z4c_amr.method in ("chi", "dchi"):
            flag = z4c_amr.device_flags(state["u"], mesh)
        for crit in criteria:
            if crit.method in ("location", "user"):
                continue  # host-side / hook
            q = _crit_data(crit, state, phys)
            if crit.method == "min_max":
                if crit.value_max < flt_max:
                    qmax = jnp.max(interior(q), axis=red_axes)
                    flag = jnp.where(qmax > crit.value_max, 1, flag)
                    flag = jnp.where((qmax < crit.value_max) & (flag == 0),
                                     -1, flag)
                if crit.value_min > -flt_max:
                    qmin = jnp.min(interior(q), axis=red_axes)
                    flag = jnp.where(qmin < crit.value_min, 1, flag)
                    flag = jnp.where((qmin > crit.value_min) & (flag == 0),
                                     -1, flag)
            elif crit.method == "slope":
                # max |dq|/q with centered differences (reference:
                # CheckSlope, refinement_criteria.cpp:240-280)
                d2 = 0.0
                for ax, _ in act:
                    d2 = d2 + (jnp.roll(q, -1, axis=ax)
                               - jnp.roll(q, 1, axis=ax)) ** 2
                dq = interior(0.5 * jnp.sqrt(d2) / q)
                dqmax = jnp.max(dq, axis=red_axes)
                flag = jnp.where(dqmax > crit.value_max, 1, flag)
                flag = jnp.where((dqmax < crit.value_max) & (flag == 0),
                                 -1, flag)
            elif crit.method == "second_deriv":
                d2q = 0.0
                for ax, _ in act:
                    d2q = d2q + (jnp.roll(q, -1, axis=ax) - 2.0 * q
                                 + jnp.roll(q, 1, axis=ax))
                dq = interior(jnp.abs(d2q) / q)
                dqmax = jnp.max(dq, axis=red_axes)
                flag = jnp.where(dqmax > crit.value_max, 1, flag)
                flag = jnp.where((dqmax < crit.value_max) & (flag == 0),
                                 -1, flag)
        return flag

    return jax.jit(flags)


def location_flags(crit: Criterion, mesh) -> np.ndarray:
    """Host check: +1 for blocks overlapping the cube of half-width rad
    around (x1,x2,x3) (reference: CheckLocation,
    refinement_criteria.cpp:345-390)."""
    nmb = mesh.nmb_total
    out = np.zeros(nmb, dtype=np.int32)
    sz = mesh.mb_size

    def overlaps(lo, hi, c, r):
        return ((lo < c + r) & (lo > c - r)) | ((hi < c + r) & (hi > c - r)) \
            | ((hi > c + r) & (lo < c - r))

    hit = overlaps(sz["x1min"], sz["x1max"], crit.loc_x1, crit.loc_rad)
    if mesh.multi_d:
        hit &= overlaps(sz["x2min"], sz["x2max"], crit.loc_x2, crit.loc_rad)
    if mesh.three_d:
        hit &= overlaps(sz["x3min"], sz["x3max"], crit.loc_x3, crit.loc_rad)
    out[hit] = 1
    return out


# ---------------------------------------------------------------------------
# tree update (host)
# ---------------------------------------------------------------------------
def _zorder(leaves, nrbx, active):
    max_lev = max((k[0] for k in leaves), default=0)
    nb = max(nrbx) << max_lev
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

    return sorted(leaves, key=zkey)


def update_tree(leaves: List[Tuple[int, int, int, int]],
                flags: np.ndarray,
                nrbx, active, wraps, max_level: int):
    """Apply refine/derefine flags to the leaf list (reference:
    UpdateMeshBlockTree, mesh_refinement.cpp:274-415).

    Returns (new_leaves, prov) where prov[i] describes new leaf i:
      ("same", old_gid) | ("refined", old_parent_gid, (o1,o2,o3)) |
      ("derefined", [old_child_gids in x1-fast quadrant order]).
    Returns (None, None) when the tree is unchanged.
    """
    # keys are (lev, l1, l2, l3)
    old_gid = {}
    for gid, (l1, l2, l3, lev) in enumerate(leaves):
        old_gid[(lev, l1, l2, l3)] = gid
    S = set(old_gid)
    flag = {k: int(flags[g]) for k, g in old_gid.items()}

    def extent(lev):
        return (nrbx[0] << lev,
                (nrbx[1] << lev) if active[1] else nrbx[1],
                (nrbx[2] << lev) if active[2] else nrbx[2])

    def covering(lev, l1, l2, l3):
        for up in range(lev, -1, -1):
            s = lev - up
            key = (up, l1 >> s,
                   (l2 >> s) if active[1] else l2,
                   (l3 >> s) if active[2] else l3)
            if key in S:
                return key
        return None

    def neighbors(key):
        """26-neighborhood cells of a leaf at its own level, with periodic
        wrap; out-of-domain non-periodic cells skipped."""
        lev, l1, l2, l3 = key
        n = extent(lev)
        for d3 in ((-1, 0, 1) if active[2] else (0,)):
            for d2 in ((-1, 0, 1) if active[1] else (0,)):
                for d1 in (-1, 0, 1):
                    if d1 == d2 == d3 == 0:
                        continue
                    t = [l1 + d1, l2 + d2, l3 + d3]
                    ok = True
                    for ax, nm in ((0, "x1"), (1, "x2"), (2, "x3")):
                        if not (0 <= t[ax] < n[ax]):
                            if wraps[nm]:
                                t[ax] %= n[ax]
                            else:
                                ok = False
                    if ok:
                        yield (lev, t[0], t[1], t[2])

    parent_of: Dict[tuple, tuple] = {}   # new child key -> old parent key

    def split(key):
        lev, l1, l2, l3 = key
        S.discard(key)
        for o3 in range(2 if active[2] else 1):
            for o2 in range(2 if active[1] else 1):
                for o1 in range(2):
                    ck = (lev + 1, 2 * l1 + o1,
                          (2 * l2 + o2) if active[1] else l2,
                          (2 * l3 + o3) if active[2] else l3)
                    S.add(ck)
                    parent_of[ck] = key

    # ---- step 1: refinement + 2:1 ripple
    queue = [k for k in S if flag.get(k, 0) > 0 and k[0] < max_level]
    while queue:
        k = queue.pop()
        if k not in S:
            continue
        split(k)
        # any adjacent coarser leaf must now be at least level k.lev
        for nb in neighbors(k):
            cov = covering(*nb)
            if cov is not None and cov[0] < k[0]:
                queue.append(cov)

    nnew = len(parent_of)

    # ---- step 2: derefinement of complete families
    # group -1 leaves (not created this event) by parent key
    fams: Dict[tuple, list] = {}
    for k in S:
        if k in parent_of or flag.get(k, 0) >= 0 or k[0] == 0:
            continue
        lev, l1, l2, l3 = k
        pk = (lev - 1, l1 >> 1,
              (l2 >> 1) if active[1] else l2,
              (l3 >> 1) if active[2] else l3)
        fams.setdefault(pk, []).append(k)

    nq = 2 * (2 if active[1] else 1) * (2 if active[2] else 1)
    derefined: Dict[tuple, list] = {}     # parent key -> child keys (ordered)
    for pk, kids in fams.items():
        if len(kids) != nq:
            continue
        # 2:1 after coarsening: no leaf strictly finer than pk.lev+1 may
        # touch pk's neighborhood
        plev = pk[0]
        ok = True
        for nb in neighbors(pk):
            nlev, t1, t2, t3 = nb
            # check for any leaf deeper than plev+1 inside this cell
            for k2 in S:
                if k2[0] <= plev + 1:
                    continue
                s = k2[0] - plev
                if (k2[1] >> s) == t1 \
                        and ((k2[2] >> s) if active[1] else k2[2]) == t2 \
                        and ((k2[3] >> s) if active[2] else k2[3]) == t3:
                    ok = False
                    break
            if not ok:
                break
        if not ok:
            continue
        # quadrant order: x1 fastest, then x2, then x3
        ordered = []
        for o3 in range(2 if active[2] else 1):
            for o2 in range(2 if active[1] else 1):
                for o1 in range(2):
                    ck = (plev + 1, 2 * pk[1] + o1,
                          (2 * pk[2] + o2) if active[1] else pk[2],
                          (2 * pk[3] + o3) if active[2] else pk[3])
                    ordered.append(ck)
        for ck in ordered:
            S.discard(ck)
        S.add(pk)
        derefined[pk] = ordered

    if nnew == 0 and not derefined:
        return None, None

    new_leaves = _zorder(S, nrbx, active)
    prov = []
    for k in new_leaves:
        if k in old_gid:
            prov.append(("same", old_gid[k]))
        elif k in parent_of:
            pk = parent_of[k]
            o1 = k[1] & 1
            o2 = (k[2] & 1) if active[1] else 0
            o3 = (k[3] & 1) if active[2] else 0
            prov.append(("refined", old_gid[pk], (o1, o2, o3)))
        elif k in derefined:
            prov.append(("derefined",
                         [old_gid[ck] for ck in derefined[k]]))
        else:  # pragma: no cover
            raise RuntimeError(f"leaf {k} has no provenance")
    return [(l1, l2, l3, lev) for (lev, l1, l2, l3) in new_leaves], prov


# ---------------------------------------------------------------------------
# data remap (device, vectorized over blocks)
# ---------------------------------------------------------------------------
def _prov_tables(prov) -> Dict[str, np.ndarray]:
    nmb_new = len(prov)
    nqmax = max((len(p[1]) for p in prov if p[0] == "derefined"),
                default=1)
    mode = np.zeros(nmb_new, dtype=np.int32)
    src = np.zeros(nmb_new, dtype=np.int32)
    octant = np.zeros((nmb_new, 3), dtype=np.int32)
    child = np.zeros((nmb_new, nqmax), dtype=np.int32)
    for i, p in enumerate(prov):
        if p[0] == "same":
            src[i] = p[1]
        elif p[0] == "refined":
            mode[i] = 1
            src[i] = p[1]
            octant[i] = p[2]
        else:
            mode[i] = 2
            child[i] = p[1]
    return {"mode": mode, "src": src, "octant": octant, "child": child}


def remap_cc(arr, tbl, mbi, act_axes, force=False):
    """Remap a cell-centered array [nmb_old, C, n3, n2, n1] onto the new
    tree (reference: RefineCC + DerefineCCSameRank,
    mesh_refinement.cpp:560-740)."""
    ng = mbi.ng
    h = ng // 2
    nx_of = {"x1": mbi.nx1, "x2": mbi.nx2, "x3": mbi.nx3}
    nc_of = {"x1": mbi.ncells1, "x2": mbi.ncells2, "x3": mbi.ncells3}
    mode = tbl["mode"]
    nd = arr.ndim  # 5

    cand = jnp.take(arr, tbl["src"], axis=0)

    # ---- refined: min-mod prolongation of the parent octant
    # (force=True traces both modes for the fixed-capacity pool remap)
    if force or (mode == 1).any():
        par = cand  # refined slots hold the parent gid
        win = par
        for ax in act_axes:
            a = _AXIS5[ax]
            nx = nx_of[ax]
            ln = nc_of[ax] // 2 + 2
            s0 = ng - h - 1
            w0 = jnp.take(win, np.arange(s0, s0 + ln), axis=a)
            w1 = jnp.take(win, np.arange(s0 + nx // 2, s0 + nx // 2 + ln),
                          axis=a)
            bit = tbl["octant"][:, {"x1": 0, "x2": 1, "x3": 2}[ax]]
            sel = jnp.asarray(bit.astype(bool)).reshape(
                (-1,) + (1,) * (nd - 1))
            win = jnp.where(sel, w1, w0)
        pro = prolong_cc(win, [_AXIS5[ax] - 5 for ax in act_axes])
        m = jnp.asarray(mode == 1).reshape((-1,) + (1,) * (nd - 1))
        cand = jnp.where(m, pro, cand)

    # ---- derefined: restrict + quadrant-assemble the old children
    if force or (mode == 2).any():
        caxes = [_AXIS5[ax] - 5 for ax in act_axes]
        parts = [restrict_cc(jnp.take(arr, tbl["child"][:, q], axis=0),
                             caxes)
                 for q in range(tbl["child"].shape[1])]
        for ax in act_axes:
            a = _AXIS5[ax]
            half = nx_of[ax] // 2
            merged = []
            for b in range(0, len(parts), 2):
                lo = jnp.take(parts[b], np.arange(h, h + half), axis=a)
                hi = jnp.take(parts[b + 1], np.arange(h, h + half), axis=a)
                merged.append(jnp.concatenate([lo, hi], axis=a))
            parts = merged
        asm = parts[0]
        # pad ghost rings with edge values (refilled by the exchange)
        pads = [(0, 0)] * nd
        for ax in act_axes:
            pads[_AXIS5[ax]] = (ng, ng)
        asm = jnp.pad(asm, pads, mode="edge")
        m = jnp.asarray(mode == 2).reshape((-1,) + (1,) * (nd - 1))
        cand = jnp.where(m, asm, cand)
    return cand


# ---- face-centered ------------------------------------------------------
_FC_NORMAL = {"x1f": "x1", "x2f": "x2", "x3f": "x3"}
# array axis of the normal direction in a 4D [nmb, n3, n2, n1(+1)] FC array
_AXIS4 = {"x1": 3, "x2": 2, "x3": 1}


def remap_fc(bfc, tbl, mbi, act_axes, force=False):
    """Remap staggered face fields onto the new tree: area-average
    restriction on coarse faces, min-mod shared-face prolongation +
    Toth & Roe internal reconstruction on refined blocks (reference:
    RefineFC/DerefineFCSameRank + ProlongFCShared*/ProlongFCInternal,
    src/mesh/prolongation.hpp:62-240)."""
    ng = mbi.ng
    h = ng // 2
    nx_of = {"x1": mbi.nx1, "x2": mbi.nx2, "x3": mbi.nx3}
    nc_of = {"x1": mbi.ncells1, "x2": mbi.ncells2, "x3": mbi.ncells3}
    mode = tbl["mode"]
    out = {}
    refined_any = force or bool((mode == 1).any())
    deref_any = force or bool((mode == 2).any())

    for comp, arr in bfc.items():
        nrm = _FC_NORMAL[comp]
        na = _AXIS4[nrm]
        nd = arr.ndim  # 4
        t_axes = [ax for ax in act_axes if ax != nrm]
        nx = nx_of[nrm]
        normal_active = nrm in act_axes

        cand = jnp.take(arr, tbl["src"], axis=0)

        if refined_any:
            # shared planes: parent faces of the octant, prolonged in the
            # transverse directions (ProlongFCShared*)
            win = cand
            # normal: active coarse faces of the octant (nx/2+1 planes)
            if normal_active:
                bit_n = tbl["octant"][:, {"x1": 0, "x2": 1, "x3": 2}[nrm]]
                s0 = ng
                ln = nx // 2 + 1
                w0 = jnp.take(win, np.arange(s0, s0 + ln), axis=na)
                w1 = jnp.take(win, np.arange(s0 + nx // 2, s0 + nx + 1),
                              axis=na)
                sel = jnp.asarray(bit_n.astype(bool)).reshape(
                    (-1,) + (1,) * (nd - 1))
                win = jnp.where(sel, w1, w0)
            for ax in t_axes:
                a = _AXIS4[ax]
                nxt = nx_of[ax]
                ln = nc_of[ax] // 2 + 2
                s0 = ng - h - 1
                w0 = jnp.take(win, np.arange(s0, s0 + ln), axis=a)
                w1 = jnp.take(win, np.arange(s0 + nxt // 2,
                                             s0 + nxt // 2 + ln), axis=a)
                bit = tbl["octant"][:, {"x1": 0, "x2": 1, "x3": 2}[ax]]
                sel = jnp.asarray(bit.astype(bool)).reshape(
                    (-1,) + (1,) * (nd - 1))
                win = jnp.where(sel, w1, w0)
            shared = prolong_cc(win, [_AXIS4[ax] - 4 for ax in t_axes]) \
                if t_axes else win
            # scatter the shared planes onto even fine faces; odd faces
            # are filled by the internal Toth-Roe pass afterwards
            pro = jnp.zeros_like(cand)
            if normal_active:
                pro = pro.at[_slc4(na, slice(ng, ng + nx + 1, 2))].set(
                    shared)
            else:
                pro = shared
            m = jnp.asarray(mode == 1).reshape((-1,) + (1,) * (nd - 1))
            cand = jnp.where(m, pro, cand)

        if deref_any:
            ct_axes = [_AXIS4[ax] - 4 for ax in t_axes]
            parts = []
            for q in range(tbl["child"].shape[1]):
                ch = jnp.take(arr, tbl["child"][:, q], axis=0)
                if normal_active:
                    # sample even (coarse-coincident) active faces
                    ch = jnp.take(ch, np.arange(ng, ng + nx + 1, 2),
                                  axis=na)
                ch = restrict_cc(ch, ct_axes) if ct_axes else ch
                parts.append(ch)
            # assemble quadrants: x1 fastest (matches update_tree order)
            for ax in act_axes:
                if ax == nrm:
                    if not normal_active:
                        continue
                    # merge along the normal: child0 faces [0, nx/2),
                    # child1 faces [nx/2, nx]
                    a = na
                    merged = []
                    for b in range(0, len(parts), 2):
                        lo = jnp.take(parts[b], np.arange(0, nx // 2),
                                      axis=a)
                        hi = parts[b + 1]
                        merged.append(jnp.concatenate([lo, hi], axis=a))
                    parts = merged
                else:
                    a = _AXIS4[ax]
                    half = nx_of[ax] // 2
                    merged = []
                    for b in range(0, len(parts), 2):
                        lo = jnp.take(parts[b], np.arange(h, h + half),
                                      axis=a)
                        hi = jnp.take(parts[b + 1],
                                      np.arange(h, h + half), axis=a)
                        merged.append(jnp.concatenate([lo, hi], axis=a))
                    parts = merged
            asm = parts[0]
            pads = [(0, 0)] * nd
            for ax in act_axes:
                pads[_AXIS4[ax]] = (ng, ng)
            asm = jnp.pad(asm, pads, mode="edge")
            m = jnp.asarray(mode == 2).reshape((-1,) + (1,) * (nd - 1))
            cand = jnp.where(m, asm, cand)
        out[comp] = cand
    return out


def _slc4(axis, s):
    idx = [slice(None)] * 4
    idx[axis] = s
    return tuple(idx)


def fc_internal(bfc, mbi, act_axes, mask):
    """Recompute the fine faces interior to each coarse cell from the
    (even) shared planes with the divergence-preserving scheme of
    Toth & Roe JCP 180, 736 (2002) on ``mask``-flagged blocks
    (reference: ProlongFCInternal, src/mesh/prolongation.hpp:170-240;
    also used as the post-exchange RepairAMRFC pass,
    mesh_refinement.cpp RepairAMRFC)."""
    ng = mbi.ng
    nx1, nx2, nx3 = mbi.nx1, mbi.nx2, mbi.nx3
    x1f, x2f = bfc["x1f"], bfc["x2f"]
    x3f = bfc.get("x3f")
    three_d = "x3" in act_axes
    two_d = ("x2" in act_axes) and not three_d
    mb = jnp.asarray(mask).reshape((-1, 1, 1, 1))

    if not ("x2" in act_axes or three_d):
        # 1D: internal x1-faces are the average of the flanking shared faces
        ev = x1f[..., ng:ng + nx1 + 1:2]
        internal = 0.5 * (ev[..., :-1] + ev[..., 1:])
        new = x1f.at[..., ng + 1:ng + nx1:2].set(
            jnp.where(mb, internal, x1f[..., ng + 1:ng + nx1:2]))
        return dict(bfc, x1f=new)

    if two_d:
        # fine rows/cols inside the active region; coarse cell (jc, ic)
        # has fine origin (fj, fi) = (ng+2jc, ng+2ic)
        fi0 = np.arange(ng, ng + nx1, 2)       # fi  (even cols)
        fj0 = np.arange(ng, ng + nx2, 2)       # fj  (even rows)
        ix = np.ix_
        # b.x1f at (fj+r, fi), (fj+r, fi+2); b.x2f at (fj or fj+2, fi+c)
        x1_l = x1f[:, :, :, fi0][:, :, fj0, :], \
            x1f[:, :, :, fi0][:, :, fj0 + 1, :]
        x1_r = x1f[:, :, :, fi0 + 2][:, :, fj0, :], \
            x1f[:, :, :, fi0 + 2][:, :, fj0 + 1, :]
        x2_b = x2f[:, :, fj0, :]
        x2_t = x2f[:, :, fj0 + 2, :]
        tmp1 = 0.25 * (x2_t[:, :, :, fi0 + 1] - x2_b[:, :, :, fi0 + 1]
                       - x2_t[:, :, :, fi0] + x2_b[:, :, :, fi0])
        tmp2 = 0.25 * (x1_l[0] - x1_r[0] - x1_l[1] + x1_r[1])
        # x1f internal (odd cols), both fine rows
        v_r0 = 0.5 * (x1_l[0] + x1_r[0]) + tmp1
        v_r1 = 0.5 * (x1_l[1] + x1_r[1]) + tmp1
        new1 = x1f
        cur = new1[:, :, :, fi0 + 1]
        upd = cur
        upd = upd.at[:, :, fj0, :].set(v_r0)
        upd = upd.at[:, :, fj0 + 1, :].set(v_r1)
        new1 = new1.at[:, :, :, fi0 + 1].set(jnp.where(mb, upd, cur))
        # x2f internal (odd rows), both fine cols
        w_c0 = 0.5 * (x2_b[:, :, :, fi0] + x2_t[:, :, :, fi0]) + tmp2
        w_c1 = 0.5 * (x2_b[:, :, :, fi0 + 1] + x2_t[:, :, :, fi0 + 1]) \
            + tmp2
        new2 = x2f
        cur = new2[:, :, fj0 + 1, :]
        upd = cur
        upd = upd.at[:, :, :, fi0].set(w_c0)
        upd = upd.at[:, :, :, fi0 + 1].set(w_c1)
        new2 = new2.at[:, :, fj0 + 1, :].set(jnp.where(mb, upd, cur))
        return dict(bfc, x1f=new1, x2f=new2)

    # ---- 3D (reference: ProlongFCInternal three_d branch)
    fi0 = np.arange(ng, ng + nx1, 2)
    fj0 = np.arange(ng, ng + nx2, 2)
    fk0 = np.arange(ng, ng + nx3, 2)

    def g1(r, c, off):   # x1f at (fk0+r, fj0+c, fi0+off)
        return x1f[:, fk0 + r][:, :, fj0 + c][:, :, :, fi0 + off]

    def g2(r, c, off):   # x2f at (fk0+r, fj0+c, fi0+off)
        return x2f[:, fk0 + r][:, :, fj0 + c][:, :, :, fi0 + off]

    def g3(r, c, off):   # x3f at (fk0+r, fj0+c, fi0+off)
        return x3f[:, fk0 + r][:, :, fj0 + c][:, :, :, fi0 + off]

    Uxx = 0.0
    Vyy = 0.0
    Wzz = 0.0
    Uxyz = 0.0
    Vxyz = 0.0
    Wxyz = 0.0
    for jj in (0, 1):
        jsgn = 2 * jj - 1
        fjj, fjp = jj, 2 * jj
        for ii in (0, 1):
            isgn = 2 * ii - 1
            fii, fip = ii, 2 * ii
            Uxx = Uxx + isgn * (jsgn * (g2(0, fjp, fii) + g2(1, fjp, fii))
                                + (g3(2, fjj, fii) - g3(0, fjj, fii)))
            Vyy = Vyy + jsgn * ((g3(2, fjj, fii) - g3(0, fjj, fii))
                                + isgn * (g1(0, fjj, fip)
                                          + g1(1, fjj, fip)))
            Wzz = Wzz + isgn * (g1(1, fjj, fip) - g1(0, fjj, fip)) \
                + jsgn * (g2(1, fjp, fii) - g2(0, fjp, fii))
            Uxyz = Uxyz + isgn * jsgn * (g1(1, fjj, fip) - g1(0, fjj, fip))
            Vxyz = Vxyz + isgn * jsgn * (g2(1, fjp, fii) - g2(0, fjp, fii))
            Wxyz = Wxyz + isgn * jsgn * (g3(2, fjj, fii) - g3(0, fjj, fii))
    Uxx, Vyy, Wzz = 0.125 * Uxx, 0.125 * Vyy, 0.125 * Wzz
    Uxyz, Vxyz, Wxyz = 0.0625 * Uxyz, 0.0625 * Vxyz, 0.0625 * Wxyz

    def setmask(arr, k_off, j_off, i_off, idxs, vals):
        """Masked scatter of per-coarse-cell values at fine offsets."""
        fk, fj, fi = idxs
        cur = arr[:, fk + k_off][:, :, fj + j_off][:, :, :, fi + i_off]
        return arr.at[np.ix_(np.arange(arr.shape[0]), fk + k_off,
                             fj + j_off, fi + i_off)].set(
            jnp.where(mb, vals, cur))

    idxs = (fk0, fj0, fi0)
    new1 = x1f
    for kk in (0, 1):
        for jj in (0, 1):
            sK = 1 if kk else -1
            sJ = 1 if jj else -1
            val = 0.5 * (g1(kk, jj, 0) + g1(kk, jj, 2)) \
                + Uxx + sK * Vxyz + sJ * Wxyz
            new1 = setmask(new1, kk, jj, 1, idxs, val)
    new2 = x2f
    for kk in (0, 1):
        for ii in (0, 1):
            sK = 1 if kk else -1
            sI = 1 if ii else -1
            val = 0.5 * (g2(kk, 0, ii) + g2(kk, 2, ii)) \
                + Vyy + sK * Uxyz + sI * Wxyz
            new2 = setmask(new2, kk, 1, ii, idxs, val)
    new3 = x3f
    for jj in (0, 1):
        for ii in (0, 1):
            sJ = 1 if jj else -1
            sI = 1 if ii else -1
            val = 0.5 * (g3(0, jj, ii) + g3(2, jj, ii)) \
                + Wzz + sJ * Uxyz + sI * Vxyz
            new3 = setmask(new3, 1, jj, ii, idxs, val)
    return dict(bfc, x1f=new1, x2f=new2, x3f=new3)


# ---------------------------------------------------------------------------
# the AMR orchestrator
# ---------------------------------------------------------------------------
class AMR:
    """Adaptive refinement driver: criteria -> tree update -> rebuild ->
    remap (reference: MeshRefinement::AdaptiveMeshRefinement,
    mesh_refinement.cpp:142-195)."""

    def __init__(self, pin, mesh) -> None:
        self.pin = pin
        self.ncycle_check = int(pin.get_or_add_real(
            "mesh_refinement", "ncycle_check", 1))
        self.refinement_interval = int(pin.get_or_add_real(
            "mesh_refinement", "refinement_interval", 5))
        user_max_nmb = pin.does_parameter_exist("mesh_refinement",
                                                "max_nmb_per_rank")
        self.max_nmb = pin.get_or_add_integer(
            "mesh_refinement", "max_nmb_per_rank", 2 ** 16)
        self.criteria = [Criterion(pin, b) for b in pin.blocks
                         if b.startswith("amr_criterion")]
        # Z4c strategies: every adaptive Z4c deck gets a <z4c_amr>
        # handler (default method=trivial + radius shells), like the
        # reference constructs Z4c_AMR unconditionally (z4c.cpp)
        self.z4c_amr = None
        if "z4c" in pin.blocks or "z4c_amr" in pin.blocks:
            from .z4c.z4c_amr import Z4cAMR
            self.z4c_amr = Z4cAMR(pin)
        if not self.criteria and self.z4c_amr is None:
            raise ValueError("refinement=adaptive requires at least one "
                             "<amr_criterion> block")
        # pgen-enrolled hook: fn(state, mesh) -> int flags [nmb]
        # (reference: pgen user_ref_func, src/pgen/pgen.hpp)
        self.user_ref_func = None
        self.ncyc_since_ref = np.zeros(mesh.nmb_total, dtype=np.int64)
        self.nmb_created = 0
        self.nmb_deleted = 0
        self._flag_fn = None
        # fixed-capacity block pool (amr_pool.py): one compiled cycle for
        # the whole run (reference nmb_maxperrank, mesh.hpp:121)
        self.use_pool = bool(getattr(mesh, "amr_pool", False))
        self.capacity = 0
        if self.use_pool:
            # capacity ladder: start tight (low padding waste), double
            # when the tree outgrows it — at most log2(max/initial)
            # recompiles over the whole run
            if user_max_nmb:
                hard = self.max_nmb
            else:
                ndim = (1 + (mesh.mb_indcs.nx2 > 1)
                        + (mesh.mb_indcs.nx3 > 1))
                nroot = mesh.tree_nrbx[0] \
                    * (mesh.tree_nrbx[1] if mesh.mb_indcs.nx2 > 1 else 1) \
                    * (mesh.tree_nrbx[2] if mesh.mb_indcs.nx3 > 1 else 1)
                hard = nroot * (2 ** ndim) ** mesh.max_allowed_level
                self.max_nmb = hard
            self.capacity = min(hard, max(2 * mesh.nmb_total, 16))
        self.pool_T = None          # device table pytree (current tree)
        self._pool_cycle = None     # jitted (state, dt, T) cycle
        self._pool_dt = None        # jitted (state, T) dt
        self._pool_remap = None     # jitted (state, tbl, T, mask) remap

    # ------------------------------------------------------------------
    def check_flags(self, state, mesh, phys, layout=None) -> np.ndarray:
        if self._flag_fn is None:
            self._flag_fn = make_flag_fn(self.criteria, phys, mesh,
                                         z4c_amr=self.z4c_amr)
        flags = np.asarray(self._flag_fn(state)).copy()
        if layout is not None:
            flags = flags[layout.slot_of_gid]  # slot order -> gid order
        else:
            flags = flags[:mesh.nmb_total]  # drop block-pool pad slots
        for crit in self.criteria:
            if crit.method == "location":
                loc = location_flags(crit, mesh)
                flags = np.where(loc > 0, 1, flags)
            elif crit.method == "user":
                if self.user_ref_func is None:
                    raise ValueError("<amr_criterion> method=user needs an "
                                     "enrolled user_ref_func")
                uf = np.asarray(self.user_ref_func(state, mesh))
                uf = uf[layout.slot_of_gid] if layout is not None \
                    else uf[:mesh.nmb_total]
                flags = np.where(uf != 0, uf, flags)
        if self.z4c_amr is not None:
            flags = self.z4c_amr.host_flags(flags, state, mesh, phys)
        # vetoes (reference: CheckForRefinement tail,
        # mesh_refinement.cpp:244-256)
        lev = mesh.mb_lev
        flags[(lev >= mesh.max_allowed_level) & (flags > 0)] = 0
        flags[(lev == 0) & (flags < 0)] = 0
        flags[self.ncyc_since_ref < self.refinement_interval] = 0
        return flags

    # ---------------------------------------------------- block pool mode
    def init_pool(self, driver, state):
        """Pad the state to capacity and stage the current tree's tables
        (amr_pool.py; reference: nmb_maxperrank preallocation)."""
        from .amr_pool import extract_tables, pool_pad_state

        mesh, phys = driver.mesh, driver.phys
        self.pool_T = self._put_tables(
            extract_tables(mesh, phys.bvals, self.capacity), driver)
        driver._npad = self.capacity - mesh.nmb_total
        return pool_pad_state(state, mesh.nmb_total, self.capacity)

    def _put_tables(self, T, driver):
        """Stage the table pytree on device; replicated across a device
        mesh (the traced gather indices must be whole on every device —
        the reference analogue is every rank holding the full neighbor
        metadata, src/mesh/mesh.hpp:176-184)."""
        if driver.dmesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            rep = NamedSharding(driver.dmesh, PartitionSpec())
            return jax.device_put(T, rep)
        return jax.device_put(T)

    def pool_dt(self, driver, state) -> float:
        """Post-update dt through the pooled (compile-once) dt fn."""
        from .amr_pool import installed

        if self._pool_dt is None:
            mesh, phys = driver.mesh, driver.phys
            bvals = phys.bvals

            def fn(s, T):
                with installed(mesh, bvals, T, phys):
                    return phys.dt_from_state(s)

            self._pool_dt = jax.jit(fn)
        return float(self._pool_dt(state, self.pool_T))

    def rebuild_pool(self, driver, state, new_leaves, prov, outputs=()):
        """Tree update without recompilation: rebuild the host objects,
        refresh the table pytree, and remap through one jitted
        (state, prov-tables, new-tables) function."""
        from .bvals import BoundaryValues
        from .main import make_physics
        from .mesh import Mesh
        from .amr_pool import (extract_tables, installed,
                               prov_tables_padded)

        old_mesh = driver.mesh
        old_phys = driver.phys
        mesh = Mesh(self.pin, leaves=new_leaves)
        mesh.time = old_mesh.time
        mesh.dt = old_mesh.dt
        mesh.dtold = old_mesh.dtold
        mesh.ncycle = old_mesh.ncycle
        bvals = BoundaryValues(mesh)
        phys = make_physics(self.pin, mesh, bvals)
        bvals.inflow_state = old_phys.bvals.inflow_state
        bvals.user_bc_func = old_phys.bvals.user_bc_func
        if hasattr(old_phys, "srcterms_func"):
            phys.srcterms_func = old_phys.srcterms_func

        mbi = mesh.mb_indcs
        act_axes = ["x1"]
        if mbi.nx2 > 1:
            act_axes.append("x2")
        if mbi.nx3 > 1:
            act_axes.append("x3")
        nquad = 2 ** len(act_axes)
        while mesh.nmb_total > self.capacity:
            # climb the capacity ladder (shape change -> one recompile:
            # the jitted pool programs cache one entry per rung)
            self.capacity = min(2 * self.capacity, self.max_nmb)
        if driver.dmesh is not None:
            ndev = driver.dmesh.devices.size
            self.capacity = -(-self.capacity // ndev) * ndev
        tbl = prov_tables_padded(prov, old_mesh.nmb_total, self.capacity,
                                 nquad)
        T_new = self._put_tables(extract_tables(mesh, bvals,
                                                self.capacity), driver)

        if self._pool_remap is None:
            def remap(st, tb, T):
                new_state = dict(st)
                for key in ("u", "w"):
                    if key in st:
                        new_state[key] = remap_cc(st[key], tb, mbi,
                                                  act_axes, force=True)
                if "bfc" in st:
                    refined = tb["mode"] == 1
                    bfc = remap_fc(st["bfc"], tb, mbi, act_axes,
                                   force=True)
                    bfc = fc_internal(bfc, mbi, act_axes, refined)
                    new_state["bfc"] = bfc
                with installed(mesh, bvals, T, phys):
                    new_state = phys.init_ghosts(new_state)
                    if "bfc" in new_state:
                        bfc = fc_internal(new_state["bfc"], mbi, act_axes,
                                          tb["mode"] == 1)
                        new_state = phys.init_ghosts(
                            dict(new_state, bfc=bfc))
                return new_state

            self._pool_remap = jax.jit(remap, donate_argnums=(0,))

        state = self._pool_remap(state, tbl, T_new)
        if driver.dmesh is not None:
            from .parallel import shard_state
            state = shard_state(state, driver.dmesh)
        self.pool_T = T_new

        driver.mesh = mesh
        driver.phys = phys
        driver._npad = self.capacity - mesh.nmb_total
        for out in outputs:
            if hasattr(out, "phys"):
                out.phys = phys
            if hasattr(out, "mesh"):
                out.mesh = mesh

        counts = np.zeros(mesh.nmb_total, dtype=np.int64)
        for i, p in enumerate(prov):
            if p[0] == "same":
                counts[i] = self.ncyc_since_ref[p[1]]
        self.ncyc_since_ref = counts
        return state

    # ------------------------------------------------------------------
    def step(self, driver, state, outputs=()):
        """One AMR pass.  Returns (state, changed).

        On a device mesh this is also the block-redistribution step
        (reference: RedistAndRefineMeshBlocks + LoadBalance over the AMR
        communicator, mesh_refinement.cpp:427-560): the padded/sharded
        state is unpacked to gid order, remapped onto the new tree, and
        re-packed into the new tree's cost-weighted ShardLayout; the
        shard cycle (ppermute routes) is retraced for the new epoch."""
        mesh = driver.mesh
        phys = driver.phys
        self.ncyc_since_ref += 1
        if mesh.ncycle % self.ncycle_check != 0:
            return state, False
        lay = getattr(driver, "_layout", None)
        flags = self.check_flags(state, mesh, phys, layout=lay)
        wraps = {ax: mesh.mesh_bcs[f"i{ax}"] in ("periodic",
                                                 "shear_periodic")
                 for ax in ("x1", "x2", "x3")}
        leaves = [(int(l[0]), int(l[1]), int(l[2]), int(v)) for l, v in
                  zip(mesh.lloc_eachmb, mesh.mb_lev)]
        new_leaves, prov = update_tree(
            leaves, flags, mesh.tree_nrbx, mesh.tree_active, wraps,
            mesh.max_allowed_level)
        if prov is None:
            return state, False
        if len(new_leaves) > self.max_nmb:
            raise RuntimeError(
                f"AMR grew to {len(new_leaves)} blocks > "
                f"<mesh_refinement>/max_nmb_per_rank={self.max_nmb}")

        if self.use_pool:
            state = self.rebuild_pool(driver, state, new_leaves, prov,
                                      outputs)
        else:
            if lay is not None:
                from .parallel.shard_comm import unpad_state
                state = unpad_state(state, lay)  # slot -> gid order
            state = self.rebuild(driver, state, new_leaves, prov,
                                 outputs)
            if driver.dmesh is not None:
                from .parallel import shard_state
                from .parallel.shard_comm import (pad_state, shard_layout,
                                                  supports_shard_cycle)
                if supports_shard_cycle(driver, state):
                    lay2 = shard_layout(driver.mesh,
                                        driver.dmesh.devices.size)
                    driver._npad = lay2.nmb_pad - lay2.nmb
                    driver._layout = lay2
                    state = pad_state(state, lay2)
                else:
                    driver._npad = 0
                    driver._layout = None
                state = shard_state(state, driver.dmesh)
        n_same = sum(1 for p in prov if p[0] == "same")
        self.nmb_created += len(prov) - n_same
        self.nmb_deleted += len(leaves) - n_same
        return state, True

    # ------------------------------------------------------------------
    def rebuild(self, driver, state, new_leaves, prov, outputs=()):
        """Reconstruct mesh/bvals/physics on the new tree and remap the
        evolved data (reference: RedistAndRefineMeshBlocks,
        mesh_refinement.cpp:427-560)."""
        from .bvals import BoundaryValues
        from .main import make_physics
        from .mesh import Mesh

        old_mesh = driver.mesh
        old_phys = driver.phys
        mesh = Mesh(self.pin, leaves=new_leaves)
        mesh.time = old_mesh.time
        mesh.dt = old_mesh.dt
        mesh.dtold = old_mesh.dtold
        mesh.ncycle = old_mesh.ncycle
        bvals = BoundaryValues(mesh)
        phys = make_physics(self.pin, mesh, bvals)
        # carry pgen-enrolled hooks across the rebuild
        bvals.inflow_state = old_phys.bvals.inflow_state
        bvals.user_bc_func = old_phys.bvals.user_bc_func
        if hasattr(old_phys, "srcterms_func"):
            phys.srcterms_func = old_phys.srcterms_func

        mbi = mesh.mb_indcs
        act_axes = ["x1"]
        if mbi.nx2 > 1:
            act_axes.append("x2")
        if mbi.nx3 > 1:
            act_axes.append("x3")
        tbl = _prov_tables(prov)

        new_state = dict(state)
        for key in ("u", "w", "z", "i0"):
            if key in state:
                new_state[key] = remap_cc(state[key], tbl, mbi, act_axes)
        if "T" in state:
            new_state["T"] = remap_cc(state["T"][:, None], tbl, mbi,
                                      act_axes)[:, 0]
        if "bfc" in state:
            refined_mask = tbl["mode"] == 1
            bfc = remap_fc(state["bfc"], tbl, mbi, act_axes)
            bfc = fc_internal(bfc, mbi, act_axes, refined_mask)
            new_state["bfc"] = bfc

        # swap objects into the driver and outputs
        driver.mesh = mesh
        driver.phys = phys
        driver._cycle_fn = None
        driver._amr_dt_fn = None
        for out in outputs:
            if hasattr(out, "phys"):
                out.phys = phys
            if hasattr(out, "mesh"):
                out.mesh = mesh

        # ghost fill + c2p on the new tree (reference:
        # InitBoundaryValuesAndPrimitives + RepairAMRFC + second fill)
        new_state = jax.jit(phys.init_ghosts)(new_state)
        if "bfc" in new_state:
            bfc = fc_internal(new_state["bfc"], mbi, act_axes,
                              tbl["mode"] == 1)
            st2 = dict(new_state, bfc=bfc)
            new_state = jax.jit(phys.init_ghosts)(st2)

        # refreshed block bookkeeping
        counts = np.zeros(mesh.nmb_total, dtype=np.int64)
        for i, p in enumerate(prov):
            if p[0] == "same":
                counts[i] = self.ncyc_since_ref[p[1]]
        self.ncyc_since_ref = counts
        return new_state
