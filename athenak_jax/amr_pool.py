"""Fixed-capacity block pool for adaptive meshes: compile-stable AMR.

The reference allocates ``nmb_maxperrank`` MeshBlock slots up front and
keeps the same kernels running as the tree evolves
(reference: src/mesh/mesh.hpp:121 nmb_maxperrank,
mesh_refinement.cpp:427-560 RedistAndRefineMeshBlocks).  The JAX
analogue: pad every block-axis array to a fixed capacity ``nmb_max`` and
turn every tree-dependent host table (same-level neighbor gids, physical
-BC masks, the mixed-level donor tables of refinement.build_ml_tables,
per-block geometry) into a *traced input* of one jitted cycle

    cycle(state, dt, tables) -> (state, dtnew, counters)

so a tree update only swaps table values — same shapes, zero recompiles.
Pad slots clone block 0 and self-donate in every table, evolving as
isolated periodic boxes (same trick as the multi-chip block-pool padding
in parallel/shard_comm.pad_state), so no active-mask plumbing is needed
in the kernels and the dt reduction is unaffected.

The swap happens at *trace time*: ``installed(mesh, bvals, tables)``
temporarily replaces the numpy tables on the live mesh/bvals objects
with the traced pytree leaves (and forces every ``any_*`` fast-path flag
so all mixed-level branches trace); the compiled function is then a pure
function of (state, dt, tables).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict

import jax
import numpy as np

# ml-table index arrays whose pad rows must self-donate
_SELF_KEYS = {"same", "coarse", "fine", "same_gid", "fine_gid", "src",
              "child"}
# flags forced True at install time so every branch traces
_ANY_KEYS = ("any", "any_same", "any_fine", "any_coarse")


def _pad(a: np.ndarray, nmb: int, nmb_max: int, fill) -> np.ndarray:
    """Pad rows [nmb:nmb_max].  fill: 'self' | 'row0' | constant."""
    a = np.asarray(a)
    if a.shape[0] != nmb or nmb_max == nmb:
        return a
    extra = (nmb_max - nmb,) + a.shape[1:]
    if fill == "self":
        idx = np.arange(nmb, nmb_max, dtype=a.dtype)
        ext = np.broadcast_to(idx.reshape((-1,) + (1,) * (a.ndim - 1)),
                              extra)
    elif fill == "row0":
        ext = np.broadcast_to(a[:1], extra)
    else:
        ext = np.full(extra, fill, dtype=a.dtype)
    return np.concatenate([a, np.ascontiguousarray(ext)], axis=0)


def _pad_ml_entry(key: str, v, nmb: int, nmb_max: int):
    if isinstance(v, dict):
        return {k2: _pad_ml_entry(k2, v2, nmb, nmb_max)
                for k2, v2 in v.items()}
    if not isinstance(v, np.ndarray):
        return None  # static (t_names, edge_axis, flags): not a leaf
    if key in _SELF_KEYS:
        return _pad(v, nmb, nmb_max, "self")
    if v.dtype == bool:
        # masks pad False — except pkeep guards, which default True
        # ("keep the corner strip") and must stay True on pads
        return _pad(v, nmb, nmb_max, key in ("m", "p"))
    return _pad(v, nmb, nmb_max, 0)


def extract_tables(mesh, bvals, nmb_max: int) -> Dict:
    """All tree-dependent tables the cycle consumes, padded to capacity.

    Returns a jax pytree (nested dicts of numpy arrays) with a stable
    structure across tree updates of the same deck."""
    nmb = mesh.nmb_total
    T = {
        "nbr": {k: _pad(v, nmb, nmb_max, "self")
                for k, v in mesh.nbr_gid.items()},
        "mask": {k: _pad(v, nmb, nmb_max, False)
                 for k, v in mesh.phys_bc_mask.items()},
        "mb": {k: _pad(np.asarray(v), nmb, nmb_max, "row0")
               for k, v in mesh.mb_size.items()},
        "lev": _pad(mesh.mb_lev, nmb, nmb_max, "row0"),
        "ml": {},
    }
    for key, t in mesh.ml.items():
        if not isinstance(t, dict):
            continue  # the scalar "multilevel" flag
        sub = {}
        for k2, v in t.items():
            p = _pad_ml_entry(k2, v, nmb, nmb_max)
            if p is not None:
                sub[k2] = p
        T["ml"][key] = sub
    return T


def _merge_ml(orig: Dict, sub) -> Dict:
    out = dict(orig)
    for k, v in sub.items():
        if isinstance(v, dict) and isinstance(orig.get(k), dict):
            out[k] = _merge_ml(orig[k], v)
        else:
            out[k] = v
    for f in _ANY_KEYS:
        if f in out:
            out[f] = True
    return out


@contextmanager
def installed(mesh, bvals, T, phys=None):
    """Swap the traced table pytree onto the live objects for tracing."""
    saved = (bvals.nbr, bvals.mask, mesh.ml, mesh.mb_size, mesh.mb_lev)
    bvals.nbr = dict(T["nbr"])
    bvals.mask = dict(T["mask"])
    mesh.mb_size = dict(T["mb"])
    mesh.mb_lev = T["lev"]
    ml = {"multilevel": True}
    for key, sub in T["ml"].items():
        ml[key] = _merge_ml(saved[2][key], sub)
    mesh.ml = ml
    # physics snapshots of per-block dx taken at __init__ (hydro.dirs,
    # mhd.dirs/_dx4) must point at the traced geometry too
    saved_phys = {}
    if phys is not None:
        if hasattr(phys, "dirs"):
            saved_phys["dirs"] = phys.dirs
            phys.dirs = [
                (n, a, iv, T["mb"][f"d{n}"].reshape((-1,) + (1,) * 4))
                for (n, a, iv, _) in phys.dirs]
        if hasattr(phys, "_dx4"):
            saved_phys["_dx4"] = phys._dx4
            phys._dx4 = {n: T["mb"][f"d{n}"].reshape((-1,) + (1,) * 3)
                         for n in phys._dx4}
    try:
        yield
    finally:
        (bvals.nbr, bvals.mask, mesh.ml, mesh.mb_size,
         mesh.mb_lev) = saved
        for k, v in saved_phys.items():
            setattr(phys, k, v)


def pool_pad_state(state, nmb: int, nmb_max: int):
    """Pad every [nmb, ...] leaf with clones of block 0."""
    import jax.numpy as jnp

    if nmb_max == nmb:
        return state

    def pad(a):
        if not hasattr(a, "shape") or a.ndim < 1 or a.shape[0] != nmb:
            return a
        reps = jnp.broadcast_to(a[:1], (nmb_max - nmb,) + a.shape[1:])
        return jnp.concatenate([a, reps], axis=0)

    return jax.tree_util.tree_map(pad, state)


def prov_tables_padded(prov, nmb_old: int, nmb_max: int, nquad: int):
    """amr._prov_tables at fixed capacity: new-slot remap tables padded
    so the pooled remap compiles once.  Pad slots copy old block 0
    (mode 0, src 0) — fresh isolated-periodic-box pads."""
    nmb_new = len(prov)
    mode = np.zeros(nmb_max, dtype=np.int32)
    src = np.zeros(nmb_max, dtype=np.int32)
    octant = np.zeros((nmb_max, 3), dtype=np.int32)
    child = np.zeros((nmb_max, nquad), dtype=np.int32)
    for i, p in enumerate(prov):
        if p[0] == "same":
            src[i] = p[1]
        elif p[0] == "refined":
            mode[i] = 1
            src[i] = p[1]
            octant[i] = p[2]
        else:
            mode[i] = 2
            child[i, :len(p[1])] = p[1]
    assert nmb_new <= nmb_max
    return {"mode": mode, "src": src, "octant": octant, "child": child}


def supports_pool(pin) -> bool:
    """Pool mode covers Newtonian hydro/MHD adaptive runs (the shard
    gate's cousin): physics with global-module state or per-epoch
    geometry closures (Z4c, radiation, GR metrics, ion-neutral,
    particles, turbulence, gravity, shearing box) stay on the
    rebuild-per-epoch path."""
    for block in ("z4c", "adm", "radiation", "ion-neutral", "particles",
                  "turb_driving", "gravity", "shearing_box", "coord"):
        if pin.does_block_exist(block):
            return False
    return pin.does_block_exist("hydro") or pin.does_block_exist("mhd")
