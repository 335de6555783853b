"""Output types (tab, hst, ...).

Parity target: reference src/outputs/ — BaseTypeOutput + 13 concrete types
behind an <outputN> block factory (reference: src/outputs/outputs.cpp:224-260).
Round-1 scope: hst (history sums) and tab (formatted tables) in formats the
reference's vis/python/athena_read.py parses unchanged; bin/rst follow.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np

from ..indices import IDN, IEN, IM1, IM2, IM3, IVX, IVY, IVZ


class OutputParameters:
    def __init__(self, pin, block: str) -> None:
        self.block = block
        self.file_type = pin.get_string(block, "file_type")
        self.variable = pin.get_or_add_string(block, "variable", "hydro_u")
        self.dt = pin.get_or_add_real(block, "dt", 0.0)
        self.dcycle = pin.get_or_add_integer(block, "dcycle", 0)
        self.data_format = pin.get_or_add_string(block, "data_format",
                                                 "%12.5e").strip()
        self.file_number = 0
        self.last_time = -1e300
        # optional slicing
        self.slice_x1 = self._maybe_real(pin, block, "slice_x1")
        self.slice_x2 = self._maybe_real(pin, block, "slice_x2")
        self.slice_x3 = self._maybe_real(pin, block, "slice_x3")

    @staticmethod
    def _maybe_real(pin, block, key):
        if pin.does_parameter_exist(block, key):
            return pin.get_real(block, key)
        return None


class BaseOutput:
    def __init__(self, pin, mesh, phys, block: str) -> None:
        self.params = OutputParameters(pin, block)
        self.basename = pin.get_string("job", "basename")
        self.phys = phys

    def due(self, mesh) -> bool:
        p = self.params
        if p.dcycle > 0:
            return mesh.ncycle % p.dcycle == 0
        if p.dt > 0.0:
            # float32 compare like the reference (driver.cpp:432-445)
            return (np.float32(mesh.time) >= np.float32(p.last_time + p.dt))
        return False

    def maybe_write(self, mesh, u, w, force: bool = False,
                    state=None) -> None:
        if force or self.due(mesh):
            self.write(mesh, u, w)
            if self.params.dt > 0.0:
                if self.params.last_time < -1e299:
                    self.params.last_time = mesh.time
                else:
                    self.params.last_time += self.params.dt
            self.params.file_number += 1

    def write(self, mesh, u, w) -> None:
        raise NotImplementedError


class HistoryOutput(BaseOutput):
    """Volume-weighted history sums (reference: src/outputs/history.cpp).

    Problem generators can enroll ``phys.user_hist_func(mesh, state) ->
    (labels, values)`` for extra columns (reference: pgen user_hist_func
    hook, src/pgen/pgen.hpp:55); ``<outputN>/user_hist_only=true`` writes
    only those, into a ``.user.hst`` file like the reference."""

    def __init__(self, pin, mesh, phys, block: str) -> None:
        super().__init__(pin, mesh, phys, block)
        self.user_only = pin.get_or_add_boolean(
            self.params.block, "user_hist_only", False)

    def maybe_write(self, mesh, u, w, force: bool = False, state=None):
        if force or self.due(mesh):
            self.write(mesh, u, w, state=state)
            if self.params.dt > 0.0:
                if self.params.last_time < -1e299:
                    self.params.last_time = mesh.time
                else:
                    self.params.last_time += self.params.dt
            self.params.file_number += 1

    def write(self, mesh, u, w, state=None) -> None:
        mbi = mesh.mb_indcs
        sl = (slice(None), slice(None),
              slice(mbi.ks, mbi.ke + 1),
              slice(mbi.js, mbi.je + 1),
              slice(mbi.is_, mbi.ie + 1))
        user_fn = getattr(self.phys, "user_hist_func", None)
        labels = []
        data = []
        if not (self.user_only and user_fn is not None):
            ua = np.asarray(u[sl], dtype=np.float64)
            wa = np.asarray(w[sl], dtype=np.float64)
            # per-block cell volume (level-dependent on SMR/AMR meshes)
            vol = (np.asarray(mesh.mb_size["dx1"], dtype=np.float64)
                   * np.asarray(mesh.mb_size["dx2"])
                   * np.asarray(mesh.mb_size["dx3"]))

            def vsum(q):
                return float((q.sum(axis=(1, 2, 3)) * vol).sum())

            is_ideal = self.phys.eos.is_ideal
            labels += ["mass", "1-mom", "2-mom", "3-mom"]
            data += [vsum(ua[:, IDN]), vsum(ua[:, IM1]),
                     vsum(ua[:, IM2]), vsum(ua[:, IM3])]
            if is_ideal:
                labels.append("tot-E")
                data.append(vsum(ua[:, IEN]))
            for n, lab in ((IVX, "1-KE"), (IVY, "2-KE"), (IVZ, "3-KE")):
                labels.append(lab)
                data.append(vsum(0.5 * wa[:, IDN] * wa[:, n] ** 2))
        if user_fn is not None:
            ulabels, uvals = user_fn(mesh, state)
            labels += list(ulabels)
            data += [float(v) for v in uvals]

        suffix = ".user.hst" if (self.user_only and user_fn is not None) \
            else ".hst"
        fname = self.basename + suffix
        new = not os.path.exists(fname)
        with open(fname, "a") as f:
            if new:
                f.write("# Athena++ history data\n")
                cols = "#  [1]=time      [2]=dt       "
                for i, lab in enumerate(labels):
                    cols += f"[{i + 3}]={lab[:10]}    "
                f.write(cols + "\n")
            fmt = self.params.data_format + " "
            f.write(fmt % mesh.time)
            f.write(fmt % mesh.dt)
            for v in data:
                f.write(fmt % v)
            f.write("\n")


class TabularOutput(BaseOutput):
    """Formatted table dumps (reference: src/outputs/formatted_table.cpp)."""

    _VARIABLES = {
        "hydro_u": ("u", ["dens", "mom1", "mom2", "mom3", "ener"]),
        "hydro_w": ("w", ["dens", "velx", "vely", "velz", "eint"]),
        "mhd_u": ("u", ["dens", "mom1", "mom2", "mom3", "ener"]),
        "mhd_w": ("w", ["dens", "velx", "vely", "velz", "eint"]),
    }

    def write(self, mesh, u, w) -> None:
        p = self.params
        kind, labels = self._VARIABLES.get(
            p.variable, ("w", ["dens", "velx", "vely", "velz", "eint"]))
        arr = np.asarray(u if kind == "u" else w, dtype=np.float64)
        nvar = min(arr.shape[1], len(labels))
        mbi = mesh.mb_indcs

        fname = f"{self.basename}.{p.variable}.{p.file_number:05d}.tab"
        with open(fname, "w") as f:
            f.write(f"# Athena++ data at time={mesh.time:e}"
                    f"  cycle={mesh.ncycle} \n")
            slice2 = p.slice_x2 is not None or mbi.nx2 == 1
            slice3 = p.slice_x3 is not None or mbi.nx3 == 1
            f.write("# gid  ")
            f.write(" i       x1v     ")
            if not slice2:
                f.write(" j       x2v     ")
            if not slice3:
                f.write(" k       x3v     ")
            for lab in labels[:nvar]:
                f.write(f"    {lab}     ")
            f.write("\n")

            fmt = p.data_format
            for gid in range(mesh.nmb_total):
                x1v, x2v, x3v = mesh.cell_centers(gid)
                # pick slice indices
                j_range = range(mbi.js, mbi.je + 1)
                k_range = range(mbi.ks, mbi.ke + 1)
                if slice2:
                    jmid = self._slice_index(
                        x2v, mbi.js, mbi.je, p.slice_x2)
                    if jmid is None:
                        continue
                    j_range = [jmid]
                if slice3:
                    kmid = self._slice_index(
                        x3v, mbi.ks, mbi.ke, p.slice_x3)
                    if kmid is None:
                        continue
                    k_range = [kmid]
                for k in k_range:
                    for j in j_range:
                        for i in range(mbi.is_, mbi.ie + 1):
                            f.write(f"{gid:05d}")
                            f.write(f"  {i - mbi.is_:04d}  " + fmt % x1v[i])
                            if not slice2:
                                f.write(f"  {j - mbi.js:04d}  " + fmt % x2v[j])
                            if not slice3:
                                f.write(f"  {k - mbi.ks:04d}  " + fmt % x3v[k])
                            for n in range(nvar):
                                f.write("  " + fmt % arr[gid, n, k, j, i])
                            f.write("\n")

    @staticmethod
    def _slice_index(xv, lo, hi, slice_pos) -> Optional[int]:
        if slice_pos is None:
            return lo  # degenerate axis
        # block contains the slice position?
        if xv[lo] - 1e-12 <= slice_pos <= xv[hi] + 1e-12 or lo == hi:
            return int(np.argmin(np.abs(np.asarray(xv[lo:hi + 1])
                                        - slice_pos))) + lo
        return None


_TYPES = {
    "hst": HistoryOutput,
    "tab": TabularOutput,
}


def make_outputs(pin, mesh, phys) -> List[BaseOutput]:
    outs: List[BaseOutput] = []
    for block in list(pin.blocks):
        if re.match(r"^output\d+$", block):
            ftype = pin.get_string(block, "file_type")
            cls = _TYPES.get(ftype)
            if cls is None:
                # unknown file_type is a hard error, matching the
                # reference factory (reference: src/outputs/outputs.cpp:
                # 224-260) — a deck typo must not silently produce a
                # run with no output
                raise ValueError(
                    f"<{block}>/file_type = '{ftype}' is not a valid "
                    f"output type (valid: {sorted(_TYPES)})")
            outs.append(cls(pin, mesh, phys, block))
    # CCE worldtubes and horizon cube dumps are enabled by their own deck
    # blocks, not <outputN> (reference: z4c.cpp:195-233 constructs them
    # from <cce>/<z4c> params; task-list cadence in z4c_tasks.cpp:345,555)
    if pin.does_block_exist("z4c"):
        if pin.does_block_exist("cce") and \
                pin.get_or_add_integer("cce", "num_radii", 0) > 0:
            outs.append(CCEOutput(pin, mesh, phys))
        if pin.does_parameter_exist("z4c", "dump_horizon_0"):
            outs.append(HorizonDumpOutput(pin, mesh, phys))
    return outs


class CCEOutput:
    """Cadenced CCE worldtube dumps (reference: Z4c::CCEDump,
    z4c_tasks.cpp:345-360 — float32 time comparison, all worldtubes per
    dump time)."""

    driver = None

    def __init__(self, pin, mesh, phys) -> None:
        from ..z4c.cce import CCE
        self.phys = phys
        self.cce_dt = pin.get_or_add_real("cce", "cce_dt", 1.0)
        ncce = pin.get_integer("cce", "num_radii")
        self.worldtubes = [CCE(pin, mesh, i) for i in range(ncce)]
        self.last = -100.0  # reference cce_dump_last_output_time

    def maybe_write(self, mesh, u, w, force=False, state=None):
        if not (force or np.float32(mesh.time)
                >= np.float32(self.last + self.cce_dt)):
            return
        z4c_mod = getattr(self.phys, "z4c", self.phys)
        z = state["z"] if (state is not None and "z" in state) else u
        for wt in self.worldtubes:
            wt.dump(mesh, z4c_mod, z)
        self.last = float(np.float32(mesh.time))


class HorizonDumpOutput:
    """Cadenced horizon cube dumps following compact-object trackers
    (reference: Z4c::DumpHorizons, z4c_tasks.cpp:554-575)."""

    driver = None

    def __init__(self, pin, mesh, phys) -> None:
        from ..z4c.cce import HorizonDump
        from ..z4c.weyl import CompactObjectTracker
        from ..z4c.z4c import I_BETAX
        self.phys = phys
        self.mesh = mesh
        self.dumps = []
        n = 0
        while pin.get_or_add_boolean("z4c", f"dump_horizon_{n}", False):
            self.dumps.append(HorizonDump(pin, mesh, n))
            n += 1
        self.trackers = [
            CompactObjectTracker(list(hd.pos), I_BETAX)
            for hd in self.dumps]
        self.last = 0.0
        self._wrote_t0 = False

    def maybe_write(self, mesh, u, w, force=False, state=None):
        if not self.dumps:
            return
        z = state["z"] if (state is not None and "z" in state) else u
        # trackers: prefer the on-device integration (state["co_pos"]);
        # host Euler update is the fallback (see WaveformOutput)
        if state is not None and "co_pos" in state:
            pos = np.asarray(state["co_pos"], dtype=np.float64)
            for n, trk in enumerate(self.trackers):
                if n < pos.shape[0]:
                    trk.pos = pos[n]
        elif mesh.ncycle > 0:
            zn = np.asarray(z)
            for trk in self.trackers:
                trk.update(mesh, zn, mesh.dtold)
        t32 = np.float32(mesh.time)
        due = (t32 >= np.float32(self.last + self.dumps[0].horizon_dt)
               or (mesh.time == 0.0 and not self._wrote_t0))
        if not (force or due):
            return
        z4c_mod = getattr(self.phys, "z4c", self.phys)
        for hd, trk in zip(self.dumps, self.trackers):
            hd.dump(mesh, z4c_mod, z, center=trk.pos)
        self.last = float(t32)
        self._wrote_t0 = True


class BinaryOutput(BaseOutput):
    """Reference-format binary dumps (version 1.1).

    Byte-compatible with the reference writer
    (reference: src/outputs/binary.cpp:52-260); the authoritative layout
    spec is the reader vis/python/bin_convert.py:92-260, against which
    this writer is tested.  Layout: ASCII preheader (version, time, cycle,
    sizes, variable list, header offset) + full athinput dump + per-block
    records [6x int32 output indices, 4x int32 logical location,
    6x f64 block extents, f32/f64 cell data].
    """

    _VARIABLES = {
        "hydro_u": ("u", ["dens", "mom1", "mom2", "mom3", "ener"]),
        "hydro_w": ("w", ["dens", "velx", "vely", "velz", "eint"]),
        "mhd_u": ("u", ["dens", "mom1", "mom2", "mom3", "ener"]),
        "mhd_w": ("w", ["dens", "velx", "vely", "velz", "eint"]),
        "mhd_w_bcc": ("w_bcc", ["dens", "velx", "vely", "velz", "eint",
                                "bcc1", "bcc2", "bcc3"]),
        "mhd_u_bcc": ("u_bcc", ["dens", "mom1", "mom2", "mom3", "ener",
                                "bcc1", "bcc2", "bcc3"]),
    }

    def __init__(self, pin, mesh, phys, block: str) -> None:
        super().__init__(pin, mesh, phys, block)
        self.pin = pin
        self.single = (pin.get_or_add_boolean(
            self.params.block, "single_file_per_rank", False))

    def write(self, mesh, u, w, bcc=None, state=None) -> None:
        p = self.params
        mbi = mesh.mb_indcs
        interior = (slice(None), slice(None),
                    slice(mbi.ks, mbi.ke + 1),
                    slice(mbi.js, mbi.je + 1),
                    slice(mbi.is_, mbi.ie + 1))
        try:
            # derived-variable registry: computed + sliced ON DEVICE, so
            # only the interior of the requested channels crosses to host
            # (reference: derived_variables.cpp computes on device too)
            from .variables import resolve
            st = state if state is not None \
                else {"u": u, "w": w, "bcc": bcc}
            labels, dev = resolve(p.variable, self.phys, st, mesh)
            arr = np.asarray(dev[interior], dtype=np.float64)
        except ValueError:
            kind, labels = self._VARIABLES.get(
                p.variable, ("w", ["dens", "velx", "vely", "velz",
                                   "eint"]))
            if kind in ("u", "w"):
                dev = (u if kind == "u" else w)
                nvar_phys = min(dev.shape[1], 5)
                sl = (slice(None), slice(0, nvar_phys)) + interior[2:]
                arr = np.asarray(dev[sl], dtype=np.float64)
                labels = labels[:nvar_phys]
            else:
                base = u if kind == "u_bcc" else w
                import jax.numpy as _jnp
                dev = _jnp.concatenate([base[:, :5], bcc], axis=1)
                arr = np.asarray(dev[interior], dtype=np.float64)
        nvar = arr.shape[1]
        fname = f"{self.basename}.{p.variable}.{p.file_number:05d}.bin"
        header_dump = self.pin.dump()
        header_bytes = header_dump.encode()

        with open(fname, "wb") as f:
            f.write(b"Athena binary output version=1.1\n")
            f.write(b"  size of preheader=5\n")
            f.write(f"  time={mesh.time:.16e}\n".encode())
            f.write(f"  cycle={mesh.ncycle}\n".encode())
            f.write(b"  size of location=8\n")
            f.write(b"  size of variable=8\n")
            f.write(f"  number of variables={nvar}\n".encode())
            f.write(("  variables:  " + "  ".join(labels) + "\n").encode())
            f.write(f"  header offset={len(header_bytes)}\n".encode())
            f.write(header_bytes)

            for gid in range(mesh.nmb_total):
                idx = np.array([mbi.is_, mbi.ie, mbi.js, mbi.je,
                                mbi.ks, mbi.ke], dtype=np.int32)
                f.write(idx.tobytes())
                loc = mesh.lloc_eachmb[gid]
                # root-relative level, matching the reference's
                # loc.level - root_level (reference: binary.cpp:193)
                level = int(mesh.mb_lev[gid]) \
                    if hasattr(mesh, "mb_lev") else 0
                f.write(np.array([loc[0], loc[1], loc[2], level],
                                 dtype=np.int32).tobytes())
                geom = np.array(
                    [mesh.mb_size["x1min"][gid], mesh.mb_size["x1max"][gid],
                     mesh.mb_size["x2min"][gid], mesh.mb_size["x2max"][gid],
                     mesh.mb_size["x3min"][gid], mesh.mb_size["x3max"][gid]],
                    dtype=np.float64)
                f.write(geom.tobytes())
                # arr is already interior-sliced (device-side)
                f.write(np.ascontiguousarray(arr[gid],
                                             dtype=np.float64).tobytes())

    def maybe_write(self, mesh, u, w, force: bool = False, state=None):
        if force or self.due(mesh):
            bcc = state.get("bcc") if state is not None else None
            self.write(mesh, u, w, bcc=bcc, state=state)
            if self.params.dt > 0.0:
                if self.params.last_time < -1e299:
                    self.params.last_time = mesh.time
                else:
                    self.params.last_time += self.params.dt
            self.params.file_number += 1


class RestartOutput(BaseOutput):
    """Checkpoint files for restart runs.

    Functional parity with the reference restart system (reference:
    src/outputs/restart.cpp:207-310): parameter dump + mesh/time metadata
    + the full evolved state, re-loadable by ``main -r``.  The container
    is npz (a simplification of the reference's offset-
    addressed MPI-IO layout; resume rebuilds the mesh from the stored
    parameter dump exactly as BuildTreeFromRestart does).
    """

    def __init__(self, pin, mesh, phys, block: str) -> None:
        super().__init__(pin, mesh, phys, block)
        self.pin = pin

    def maybe_write(self, mesh, u, w, force: bool = False, state=None):
        if force or self.due(mesh):
            self.write_state(mesh, state)
            if self.params.dt > 0.0:
                if self.params.last_time < -1e299:
                    self.params.last_time = mesh.time
                else:
                    self.params.last_time += self.params.dt
            self.params.file_number += 1

    def write_state(self, mesh, state) -> None:
        p = self.params
        fname = f"{self.basename}.{p.file_number:05d}.rst"
        payload = {
            "params": np.frombuffer(self.pin.dump().encode(),
                                    dtype=np.uint8),
            "time": np.float64(mesh.time),
            "dt": np.float64(mesh.dt),
            "ncycle": np.int64(mesh.ncycle),
        }
        # evolved tree: the lloc list rebuilds the mesh on resume
        # (reference: restart.cpp:207-310 writes lloc_eachmb/cost lists,
        # BuildTreeFromRestart reconstructs the tree)
        if getattr(mesh, "leaves", None) is not None:
            payload["tree_leaves"] = np.array(
                [[l1, l2, l3, lv] for (l1, l2, l3, lv) in mesh.leaves],
                dtype=np.int64)
        drv = getattr(self, "driver", None)
        if drv is not None and getattr(drv, "pamr", None) is not None:
            payload["amr_ncyc_since_ref"] = np.asarray(
                drv.pamr.ncyc_since_ref, dtype=np.int64)
        flat, treedef = _flatten_state(state)
        payload["treedef"] = np.frombuffer(treedef.encode(), dtype=np.uint8)
        for i, leaf in enumerate(flat):
            payload[f"leaf{i}"] = np.asarray(leaf)
        with open(fname, "wb") as f:  # keep the .rst name (no .npz suffix)
            np.savez(f, **payload)


def _flatten_state(state):
    """Flatten the physics state dict (one level of nesting for bfc)."""
    import json
    keys = []
    flat = []
    for k in sorted(state):
        v = state[k]
        if isinstance(v, dict):
            for k2 in sorted(v):
                keys.append(f"{k}/{k2}")
                flat.append(v[k2])
        else:
            keys.append(k)
            flat.append(v)
    return flat, json.dumps(keys)


def unflatten_state(keys_json, leaves):
    import json
    keys = json.loads(keys_json)
    out = {}
    for k, leaf in zip(keys, leaves):
        if "/" in k:
            k1, k2 = k.split("/")
            out.setdefault(k1, {})[k2] = leaf
        else:
            out[k] = leaf
    return out


def load_restart(fname, with_extras: bool = False):
    """Read a .rst file -> (params_text, time, dt, ncycle, state_arrays
    [, extras]).  extras carries the evolved tree (``tree_leaves``) and
    AMR bookkeeping when present."""
    import jax.numpy as jnp
    z = np.load(fname)
    params = bytes(z["params"]).decode()
    treedef = bytes(z["treedef"]).decode()
    leaves = []
    i = 0
    while f"leaf{i}" in z:
        leaves.append(jnp.asarray(z[f"leaf{i}"]))
        i += 1
    state = unflatten_state(treedef, leaves)
    out = (params, float(z["time"]), float(z["dt"]), int(z["ncycle"]),
           state)
    if with_extras:
        extras = {}
        if "tree_leaves" in z:
            extras["tree_leaves"] = [tuple(int(x) for x in row)
                                     for row in z["tree_leaves"]]
        if "amr_ncyc_since_ref" in z:
            extras["amr_ncyc_since_ref"] = np.asarray(
                z["amr_ncyc_since_ref"])
        return out + (extras,)
    return out


class VtkOutput(BaseOutput):
    """Legacy VTK (STRUCTURED_POINTS, BINARY, big-endian float) dumps of
    the full mesh, readable by VisIt/ParaView (reference:
    src/outputs/vtk_mesh.cpp:56-160: header, CELL_DATA, per-variable
    SCALARS records with byte-swapped float payloads).  Uniform meshes
    only, like the reference ("level= 0 assuming uniform mesh")."""

    def __init__(self, pin, mesh, phys, block: str) -> None:
        super().__init__(pin, mesh, phys, block)
        if getattr(mesh, "multilevel", False):
            raise NotImplementedError(
                "vtk output requires a uniform mesh (use bin on SMR)")

    def write(self, mesh, u, w, bcc=None) -> None:
        p = self.params
        kind, labels = BinaryOutput._VARIABLES.get(
            p.variable, ("w", ["dens", "velx", "vely", "velz", "eint"]))
        if kind in ("u", "w"):
            arr = np.asarray(u if kind == "u" else w, dtype=np.float32)
            nvar_phys = min(arr.shape[1], 5)
            arr = arr[:, :nvar_phys]
            labels = labels[:nvar_phys]
        else:
            base = np.asarray(u if kind == "u_bcc" else w, dtype=np.float32)
            arr = np.concatenate(
                [base[:, :5], np.asarray(bcc, dtype=np.float32)], axis=1)

        mbi = mesh.mb_indcs
        act = arr[:, :, mbi.ks:mbi.ke + 1, mbi.js:mbi.je + 1,
                  mbi.is_:mbi.ie + 1]
        # assemble the global grid from Z-ordered blocks
        n1 = mesh.nmb_x1 * mbi.nx1
        n2 = mesh.nmb_x2 * mbi.nx2
        n3 = mesh.nmb_x3 * mbi.nx3
        g = np.empty((act.shape[1], n3, n2, n1), dtype=np.float32)
        for gid in range(mesh.nmb_total):
            l1, l2, l3 = mesh.lloc_eachmb[gid]
            g[:, l3 * mbi.nx3:(l3 + 1) * mbi.nx3,
              l2 * mbi.nx2:(l2 + 1) * mbi.nx2,
              l1 * mbi.nx1:(l1 + 1) * mbi.nx1] = act[gid]

        ms = mesh.mesh_size
        nc1 = n1 + 1 if n1 > 1 else n1
        nc2 = n2 + 1 if n2 > 1 else n2
        nc3 = n3 + 1 if n3 > 1 else n3
        fname = f"{self.basename}.{p.variable}.{p.file_number:05d}.vtk"
        with open(fname, "wb") as f:
            f.write(b"# vtk DataFile Version 2.0\n")
            f.write((f"# Athena++ data at time= {mesh.time:.15e}"
                     f"  level= 0  nranks= 1  cycle={mesh.ncycle}"
                     f"  variables={p.variable}\n").encode())
            f.write(b"BINARY\nDATASET STRUCTURED_POINTS\n")
            f.write(f"DIMENSIONS {nc1} {nc2} {nc3}\n".encode())
            f.write((f"ORIGIN {ms.x1min:.15e} {ms.x2min:.15e} "
                     f"{ms.x3min:.15e} \n").encode())
            f.write((f"SPACING {ms.dx1:.15e} {ms.dx2:.15e} "
                     f"{ms.dx3:.15e} \n").encode())
            f.write(f"\nCELL_DATA {n1 * n2 * n3}\n".encode())
            for v, label in enumerate(labels):
                f.write(f"\nSCALARS {label} float\n".encode())
                f.write(b"LOOKUP_TABLE default\n")
                f.write(g[v].astype(">f4").tobytes())

    def maybe_write(self, mesh, u, w, force: bool = False, state=None):
        if force or self.due(mesh):
            bcc = state.get("bcc") if state is not None else None
            self.write(mesh, u, w, bcc=bcc)
            if self.params.dt > 0.0:
                if self.params.last_time < -1e299:
                    self.params.last_time = mesh.time
                else:
                    self.params.last_time += self.params.dt
            self.params.file_number += 1


class WaveformOutput(BaseOutput):
    """Gravitational-wave diagnostics for Z4c runs: psi4 (l,m) modes on
    extraction spheres + compact-object (puncture) trackers.

    Reference: src/z4c/z4c_wave_extr.cpp (mode integrals) and
    src/z4c/compact_object_tracker.cpp (shift-ODE tracker).  Deck params
    follow the reference <z4c> block: nrad_wave_extraction,
    extraction_radius_N, extraction_nlev, nco, co_N_x/y/z."""

    def __init__(self, pin, mesh, phys, block: str) -> None:
        super().__init__(pin, mesh, phys, block)
        from ..z4c.weyl import CompactObjectTracker, WaveExtractor
        from ..z4c.z4c import I_BETAX
        self.mesh = mesh
        nrad = pin.get_or_add_integer("z4c", "nrad_wave_extraction", 0)
        radii = [pin.get_real("z4c", f"extraction_radius_{n + 1}")
                 for n in range(nrad)]
        nlev = pin.get_or_add_integer("z4c", "extraction_nlev", 16)
        lmax = pin.get_or_add_integer("z4c", "lmax_wave_extraction", 4)
        self.extractor = WaveExtractor(radii, lmax=lmax, nlevel=nlev) \
            if radii else None
        nco = pin.get_or_add_integer("z4c", "nco", 0)
        self.trackers = [
            CompactObjectTracker(
                [pin.get_or_add_real("z4c", f"co_{n}_x", 0.0),
                 pin.get_or_add_real("z4c", f"co_{n}_y", 0.0),
                 pin.get_or_add_real("z4c", f"co_{n}_z", 0.0)], I_BETAX)
            for n in range(nco)]
        self._weyl_jit = None
        self._wrote_header = False

    def maybe_write(self, mesh, u, w, force=False, state=None):
        # tracker positions: preferred path is the on-device integration
        # (state["co_pos"], z4c.post_cycle) — only [nco, 3] floats are
        # fetched, and only at output cadence.  The host Euler update is
        # the fallback when the state has no device trackers.
        if state is not None and "co_pos" in state and self.trackers:
            pos = np.asarray(state["co_pos"], dtype=np.float64)
            for n, trk in enumerate(self.trackers):
                if n < pos.shape[0]:
                    trk.pos = pos[n]
                    trk.history.append((mesh.time, *pos[n]))
        elif self.trackers and mesh.ncycle > 0:
            un = np.asarray(u)
            for trk in self.trackers:
                trk.update(mesh, un, mesh.dtold)
        super().maybe_write(mesh, u, w, force=force, state=state)

    def write(self, mesh, u, w) -> None:
        for n, trk in enumerate(self.trackers):
            with open(f"{self.basename}.co_{n}.txt", "a") as f:
                if trk.history:
                    t, x, y, z = trk.history[-1]
                else:
                    t, (x, y, z) = mesh.time, trk.pos
                f.write(f"{t:.10e} {x:.10e} {y:.10e} {z:.10e}\n")
        if self.extractor is None:
            return
        if self._weyl_jit is None:
            import jax

            from ..z4c.weyl import weyl_scalars
            phys = self.phys
            self._weyl_jit = jax.jit(lambda uu: weyl_scalars(phys, uu))
        rp, ip = self._weyl_jit(u)
        rp, ip = np.asarray(rp), np.asarray(ip)
        keys = sorted(self.extractor.ylm.keys())
        if not self._wrote_header:
            with open(f"{self.basename}.waveform.txt", "a") as f:
                cols = " ".join(f"Re_l{l}_m{m} Im_l{l}_m{m}"
                                for l, m in keys)
                f.write(f"# time radius {cols}\n")
            self._wrote_header = True
        for rad, modes in self.extractor.modes(mesh, rp, ip):
            with open(f"{self.basename}.waveform.txt", "a") as f:
                vals = " ".join(f"{modes[k][0]:.10e} {modes[k][1]:.10e}"
                                for k in keys)
                f.write(f"{mesh.time:.10e} {rad:.6e} {vals}\n")


_TYPES["bin"] = BinaryOutput
_TYPES["rst"] = RestartOutput
_TYPES["vtk"] = VtkOutput
_TYPES["wave"] = WaveformOutput


class TrackedParticleOutput(BaseOutput):
    """Tracked-particle trajectory dumps (reference: src/outputs/
    track_prtcl.cpp, 'trk' type): appends id, position, velocity rows for
    the first ntrack particles."""

    def maybe_write(self, mesh, u, w, force=False, state=None):
        if state is None or "prtcl_x" not in state:
            return
        if force or self.due(mesh):
            x = np.asarray(state["prtcl_x"])
            v = np.asarray(state["prtcl_v"])
            ntrack = min(self.phys.ppart.ntrack, x.shape[0])
            fname = self.basename + ".trk"
            new = not os.path.exists(fname)
            with open(fname, "a") as f:
                if new:
                    f.write("# time  id  x1  x2  x3  v1  v2  v3\n")
                for p in range(ntrack):
                    f.write(f"{mesh.time:.10e}  {p:d}  "
                            + "  ".join(f"{q:.10e}" for q in
                                        list(x[p]) + list(v[p])) + "\n")
            if self.params.dt > 0.0:
                if self.params.last_time < -1e299:
                    self.params.last_time = mesh.time
                else:
                    self.params.last_time += self.params.dt
            self.params.file_number += 1


_TYPES["trk"] = TrackedParticleOutput


class EventLogOutput(BaseOutput):
    """Event-counter log: numerical-failure statistics per write
    (reference: src/outputs/eventlog.cpp:35-71 — FOFC activations, EOS
    floor hits, c2p failures surfaced via the 'log' output type).  The
    driver attaches itself to outputs in run()."""

    driver = None

    def maybe_write(self, mesh, u, w, force=False, state=None):
        if self.driver is None:
            return
        if force or self.due(mesh):
            counters = dict(self.driver.ecounters)
            if not counters:
                return  # counters appear after the first cycle
            fname = self.basename + ".log"
            new = not os.path.exists(fname)
            with open(fname, "a") as f:
                if new:
                    f.write("# time  cycle  "
                            + "  ".join(sorted(counters)) + "\n")
                f.write(f"{mesh.time:.10e}  {mesh.ncycle:d}  "
                        + "  ".join(str(counters[k])
                                    for k in sorted(counters)) + "\n")
            if self.params.dt > 0.0:
                if self.params.last_time < -1e299:
                    self.params.last_time = mesh.time
                else:
                    self.params.last_time += self.params.dt
            self.params.file_number += 1


_TYPES["log"] = EventLogOutput


def _register_grid_outputs():
    # deferred import: grids.py subclasses BinaryOutput defined above
    from .grids import (CartesianGridOutput, CoarsenedBinaryOutput,
                        PDFOutput, SphericalSurfaceOutput)
    _TYPES["cbin"] = CoarsenedBinaryOutput
    _TYPES["pdf"] = PDFOutput
    _TYPES["cartgrid"] = CartesianGridOutput
    _TYPES["sphsurf"] = SphericalSurfaceOutput


_register_grid_outputs()
