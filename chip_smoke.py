"""Smoke test of the main simulation paths on an NVIDIA GPU.

Every phase runs in this one process, so only one process holds the card:

  phase 0  device check: a GPU must be present; prints the platform,
           device kind and count, and the card's name and power limit
           from nvidia-smi.
  phase 1  hero: inputs/mhd/blast.athinput (3D MHD blast, PLM + HLLD,
           RK2, CT, f32) at 256^3 in eight 128^3 MeshBlocks, with the
           deck's bin output, down the CLI's path (main.build ->
           Driver.initialize -> Driver.execute).  Checks a finite state,
           mass and energy conservation on the periodic box, div B at
           round-off and a positive dt.
  phase 2  the plain reference: the Triton x1 flux kernel against XLA's
           plain path on the card (f32 at 256^3, f64 at 64^3); the same
           deck at 64^3 for 2 cycles on the GPU in f64 against the CPU in
           f64; and the phase-1 f32 state against the same run in f64 on
           the GPU.
  phase 3  Z4c: inputs/z4c/one_puncture.athinput at 128^3, RK4, f32,
           with a finite Hamiltonian-constraint norm; and at 32^3 for 2
           cycles the GPU in f64 against the CPU in f64.

``--four`` runs only the four-card path: the hero weak-scaled to
512x512x256 in 32 MeshBlocks of 128^3 on a 4-device mesh (the explicit
shard_map + ppermute cycle), compared with the same deck on one card.

Each run prints its zone-cycles/s line (information, not a metric), its
compile time, ``compiled.memory_analysis()`` and the device's peak bytes
in use.  Any failed check or exception ends the script non-zero; the
last line of a passing run is ``{"ok": true, "device": {...}}``.

Usage:  python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HERO_DECK = os.path.join(REPO, "inputs", "mhd", "blast.athinput")
Z4C_DECK = os.path.join(REPO, "inputs", "z4c", "one_puncture.athinput")
RUN_DIR = os.path.join(REPO, "runs", "chip_smoke")

# Tolerances.  Each bounds a per-variable error, relative to the scale
# of the variable's group (the three face-field components share one).
#
# Two runs that round differently agree to round-off only where the
# scheme is continuous.  HLLD switches formulas where 0.5 Bx^2 or its
# star-state denominators cross 1e-4 of the total pressure, and the
# corner-EMF upwinding switches on the sign of the mass flux; the blast
# crosses both thresholds, so a last-bit difference flips the branch in
# a few per cent of the cells and changes them there by up to 1e-2
# (measured on the CPU: a 1e-15 relative perturbation of the 64^3 f64
# initial state, after 2 cycles, moves 2.2% of the values by more than
# 1e-12 and the face field by 9e-7 in L1).  So two precisions or two
# devices are compared in two tiers: the share of values off by more
# than the round-off bound, and the L1 error.
#
# f64 against f64 on two devices: the cycles contain no matrix product
# (checked on the compiled HLO below), so only FMA contraction, the order
# of reductions and the rounding of sqrt, cbrt and division differ.
TOL_F64 = 1e-12
TOL_F64_SHARE = 0.05
TOL_F64_L1 = 1e-5
# f32 against f64, L1: f32 rounding (6e-8) accumulated over the cycles,
# the slightly different dt chain of the two precisions, and the branch
# flips above, whose share falls as the mesh refines (CPU, 20 cycles:
# 9e-5 at 32^3, 1.2e-5 at 64^3, 2.8e-6 at 96^3).
TOL_F32_L1 = 1e-5
# The Triton kernel against XLA's plain path on one state, max norm:
# the same arithmetic in another order (f32), or f64 round-off.
TOL_KERNEL_F32 = 1e-5
TOL_KERNEL_F64 = 1e-12
# Conservation of total mass and energy on a periodic box: exact in
# exact arithmetic; f32 rounding of every flux difference, summed over
# all cells and cycles, stays well inside this.
TOL_CONSERVE_F32 = 1e-5
# max |div B| * dx / max |B|: CT keeps div B unchanged up to the f32
# rounding of each face update.
TOL_DIVB_F32 = 1e-5
# One card against four, both f32: the same arithmetic fused for other
# shapes, so round-off amplified by the branch flips above, as for f32
# against f64.
TOL_FOUR_L1 = 1e-5


class SmokeError(RuntimeError):
    """A check failed."""


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeError(msg)
    print(f"  ok: {msg}")


@contextlib.contextmanager
def precision(x64: bool):
    """Run with JAX's 64-bit mode set to ``x64`` and restore it after
    (a deck's arrays take their dtype from that mode)."""
    import jax
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", x64)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def nvidia_smi() -> str:
    """The card's name and power limit, read by a child process that
    does not touch JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


def hero_overrides(nx, mbx, ncycles):
    """Overrides of the hero deck: an (nx1, nx2, nx3) mesh in MeshBlocks
    of mbx^3, run for ncycles cycles (tlim is never reached)."""
    return [f"mesh/nx1={nx[0]}", f"mesh/nx2={nx[1]}", f"mesh/nx3={nx[2]}",
            f"meshblock/nx1={mbx}", f"meshblock/nx2={mbx}",
            f"meshblock/nx3={mbx}", f"time/nlim={ncycles}"]


def z4c_overrides(n, ncycles):
    """Overrides of the one-puncture deck: an n^3 mesh, RK4, ncycles."""
    return [f"mesh/nx1={n}", f"mesh/nx2={n}", f"mesh/nx3={n}",
            "time/integrator=rk4", f"time/nlim={ncycles}"]


class Run:
    """Host copies of one run's initial and final states."""

    def __init__(self, label, mesh, phys, driver, init, final, compiled):
        self.label = label
        self.mesh = mesh
        self.phys = phys
        self.driver = driver
        self.init = init
        self.final = final
        self.hlo = compiled.as_text()


def _host(state, keys):
    return {k: (np.asarray(state[k]) if not isinstance(state[k], dict)
                else {c: np.asarray(v) for c, v in state[k].items()})
            for k in keys if k in state}


def run_deck(label, deck, overrides, device, x64, outputs=False,
             dmesh=None):
    """One run down the CLI's path on ``device``: main.build ->
    Driver.initialize -> Driver.compile_cycle -> Driver.execute, with
    the deck's outputs when ``outputs`` (written under RUN_DIR).  With
    ``dmesh`` the blocks are sharded over that device mesh."""
    import jax

    from athenak_jax.athinput import ParameterInput
    from athenak_jax.main import build
    from athenak_jax.outputs import make_outputs

    print(f"[{label}]", flush=True)
    prec = "double" if x64 else "single"
    with precision(x64), jax.default_device(device):
        pin = ParameterInput.from_file(deck)
        pin.modify_from_cmdline(overrides + [f"job/precision={prec}"])
        if outputs:
            os.makedirs(RUN_DIR, exist_ok=True)
            pin.set_value("job", "basename", os.path.join(
                RUN_DIR, pin.get_string("job", "basename")))
        mesh, phys, pgen, driver, state = build(pin)
        outs = make_outputs(pin, mesh, phys) if outputs else []
        for out in outs:
            out.driver = driver
        driver.dmesh = dmesh
        state = driver.initialize(state)
        init = _host(state, ("u",))
        t0 = time.perf_counter()
        compiled = driver.compile_cycle(state)
        compile_s = time.perf_counter() - t0
        state = driver.execute(state, outputs=outs, verbose=True)
        state = jax.block_until_ready(state)
        final = _host(state, ("u", "bfc"))
    print(driver.finalize_report())
    print(f"  compile_seconds = {compile_s:.3f}")
    print(f"  memory_analysis = {compiled.memory_analysis()}")
    stats = device.memory_stats() or {}
    print(f"  peak_bytes_in_use = {stats.get('peak_bytes_in_use', 'n/a')}")
    return Run(label, mesh, phys, driver, init, final, compiled)


def _interior(a, ng, ndim=3):
    """Active cells of a [..., n3, n2, n1] block array."""
    sl = (slice(ng, -ng),) * ndim
    return a[(Ellipsis,) + sl]


def mhd_totals(u, ng):
    from athenak_jax.indices import IDN, IEN
    act = _interior(u, ng).astype(np.float64)
    return float(act[:, IDN].sum()), float(act[:, IEN].sum())


def max_divb(bfc, mesh):
    """max |div B| * dx / max |B| over active cells."""
    mbi = mesh.mb_indcs
    ng = mbi.ng
    nx1, nx2, nx3 = mbi.nx1, mbi.nx2, mbi.nx3
    ms = mesh.mesh_size
    b1 = bfc["x1f"][:, ng:ng + nx3, ng:ng + nx2, ng:ng + nx1 + 1]
    b2 = bfc["x2f"][:, ng:ng + nx3, ng:ng + nx2 + 1, ng:ng + nx1]
    b3 = bfc["x3f"][:, ng:ng + nx3 + 1, ng:ng + nx2, ng:ng + nx1]
    b1, b2, b3 = (b.astype(np.float64) for b in (b1, b2, b3))
    div = ((b1[..., 1:] - b1[..., :-1]) / ms.dx1
           + (b2[:, :, 1:] - b2[:, :, :-1]) / ms.dx2
           + (b3[:, 1:] - b3[:, :-1]) / ms.dx3)
    bmax = max(np.abs(b).max() for b in (b1, b2, b3))
    return float(np.abs(div).max() * min(ms.dx1, ms.dx2, ms.dx3) / bmax)


def _fields(state):
    """(name, group, array) for every variable of a host state.  The
    face-field components share one group: a component that starts at
    zero (the blast's By, Bz) is measured against the field as a whole."""
    out = [(f"u[{i}]", f"u[{i}]", state["u"][:, i])
           for i in range(state["u"].shape[1])]
    for c, v in sorted(state.get("bfc", {}).items()):
        out.append((f"bfc[{c}]", "bfc", v[:, None]))
    return out


def errors(a, b, ng, tight=None):
    """Per-variable errors of state ``a`` against reference ``b`` over
    active cells, relative to the variable's group: (name, max, L1,
    share of values off by more than ``tight``)."""
    rows, smax, ssum = [], {}, {}
    for (name, grp, x), (_, _, y) in zip(_fields(a), _fields(b)):
        x = _interior(x, ng).astype(np.float64)
        y = _interior(y, ng).astype(np.float64)
        d = np.abs(x - y)
        rows.append((name, grp, d))
        smax[grp] = max(smax.get(grp, 0.0), float(np.abs(y).max()))
        ssum[grp] = ssum.get(grp, 0.0) + float(np.abs(y).sum())
    out = []
    for name, grp, d in rows:
        sm = max(smax[grp], 1e-300)
        share = float((d > tight * sm).mean()) if tight else 0.0
        out.append((name, float(d.max()) / sm,
                    float(d.sum()) / max(ssum[grp], 1e-300), share))
    return out


def compare(a, b, ng, what, max_tol=None, l1_tol=None, tight=None,
            share_tol=None):
    """Check ``a`` against ``b``: the worst max-norm error against
    max_tol, the worst L1 error against l1_tol, and the worst share of
    values off by more than ``tight`` against share_tol (each optional;
    a non-finite error always fails)."""
    errs = errors(a, b, ng, tight)
    for k, (label, tol) in enumerate((("max", max_tol), ("L1", l1_tol),
                                      ("share", share_tol)), start=1):
        if label == "share" and tight is None:
            continue
        name, worst = max(((e[0], e[k]) for e in errs),
                          key=lambda t: (not np.isfinite(t[1]), t[1]))
        msg = (f"{what}: worst {label} error {worst:.3e} ({name})"
               + (f" beyond {tight:.0e}" if label == "share" else ""))
        if tol is None:
            check(bool(np.isfinite(worst)), msg + " (information)")
        else:
            check(bool(np.isfinite(worst)) and worst <= tol,
                  f"{msg} <= {tol:.0e}")


def no_matrix_products(run):
    """Matrix products could run in TF32 on the tensor cores; the
    cycles this script compares must have none."""
    txt = run.hlo
    found = [op for op in (" dot(", "convolution(", "cublas", "cudnn")
             if op in txt]
    check(not found, f"{run.label}: compiled cycle has no matrix product "
          f"(found: {found or 'none'})")


def phase_hero(device, nx=(256, 256, 256), mbx=128, ncycles=20):
    """Phase 1: the f32 hero with its bin output, and its checks."""
    r = run_deck("phase 1: hero f32", HERO_DECK,
                 hero_overrides(nx, mbx, ncycles), device, x64=False,
                 outputs=True)
    ng = r.mesh.mb_indcs.ng
    u = r.final["u"]
    check(bool(np.isfinite(u).all()) and all(
        np.isfinite(v).all() for v in r.final["bfc"].values()),
        "hero state is finite")
    check(r.mesh.ncycle == ncycles, f"hero ran {r.mesh.ncycle} cycles")
    m0, e0 = mhd_totals(r.init["u"], ng)
    m1, e1 = mhd_totals(u, ng)
    check(abs(m1 - m0) / abs(m0) <= TOL_CONSERVE_F32,
          f"mass conserved: rel change {abs(m1 - m0) / abs(m0):.3e} "
          f"<= {TOL_CONSERVE_F32:.0e}")
    check(abs(e1 - e0) / abs(e0) <= TOL_CONSERVE_F32,
          f"energy conserved: rel change {abs(e1 - e0) / abs(e0):.3e} "
          f"<= {TOL_CONSERVE_F32:.0e}")
    divb = max_divb(r.final["bfc"], r.mesh)
    check(divb <= TOL_DIVB_F32,
          f"max|div B| dx/max|B| = {divb:.3e} <= {TOL_DIVB_F32:.0e}")
    check(r.mesh.dt > 0.0, f"dt = {r.mesh.dt:.6e} > 0")
    no_matrix_products(r)
    return r


def _median_ms(fn, args, n=10):
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def phase_kernel(device, nx=(256, 256, 256), mbx=128, nx_small=(64, 64, 64),
                 mb_small=32):
    """The Triton x1 flux kernel as compiled for the card against XLA's
    plain path on the same device, on the initial hero state: f32 at
    the hero's size, f64 at the small size."""
    import jax

    from athenak_jax.athinput import ParameterInput
    from athenak_jax.main import build
    from athenak_jax.ops.plm_hlld_triton import (plm_hlld_x1,
                                                 plm_hlld_x1_plain)

    for x64, n, mb, tol in ((False, nx, mbx, TOL_KERNEL_F32),
                            (True, nx_small, mb_small, TOL_KERNEL_F64)):
        prec = "double" if x64 else "single"
        print(f"[phase 2: x1 flux kernel, {prec}, {n}]", flush=True)
        with precision(x64), jax.default_device(device):
            pin = ParameterInput.from_file(HERO_DECK)
            pin.modify_from_cmdline(hero_overrides(n, mb, 1)
                                    + [f"job/precision={prec}"])
            mesh, phys, pgen, driver, state = build(pin)
            state = driver.initialize(state)
            eos = driver.phys.eos
            args = (state["w"], state["bcc"], state["bfc"]["x1f"])
            kern = jax.jit(lambda w, b, x: plm_hlld_x1(w, b, x, eos))
            plain = jax.jit(lambda w, b, x: plm_hlld_x1_plain(w, b, x, eos))
            got = [np.asarray(a) for a in kern(*args)]
            ref = [np.asarray(a) for a in plain(*args)]
            t_k, t_p = _median_ms(kern, args), _median_ms(plain, args)
        print(f"  x1 flux: kernel {t_k:.3f} ms, XLA plain {t_p:.3f} ms")
        n1 = got[0].shape[-1]
        worst = max(float(np.abs(g[..., 2:n1 - 1] - r[..., 2:n1 - 1]).max())
                    / max(float(np.abs(r[..., 2:n1 - 1]).max()), 1e-300)
                    for g, r in zip(got, ref))
        check(worst <= tol, f"x1 flux kernel vs plain ({prec}): max "
              f"relative error {worst:.3e} <= {tol:.0e}")


def phase_reference(device, cpu, hero, nx_small=(64, 64, 64), mb_small=32,
                    ncycles_small=2):
    """Phase 2: f64 on ``device`` against f64 on ``cpu`` at a small
    size, and the phase-1 f32 hero against the same run in f64."""
    ovr = hero_overrides(nx_small, mb_small, ncycles_small)
    a = run_deck("phase 2: small f64 on the device", HERO_DECK, ovr,
                 device, x64=True)
    b = run_deck("phase 2: small f64 on the CPU", HERO_DECK, ovr, cpu,
                 x64=True)
    ng = a.mesh.mb_indcs.ng
    compare(a.final, b.final, ng, "device f64 vs CPU f64",
            l1_tol=TOL_F64_L1, tight=TOL_F64, share_tol=TOL_F64_SHARE)
    mbi = hero.mesh.mb_indcs
    nx = (hero.mesh.mesh_indcs.nx1, hero.mesh.mesh_indcs.nx2,
          hero.mesh.mesh_indcs.nx3)
    f64 = run_deck("phase 2: hero f64", HERO_DECK,
                   hero_overrides(nx, mbi.nx1, hero.mesh.ncycle), device,
                   x64=True)
    no_matrix_products(f64)
    compare(hero.final, f64.final, ng, "hero f32 vs f64",
            l1_tol=TOL_F32_L1)


def phase_z4c(device, cpu, n=128, ncycles=10, n_small=32,
              ncycles_small=2):
    """Phase 3: Z4c one puncture in f32, then f64 device vs CPU."""
    import jax

    r = run_deck("phase 3: z4c f32", Z4C_DECK, z4c_overrides(n, ncycles),
                 device, x64=False)
    ng = r.mesh.mb_indcs.ng
    check(bool(np.isfinite(r.final["u"]).all()), "z4c state is finite")
    with precision(False), jax.default_device(device):
        h, _ = jax.jit(r.phys.adm_constraints)(r.final["u"])
        h = np.asarray(_interior(np.asarray(h), ng), np.float64)
    hnorm = float(np.sqrt(np.mean(h * h)))
    check(bool(np.isfinite(hnorm)),
          f"Hamiltonian-constraint L2 norm = {hnorm:.6e} is finite")
    no_matrix_products(r)
    ovr = z4c_overrides(n_small, ncycles_small)
    a = run_deck("phase 3: z4c small f64 on the device", Z4C_DECK, ovr,
                 device, x64=True)
    b = run_deck("phase 3: z4c small f64 on the CPU", Z4C_DECK, ovr, cpu,
                 x64=True)
    compare(a.final, b.final, ng, "z4c device f64 vs CPU f64",
            l1_tol=TOL_F64_L1, tight=TOL_F64, share_tol=TOL_F64_SHARE)


def phase_four(devices, nx=(512, 512, 256), mbx=128, ncycles=10):
    """The hero weak-scaled over four devices (ppermute shard cycle)
    against the same deck on one device."""
    from athenak_jax.parallel import make_device_mesh

    ovr = hero_overrides(nx, mbx, ncycles)
    one = run_deck("four: hero on one device", HERO_DECK, ovr, devices[0],
                   x64=False)
    one_final, ng = one.final, one.mesh.mb_indcs.ng
    del one
    four = run_deck("four: hero on four devices", HERO_DECK, ovr,
                    devices[0], x64=False,
                    dmesh=make_device_mesh(devices=list(devices)))
    check(four.driver._layout is not None,
          "four-device run took the shard_map cycle")
    check("collective-permute" in four.hlo,
          "shard cycle halo exchange has collective-permutes")
    check("all-gather" not in four.hlo, "shard cycle has no all-gather")
    same = all(np.array_equal(x, y) for (_, _, x), (_, _, y)
               in zip(_fields(four.final), _fields(one_final)))
    print(f"  four vs one device bit-identical: {same}")
    compare(four.final, one_final, ng, "four devices vs one device",
            l1_tol=TOL_FOUR_L1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device phase")
    args = ap.parse_args(argv)

    import jax

    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        print("chip_smoke: JAX finds no GPU; this script runs only on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from athenak_jax.utils import enable_compile_cache
    enable_compile_cache()
    need = 4 if args.four else 1
    if len(gpus) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX finds {len(gpus)}",
              file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(f"[phase 0] platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())}")
    print(f"nvidia-smi: {nvidia_smi()}", flush=True)

    if args.four:
        phase_four(gpus[:4])
    else:
        cpu = jax.devices("cpu")[0]
        hero = phase_hero(gpus[0])
        phase_kernel(gpus[0])
        phase_reference(gpus[0], cpu, hero)
        del hero
        phase_z4c(gpus[0], cpu)

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
