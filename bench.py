"""Benchmark: 3D MHD blast zone-cycles/second on one GPU.

Mirrors the reference's own figure of merit — the zone-cycles/cpu_second
line printed at the end of every run (reference:
src/driver/driver.cpp:505-525) — on the headline 3D MHD blast workload
(BASELINE.md north star: >= 1e9 zone-cycles/s per GPU).

Cycles run as one on-device lax.scan per window and the clock stops on
``jax.block_until_ready``.  Reports the hero single-block number plus the
secondary cells: a multi-block configuration (8 x 62^3, coalesced and
through the block pool), Z4c one-puncture, SR blast and GR torus.

Every cell runs in a child process of its own, one at a time, and the
parent never imports JAX: a JAX process reserves most of the card's
memory, so only one may hold it.  Each cell prints the device it ran on
and fails where JAX finds no GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time


def _enable_compile_cache() -> None:
    """Persistent XLA compilation cache: repeat bench runs skip
    recompiles."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from athenak_jax.utils import enable_compile_cache
    enable_compile_cache()


Z4C_DECK = """
<job>
basename = bench_punc
precision = single

<mesh>
nghost = 2
nx1 = 60
x1min = -6.0
x1max = 6.0
ix1_bc = outflow
ox1_bc = outflow
nx2 = 60
x2min = -6.0
x2max = 6.0
ix2_bc = outflow
ox2_bc = outflow
nx3 = 60
x3min = -6.0
x3max = 6.0
ix3_bc = outflow
ox3_bc = outflow

<time>
evolution = dynamic
integrator = rk4
cfl_number = 0.25
tlim = 100.0

<z4c>
diss = 0.5

<problem>
pgen_name = z4c_one_puncture
punc_ADM_mass = 1.0
"""


GR_TORUS_DECK = """
<job>
basename = bench_torus
precision = single

<mesh>
nghost = 2
nx1 = 124
x1min = -20.0
x1max = 20.0
ix1_bc = outflow
ox1_bc = outflow
nx2 = 124
x2min = -20.0
x2max = 20.0
ix2_bc = outflow
ox2_bc = outflow
nx3 = 64
x3min = -10.0
x3max = 10.0
ix3_bc = outflow
ox3_bc = outflow

<coord>
general_rel = true
a = 0.9375
excise = true
dexcise = 1.0e-8
pexcise = 0.333e-10

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 10.0

<mhd>
eos = ideal
gamma = 1.4444444444444444
reconstruct = plm
rsolver = hlle
fofc = true

<problem>
pgen_name = gr_torus
r_edge = 6.0
r_peak = 12.0
b_norm = 0.1
potential_cutoff = 0.2
"""


DECK = """
<job>
basename = bench_blast
precision = single

<mesh>
nghost = 2
nx1 = {nx}
x1min = -1.0
x1max = 1.0
nx2 = {nx}
x2min = -1.0
x2max = 1.0
nx3 = {nx3}
x3min = -1.0
x3max = 1.0

<meshblock>
nx1 = {mbx}
nx2 = {mbx}
nx3 = {mb3}

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 10.0

<mhd>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hlld

<problem>
pgen_name = blast
inner_radius = 0.1
outer_radius = 0.25
prat = 100.0
b_amb = 0.1
"""


# SR MHD blast on the hero geometry: the MHD stage with the SR HLLE
# solver + the vectorized Kastaun c2p (ops/eos_sr.py); reference
# workload class: src/pgen/fluids/blast.cpp with <coord> special_rel
SR_DECK = """
<job>
basename = bench_srblast
precision = single

<mesh>
nghost = 2
nx1 = 124
x1min = -1.0
x1max = 1.0
nx2 = 124
x2min = -1.0
x2max = 1.0
nx3 = 124
x3min = -1.0
x3max = 1.0

<coord>
special_rel = true

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.25
tlim = 10.0

<mhd>
eos = ideal
gamma = 1.3333333333333333
reconstruct = plm
rsolver = hlle

<problem>
pgen_name = blast
inner_radius = 0.1
outer_radius = 0.25
prat = 5.0
b_amb = 0.1
"""


def run_config(nx: int, mbx: int, ncycles: int, npasses: int,
               coalesce: bool = True, nx3: int = 0) -> float:
    from athenak_jax.athinput import ParameterInput

    nx3 = nx3 or nx
    mb3 = nx3 if mbx == nx else mbx
    pin = ParameterInput.from_string(DECK.format(nx=nx, mbx=mbx,
                                                 nx3=nx3, mb3=mb3))
    if not coalesce:
        pin.set_value("mesh", "coalesce", "false")
    return _time_pin(pin, nx * nx * nx3, ncycles, npasses)


def run_deck(deck: str, zones: int, ncycles: int, npasses: int) -> float:
    from athenak_jax.athinput import ParameterInput

    return _time_pin(ParameterInput.from_string(deck), zones,
                     ncycles, npasses)


def _time_pin(pin, zones: int, ncycles: int, npasses: int) -> float:
    import jax
    import jax.numpy as jnp

    from athenak_jax.main import build

    mesh, phys, pgen, driver, state = build(pin)
    state = driver.initialize(state)
    dt = jnp.asarray(driver.mesh.dt, dtype=state["u"].dtype)

    cycle = driver.make_cycle_fn()

    def window(state, dt):
        def step(c, _):
            s, d = c
            s, dtn, _ = cycle(s, d)
            return (s, d), dtn
        (s, _), dts = jax.lax.scan(step, (state, dt), None, length=ncycles)
        return s, jnp.sum(dts)

    wf = jax.jit(window, donate_argnums=(0,))
    state, chk = jax.block_until_ready(wf(state, dt))   # compile + warm

    best = float("inf")
    for _ in range(npasses):
        t0 = time.perf_counter()
        state, chk = jax.block_until_ready(wf(state, dt))
        best = min(best, time.perf_counter() - t0)

    return zones * ncycles / best


# --- subprocess harness ----------------------------------------------------

def _run_case(case: str, ncycles: int, npasses: int) -> float:
    """Entry for one benchmark case (invoked as a subprocess)."""
    if case == "hero":
        nx = int(os.environ.get("BENCH_NX", "124"))
        nx3 = int(os.environ.get("BENCH_NX3", str(nx)))
        return run_config(nx, int(os.environ.get("BENCH_MBX", str(nx))),
                          ncycles, npasses, nx3=nx3)
    if case == "coalesced":
        return run_config(124, 62, ncycles, npasses)
    if case == "pool":
        return run_config(124, 62, ncycles, npasses, coalesce=False)
    if case == "z4c":
        return run_deck(Z4C_DECK, 60 ** 3, ncycles, npasses)
    if case == "sr":
        return run_deck(SR_DECK, 124 ** 3, ncycles, npasses)
    if case == "gr_torus":
        # flagship GR MHD astrophysics config (reference:
        # src/pgen/fluids/gr_torus.cpp + inputs/grmhd/ SANE decks)
        return run_deck(GR_TORUS_DECK, 124 * 124 * 64, ncycles, npasses)
    raise ValueError(case)


def _device_info() -> dict | None:
    """The GPU this process runs on, or None where JAX finds none."""
    import jax
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        return None
    if not gpus:
        return None
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()),
            "card": r.stdout.strip().splitlines()[0]}


def _child(case: str, ncycles: int, npasses: int) -> int:
    _enable_compile_cache()
    dev = _device_info()
    if dev is None:
        print("bench: JAX finds no GPU; the benchmark runs only on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    print("BENCH_DEVICE " + json.dumps(dev), flush=True)
    v = _run_case(case, ncycles, npasses)
    print("BENCH_RESULT " + json.dumps({"value": v}))
    return 0


def _spawn_case(case: str, ncycles: int, npasses: int,
                timeout: float):
    """Run one case in a fresh process: (value, device), each None on
    failure or timeout."""
    cmd = [sys.executable, os.path.abspath(__file__),
           "--case", case, str(ncycles), str(npasses)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
    except subprocess.TimeoutExpired:
        print(f"bench case {case}: timed out after {timeout:.0f}s",
              file=sys.stderr)
        return None, None
    value = dev = None
    for line in (r.stdout or "").strip().splitlines():
        if line.startswith("BENCH_DEVICE "):
            dev = json.loads(line[len("BENCH_DEVICE "):])
            print(f"bench case {case}: {dev}", file=sys.stderr)
        elif line.startswith("BENCH_RESULT "):
            v = float(json.loads(line[len("BENCH_RESULT "):])["value"])
            value = v if math.isfinite(v) else None
    if r.returncode != 0 or value is None:
        tail = (r.stderr or "").strip().splitlines()[-3:]
        print(f"bench case {case}: rc={r.returncode}: " + " | ".join(tail),
              file=sys.stderr)
        return None, dev
    return value, dev


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--case":
        return _child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))

    # Default 124^3 (padded extent 128 with 2 ghost cells): the sizes of
    # the cells are kept from earlier rounds and not yet chosen for the
    # GPU.
    ncycles = int(os.environ.get("BENCH_NCYCLES", "120"))
    npasses = int(os.environ.get("BENCH_NPASSES", "2"))
    # budgets sized for cold compile caches
    per_case_timeout = float(os.environ.get("BENCH_CASE_TIMEOUT", "600"))
    deadline = time.monotonic() + float(
        os.environ.get("BENCH_BUDGET", "1800"))

    zcps, dev = _spawn_case("hero", ncycles, npasses, per_case_timeout)
    if zcps is None:
        print("bench: the hero cell failed", file=sys.stderr)
        return 1
    out = {
        "metric": "zone_cycles_per_second_3d_mhd_blast",
        "value": zcps,
        "unit": "zone-cycles/s",
        "vs_baseline": zcps / 1.0e9,
        "device": dev,
    }
    # Secondary cells:
    #  - coalesced: 8 x 62^3 uniform mesh repacked into one superblock
    #    (parallel/coalesce.py) — the default user path.
    #  - pool: the same mesh forced down the true block-pool
    #    halo-exchange path real SMR/AMR/multi-device decks hit.
    #  - z4c: one-puncture 60^3 rk4 — the NR configuration.
    #  - sr: SR MHD blast; gr_torus: GR MHD Fishbone-Moncrief torus.
    secondaries = []
    if os.environ.get("BENCH_MULTIBLOCK", "1") != "0":
        secondaries += [("coalesced", "multi_block_8x62_value",
                         max(ncycles, 5), 1),
                        ("pool", "multi_block_8x62_pool_value",
                         max(2 * ncycles, 5), 1)]
    if os.environ.get("BENCH_Z4C", "1") != "0":
        secondaries += [("z4c", "z4c_puncture_60_value",
                         max(3 * ncycles // 2, 5), 1)]
    if os.environ.get("BENCH_SR", "1") != "0":
        secondaries += [("sr", "sr_blast_124_value",
                         max(ncycles, 5), 1)]
    if os.environ.get("BENCH_GR", "1") != "0":
        secondaries += [("gr_torus", "gr_torus_124_value",
                         max(ncycles // 2, 5), 1)]
    failed = False
    for case, key, nc, np_ in secondaries:
        left = deadline - time.monotonic()
        if left < 30:
            print(f"bench case {case}: skipped (budget exhausted)",
                  file=sys.stderr)
            out[key.replace("_value", "_skipped")] = True
            failed = True
            continue
        v, _ = _spawn_case(case, nc, np_, min(per_case_timeout, left))
        if v is not None:
            out[key] = v
        else:
            # explicit marker so consumers can tell "timed out / failed"
            # from "not run"
            out[key.replace("_value", "_failed")] = True
            failed = True

    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
