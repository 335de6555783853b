"""Driver: integrator tables, the jitted cycle function, and the main loop.

Parity target: the reference ``Driver`` (reference: src/driver/driver.cpp).
The 2S-register Shu-Osher coefficient tables are reproduced exactly
(reference: src/driver/driver.cpp:61-280).  The per-stage task lists become
one jitted ``cycle(u, w, dt) -> (u, w, dtnew, counters)`` function; the host
loop only advances time, decides dt (2x growth limit + CFL + tlim clamp,
reference: src/mesh/mesh.cpp:573-640), and triggers outputs.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

_HUGE = float(np.finfo(np.float32).max)


@dataclass
class IntegratorData:
    name: str
    nexp_stages: int
    cfl_limit: float
    gam0: List[float]
    gam1: List[float]
    beta: List[float]
    delta: List[float] = field(default_factory=lambda: [0.0] * 4)
    # ImEx extensions (reference: src/driver/driver.cpp:163-277)
    nimp_stages: int = 0
    a_twid: Optional[List[List[float]]] = None
    a_impl: float = 0.0


def make_integrator(name: str) -> IntegratorData:
    """RK coefficient tables (reference: src/driver/driver.cpp:96-160)."""
    if name == "rk1":
        return IntegratorData("rk1", 1, 1.0, [0.0], [1.0], [1.0])
    if name == "rk2":
        # Heun / SSPRK(2,2), Gottlieb (2009) eq 3.1
        return IntegratorData("rk2", 2, 1.0,
                              [0.0, 0.5], [1.0, 0.5], [1.0, 0.5])
    if name == "rk3":
        # SSPRK(3,3), Gottlieb (2009) eq 3.2
        return IntegratorData("rk3", 3, 1.0,
                              [0.0, 0.25, 2.0 / 3.0],
                              [1.0, 0.75, 1.0 / 3.0],
                              [1.0, 0.25, 2.0 / 3.0])
    if name == "rk4":
        # RK4()4[2S] from Table 2 of Ketcheson (2010)
        return IntegratorData(
            "rk4", 4, 1.3925,
            [0.0, 0.121098479554482, -3.843833699660025, 0.546370891121863],
            [1.0, 0.721781678111411, 2.121209265338722, 0.198653035682705],
            [1.193743905974738, 0.099279895495783,
             1.131678018054042, 0.310665766509336],
            [1.0, 0.217683334308543, 1.065841341361089, 0.0])
    if name == "imex2":
        # IMEX-SSP2(3,2,2), Pareschi & Russo (2005) Table III
        # (reference: driver.cpp:163-189); explicit part identical to rk2
        return IntegratorData(
            "imex2", 2, 1.0, [0.0, 0.5], [1.0, 0.5], [1.0, 0.5],
            nimp_stages=3,
            a_twid=[[-1.0, 0.0, 0.0],
                    [0.5, 0.0, 0.0],
                    [0.0, 0.25, 0.25]],
            a_impl=0.5)
    if name == "imex2+":
        # IMEX(4,3,2), Krapp et al. (2024) eq. 30 (reference:
        # driver.cpp:190-231); three explicit + four implicit stages
        g = 1.707106781186547  # 1 + 1/sqrt(2)
        return IntegratorData(
            "imex2+", 3, 1.0,
            [0.0, (2.0 * g - 1.0) / (2.0 * g * g), 1.0],
            [1.0, 1.0 - (2.0 * g - 1.0) / (2.0 * g * g), 0.0],
            [g, 1.0 / (2.0 * g), 0.0],
            nimp_stages=4,
            a_twid=[[0.0, 0.0, 0.0, 0.0],
                    [0.0, 0.0, 0.0, 0.0],
                    [0.0, 0.0, (1.0 - 2.0 * g * g) / (2.0 * g), 0.0],
                    [0.0, 0.0, 0.0, 0.0]],
            a_impl=g)
    if name == "imex3":
        # IMEX-SSP3(4,3,3), Pareschi & Russo (2005) Table VI
        # (reference: driver.cpp:232-272); explicit part identical to rk3
        a = 0.24169426078821
        b = 0.06042356519705
        e = 0.12915286960590
        return IntegratorData(
            "imex3", 3, 1.0,
            [0.0, 0.25, 2.0 / 3.0],
            [1.0, 0.75, 1.0 / 3.0],
            [1.0, 0.25, 2.0 / 3.0],
            nimp_stages=4,
            a_twid=[[-2.0 * a, 0.0, 0.0, 0.0],
                    [a, 1.0 - 2.0 * a, 0.0, 0.0],
                    [b, e - (1.0 - a) / 4.0, 0.5 - b - e - 1.25 * a, 0.0],
                    [(-2.0 / 3.0) * b, (1.0 - 4.0 * e) / 6.0,
                     (4.0 * (b + e + a) - 1.0) / 6.0, 2.0 * (1.0 - a) / 3.0]],
            a_impl=a)
    raise ValueError(f"integrator '{name}' not implemented "
                     "(valid: rk1, rk2, rk3, rk4, imex2, imex2+, imex3)")


class Driver:
    """Main evolution loop over a single physics module (hydro or MHD)."""

    # class-level runtime guards, set by the CLI (-t / -w flags,
    # reference: main.cpp walltime + utils/watchdog.cpp)
    wall_limit: Optional[float] = None
    watchdog = None

    def __init__(self, pin, mesh, phys) -> None:
        self.pin = pin
        self.mesh = mesh
        self.phys = phys
        self.time_evolution = pin.get_string("time", "evolution")
        if self.time_evolution not in ("static", "kinematic", "dynamic"):
            raise ValueError(
                f"time/evolution={self.time_evolution} not implemented")

        if self.time_evolution != "static":
            self.integrator = make_integrator(
                pin.get_or_add_string("time", "integrator", "rk2"))
            self.tlim = pin.get_real("time", "tlim")
            self.nlim = pin.get_or_add_integer("time", "nlim", -1)
            self.ndiag = pin.get_or_add_integer("time", "ndiag", 1)
            self.cfl_no = pin.get_or_add_real("time", "cfl_number", 0.8)

        self.ecounters: Dict[str, int] = {}
        self.nmb_updated = 0
        self._cycle_fn = None
        # mhd_jcon output needs the previous cycle's (w, bcc, dt) for
        # the time-centered Faraday tensor (reference: pmhd->wbcc_saved,
        # derived_variables.cpp:364-390)
        self.save_wbcc = any(
            b.startswith("output")
            and pin.does_parameter_exist(b, "variable")
            and "jcon" in pin.get_string(b, "variable")
            for b in pin.blocks)
        # adaptive mesh refinement (reference: MeshRefinement is attached
        # to the mesh after physics construction, main.cpp:363-366)
        self.pamr = None
        if getattr(mesh, "adaptive", False):
            from .amr import AMR
            self.pamr = AMR(pin, mesh)
            # pgen-enrolled criterion (reference: pgen user_ref_func)
            urf = getattr(phys, "user_refine_func", None)
            if urf is not None:
                self.pamr.user_ref_func = urf
        # optional jax.sharding.Mesh: shards the block axis over devices
        # (the analogue of MPI rank decomposition)
        self.dmesh = None
        # block-pool padding applied for the explicit shard_map cycle
        # (non-divisible nmb; reference allows any nmb >= nranks,
        # src/mesh/load_balance.cpp:55-63)
        self._npad = 0
        self._layout = None
        # block coalescing (uniform single-device meshes run as one
        # superblock; see parallel/coalesce.py)
        self.use_coalesce = pin.get_or_add_boolean(
            "mesh", "coalesce", True) if hasattr(pin, "get_or_add_boolean") \
            else True
        # x1-pencil lane packing for the block pool (applies when full
        # coalescing is off or unavailable; parallel/coalesce.py)
        self.use_pencil = pin.get_or_add_boolean(
            "mesh", "pencil_pack", True) if hasattr(
                pin, "get_or_add_boolean") else True
        self._coal = None
        self._block_phys = None

    # ------------------------------------------------------------------
    def make_cycle_fn(self) -> Callable:
        """The pure (un-jitted) one-cycle function: state, dt -> state, dtnew,
        counters.  Exposed for graft/compile checks and sharded execution."""
        integ = self.integrator
        phys = self.phys
        if hasattr(phys, "imex_cycle"):
            # two-fluid ImEx physics owns the whole cycle structure
            # (reference: interleaved DAG, src/ion-neutral/ion-neutral.hpp)
            return lambda state, dt: phys.imex_cycle(state, dt, integ)
        is_rk4 = integ.name == "rk4"

        def cycle(state, dt):
            # before-timeintegrator tasks (turbulence forcing, reference:
            # driver.cpp:401 "before_timeintegrator" task list)
            if getattr(phys, "pturb", None) is not None:
                state = phys.pturb.apply(state, dt, phys)
            if getattr(phys, "ppart", None) is not None:
                state = phys.ppart.push(state, dt)
            if getattr(phys, "psbox", None) is not None:
                # orbital advection, once per cycle (reference: OA tasks
                # in the hydro/MHD DAGs, src/shearing_box/
                # orbital_advection_{cc,fc}.cpp)
                u = phys.psbox.orbital_advect(state["u"], dt)
                u = phys.bvals.fill_ghosts(u)
                u = phys.psbox.remap_ghosts(u, state["t"])
                if "bfc" in state:
                    bfc = phys.psbox.orbital_advect_fc(state["bfc"], dt)
                    bfc = phys.fill_ghosts_fc(bfc)
                    bfc = phys.psbox.remap_ghosts_fc(bfc, state["t"])
                    bcc = phys.compute_bcc(bfc)
                    w, u, _ = phys.cons_to_prim(u, bcc)
                    state = dict(state, u=u, w=w, bfc=bfc, bcc=bcc)
                else:
                    w, u, _ = phys.cons_to_prim(u)
                    state = dict(state, u=u, w=w)
            saved = phys.save_state(state)
            counters_tot = None
            for s in range(integ.nexp_stages):
                if s > 0 and is_rk4:
                    saved = phys.accumulate_rk4(saved, state, integ.delta[s])
                state, counters = phys.stage_update(
                    state, saved, integ.gam0[s], integ.gam1[s],
                    integ.beta[s] * dt)
                if counters_tot is None:
                    counters_tot = counters
                else:
                    counters_tot = {k: counters_tot[k] + v
                                    for k, v in counters.items()}
            # after-timeintegrator tasks (on-device tracker ODEs etc.,
            # reference: driver.cpp "after_timeintegrator" task list)
            post = getattr(phys, "post_cycle", None)
            if post is not None:
                state = post(state, dt)
            if "t" in state:
                state = dict(state, t=state["t"] + dt)
            dtnew = phys.dt_from_state(state)
            return state, dtnew, counters_tot

        return cycle

    def _raw_cycle(self, state=None) -> Callable:
        if self.dmesh is not None and state is not None:
            from .parallel.shard_comm import (build_shard_cycle,
                                              supports_shard_cycle)
            if supports_shard_cycle(self, state):
                fn, _ = build_shard_cycle(self, self.dmesh, state)
                return fn
        return self.make_cycle_fn()

    def _build_cycle(self, state=None) -> Callable:
        if self.pamr is not None and self.pamr.use_pool:
            # fixed-capacity block pool: ONE compiled cycle(state, dt,
            # tables) for the whole adaptive run; tree updates only swap
            # table values (amr_pool.py)
            if self.pamr._pool_cycle is None:
                from .amr_pool import installed
                raw = self.make_cycle_fn()
                mesh, bvals = self.mesh, self.phys.bvals

                phys = self.phys

                def fn(s, dt, T):
                    with installed(mesh, bvals, T, phys):
                        return raw(s, dt)

                self.pamr._pool_cycle = jax.jit(fn, donate_argnums=(0,))
            pc = self.pamr._pool_cycle
            pamr = self.pamr
            return lambda s, dt: pc(s, dt, pamr.pool_T)
        return jax.jit(self._raw_cycle(state), donate_argnums=(0,))

    # ------------------------------------------------------------------
    def _build_batch_cycle(self, state, k: int) -> Callable:
        """K cycles fused in one dispatch with the dt chain ON DEVICE.

        Replaces the per-cycle host sync (``float(dtnew)``) that
        serializes dispatch (the reference has no such sync: its dt
        Allreduce overlaps the next cycle's task list).  The dt logic —
        2x growth limit, CFL, exact-tlim landing, nlim stop — runs in the
        scan step; cycles past tlim/nlim get dt=0 and are exact no-ops,
        so a batch never over-integrates.  One (time, ncycle) fetch per
        k cycles.
        """
        cycle = self._raw_cycle(state)
        tlim = self.tlim
        cfl = self.cfl_no

        def step(carry, _):
            state, t, dt, ncyc, nlim_eff = carry
            active = t < tlim
            if self.nlim >= 0:
                active = active & (ncyc < nlim_eff)
            dt_eff = jnp.where(active, dt, jnp.zeros_like(dt))
            state, dtnew, counters = cycle(state, dt_eff)
            t = t + dt_eff
            dtn = jnp.minimum(2.0 * dt, cfl * dtnew)
            dtn = jnp.where((t < tlim) & (t + dtn > tlim), tlim - t, dtn)
            dt = jnp.where(active, dtn, dt)
            ncyc = ncyc + active.astype(jnp.int32)
            if counters is not None:
                counters = {key: v * active.astype(v.dtype)
                            for key, v in counters.items()}
            return (state, t, dt, ncyc, nlim_eff), counters

        def batch(state, t, dt, ncyc, nlim_eff):
            carry, counters = jax.lax.scan(
                step, (state, t, dt, ncyc, nlim_eff), None, length=k)
            state, t, dt, ncyc, _ = carry
            if counters is not None:
                counters = {key: jnp.sum(v) for key, v in counters.items()}
            return state, t, dt, ncyc, counters

        # donate only the state: the scalar outputs of batch N stay
        # readable while batch N+1 runs, enabling one-batch lookahead in
        # execute() (the host fetch overlaps device compute)
        return jax.jit(batch, donate_argnums=(0,))

    def make_shard_cycle_fn(self, state):
        """The explicit shard_map cycle (ppermute halo exchange), un-jitted.
        Raises if the configuration is not covered; see
        parallel/shard_comm.supports_shard_cycle."""
        from .parallel.shard_comm import (build_shard_cycle,
                                          supports_shard_cycle)
        if self.dmesh is None:
            raise ValueError("make_shard_cycle_fn requires driver.dmesh")
        if not supports_shard_cycle(self, state):
            raise ValueError("configuration not covered by the shard_map "
                             "cycle; use make_cycle_fn (gather path)")
        fn, _ = build_shard_cycle(self, self.dmesh, state)
        return fn

    def compile_cycle(self, state):
        """Compile the per-cycle program for ``state`` ahead of the first
        cycle and return the compiled executable (its memory_analysis()
        and as_text() describe one cycle).  execute() then runs it
        instead of compiling on its first call.  Not for the AMR block
        pool, whose cycle takes its tables as a third argument."""
        dt = jnp.asarray(self.mesh.dt, dtype=state["u"].dtype)
        self._cycle_fn = self._build_cycle(state).lower(state, dt).compile()
        return self._cycle_fn

    # ------------------------------------------------------------------
    def initialize(self, state):
        """Ghost-zone init + first dt (reference: Driver::Initialize,
        src/driver/driver.cpp:314-372)."""
        if self.use_coalesce and self._coal is None and self.pamr is None:
            from .parallel.coalesce import maybe_coalesce
            coal = maybe_coalesce(self.pin, self.mesh, self.phys,
                                  self.dmesh)
            if coal is not None:
                self._coal = coal
                self._block_phys = self.phys
                self.phys = coal.phys2
                state = jax.jit(coal.pack)(state)
        if self._coal is None and self.pamr is None and self.use_pencil:
            # pool lane packing: merge x1-adjacent blocks into pencils
            # whose x1 extent is a multiple of 128.  That 128-wide tile is
            # a constraint of the earlier target hardware; whether the
            # packing pays on the GPU is not measured yet (the block pool
            # keeps >1 blocks and the pool ghost exchange in x2/x3)
            from .parallel.coalesce import maybe_coalesce
            coal = maybe_coalesce(self.pin, self.mesh, self.phys,
                                  self.dmesh, pencil=True)
            if coal is not None:
                self._coal = coal
                self._block_phys = self.phys
                self.phys = coal.phys2
                state = jax.jit(coal.pack)(state)
        state = jax.jit(self.phys.init_ghosts)(state)
        if self.time_evolution != "static" \
                and not getattr(self, "res_flag", False):
            dtnew = float(jax.jit(self.phys.dt_from_state)(state))
            self.mesh.dt = min(self.cfl_no * dtnew, _HUGE)
            if self.mesh.time < self.tlim and \
                    self.mesh.time + self.mesh.dt > self.tlim:
                self.mesh.dt = self.tlim - self.mesh.time
        if self.pamr is not None and self.pamr.use_pool \
                and self.dmesh is not None:
            # multi-device pool: capacity must tile the device mesh so
            # the slot axis shards evenly; the cycle stays ONE compiled
            # program per capacity rung (tables are traced inputs) with
            # XLA's SPMD partitioner moving donor slabs — the reference
            # analogue is rebuilding only comm metadata on amr_lb_seq_
            # changes (reference: src/mesh/mesh.hpp:176-184,
            # bvals.cpp:258-263)
            ndev = self.dmesh.devices.size
            self.pamr.capacity = -(-self.pamr.capacity // ndev) * ndev
        if self.pamr is not None and self.pamr.use_pool:
            state = self.pamr.init_pool(self, state)
        if self.dmesh is not None:
            from .parallel import shard_state
            from .parallel.shard_comm import (pad_state, shard_layout,
                                              supports_shard_cycle)
            if supports_shard_cycle(self, state):
                lay = shard_layout(self.mesh, self.dmesh.devices.size)
                self._npad = lay.nmb_pad - lay.nmb
                self._layout = lay
                state = pad_state(state, lay)
            state = shard_state(state, self.dmesh)
        return state

    def _absorb_batch(self, scalars, nc0: int) -> None:
        """Fetch one batch's (t, dt, ncyc, counters) into host bookkeeping
        (the only host sync per k cycles in batched execution)."""
        t_dev, dt_dev, ncyc_dev, counters = scalars
        mesh = self.mesh
        ncyc = int(ncyc_dev)
        mesh.time = float(t_dev)
        mesh.dt = float(dt_dev)
        self.nmb_updated += mesh.nmb_total * (nc0 + ncyc - mesh.ncycle)
        mesh.ncycle = nc0 + ncyc
        for key, v in (counters or {}).items():
            self.ecounters[key] = self.ecounters.get(key, 0) + int(v)

    def _unpadded(self, state):
        """View with block-pool padding stripped and superblock
        coalescing undone (for outputs/returns)."""
        if self._coal is not None:
            return self._coal.unpack(state)
        lay = getattr(self, "_layout", None)
        if self._npad == 0 and (lay is None or lay.identity):
            return state
        from .parallel.shard_comm import unpad_state
        return unpad_state(state, lay or self.mesh.nmb_total)

    # ------------------------------------------------------------------
    def execute(self, state, outputs=None, verbose: bool = False):
        """Main cycle loop (reference: Driver::Execute,
        src/driver/driver.cpp:380-460)."""
        if self.time_evolution == "static":
            return state
        if self._cycle_fn is None:
            self._cycle_fn = self._build_cycle(state)

        mesh = self.mesh
        outputs = outputs or []
        wall0 = _time.perf_counter()

        # multigrid defect diagnostics: one host-side verbose solve on
        # the current state (reference prints these inside every stage
        # solve, multigrid_driver.cpp:788-860; the jitted cycle solves
        # silently, so the diagnostic solve runs here)
        pgrav = getattr(self.phys, "pgrav", None)
        if pgrav is not None and getattr(pgrav, "show_defect", 0) > 0 \
                and hasattr(pgrav, "solve_verbose"):
            pgrav.solve_verbose(self._unpadded(state)["u"])

        # initial-condition outputs (skipped on restart, reference:
        # Driver::Initialize res_flag, driver.cpp:341)
        if not getattr(self, "res_flag", False):
            sv = self._unpadded(state)
            for out in outputs:
                out.maybe_write(mesh, sv["u"], sv["w"], force=True,
                                state=sv)

        dtype = state["u"].dtype
        # Batched dispatch: with no outputs/diagnostics due mid-run, run k
        # cycles per dispatch with the dt chain on device (one host sync
        # per batch instead of per cycle).
        use_batch = (not outputs) and not verbose \
            and self.pamr is None \
            and getattr(self.phys, "pturb", None) is None \
            and getattr(self.phys, "ppart", None) is None
        if use_batch:
            k = 16
            if self.nlim >= 0:
                # no-op (dt=0) cycles past nlim still cost full compute:
                # don't batch beyond the cycle limit
                k = max(1, min(k, self.nlim - mesh.ncycle))
            batch_fn = self._build_batch_cycle(state, k)
            t_dev = jnp.asarray(mesh.time, dtype=dtype)
            dt_dev = jnp.asarray(mesh.dt, dtype=dtype)
            nc0 = mesh.ncycle
            nlim_eff = jnp.asarray(
                (self.nlim - nc0) if self.nlim >= 0 else 2**31 - 1,
                dtype=jnp.int32)
            ncyc_dev = jnp.zeros((), jnp.int32)
            # One-batch lookahead: inspect batch N's scalars while batch
            # N+1 runs on device.  Cycles past tlim/nlim are exact no-ops
            # (dt=0), so the overshoot batch cannot over-integrate.
            prev = None            # (t, dt, ncyc, counters) of last batch
            while (mesh.time < self.tlim
                   and (self.nlim < 0 or mesh.ncycle < self.nlim)):
                if self.wall_limit is not None \
                        and _time.perf_counter() - wall0 > self.wall_limit:
                    print("wall-time limit reached; stopping cleanly")
                    break
                if self.watchdog is not None:
                    self.watchdog.pet()
                state, t_dev, dt_dev, ncyc_dev, counters = batch_fn(
                    state, t_dev, dt_dev, ncyc_dev, nlim_eff)
                if prev is not None:
                    self._absorb_batch(prev, nc0)
                prev = (t_dev, dt_dev, ncyc_dev, counters)
            if prev is not None:
                self._absorb_batch(prev, nc0)

        while not use_batch and (mesh.time < self.tlim
               and (self.nlim < 0 or mesh.ncycle < self.nlim)):
            if self.wall_limit is not None \
                    and _time.perf_counter() - wall0 > self.wall_limit:
                print("wall-time limit reached; stopping cleanly")
                break
            if self.watchdog is not None:
                self.watchdog.pet()
            if verbose and mesh.ncycle % self.ndiag == 0:
                print(f"cycle={mesh.ncycle} time={mesh.time:.6e} "
                      f"dt={mesh.dt:.6e}")
            if self.save_wbcc and "bcc" in state:
                sv = self._unpadded(state)
                if sv is state:
                    # the cycle donates its input buffers: keep copies
                    sv = {"w": jnp.copy(state["w"]),
                          "bcc": jnp.copy(state["bcc"])}
                self.phys._jcon_prev = (sv["w"], sv["bcc"], mesh.dt)

            state, dtnew, counters = self._cycle_fn(
                state, jnp.asarray(mesh.dt, dtype=dtype))

            mesh.time += mesh.dt
            mesh.ncycle += 1
            self.nmb_updated += mesh.nmb_total

            # accumulate event counters on host (async fetch)
            for k, v in (counters or {}).items():
                self.ecounters[k] = self.ecounters.get(k, 0) + int(v)

            # new dt: 2x growth limit, CFL, exact tlim stop
            dtnew = float(dtnew)
            mesh.dtold = mesh.dt
            dt = min(2.0 * mesh.dt, self.cfl_no * dtnew)
            if mesh.time < self.tlim and (mesh.time + dt) > self.tlim:
                dt = self.tlim - mesh.time
            mesh.dt = dt

            # adaptive refinement after the cycle (reference:
            # Driver::Execute, driver.cpp:448)
            if self.pamr is not None:
                state, changed = self.pamr.step(self, state,
                                                outputs=outputs)
                if changed:
                    mesh = self.mesh
                    if self.pamr.use_pool:
                        # same compiled cycle; only the tables changed
                        dtnew = self.pamr.pool_dt(self, state)
                    else:
                        self._cycle_fn = self._build_cycle(state)
                        # dt on the gid-order view (physics per-block
                        # tables are [nmb]; state may be pool-padded)
                        dtnew = float(jax.jit(self.phys.dt_from_state)(
                            self._unpadded(state)))
                    # respect the finer CFL immediately (reference:
                    # NewTimeStep calls after RedistAndRefine)
                    mesh.dt = min(mesh.dt, self.cfl_no * dtnew)

            if outputs and any(out.due(mesh) for out in outputs):
                sv = self._unpadded(state)
                for out in outputs:
                    out.maybe_write(mesh, sv["u"], sv["w"], state=sv)

        self.wall_seconds = _time.perf_counter() - wall0
        mbi = mesh.mb_indcs
        # per-block zone count x blocks updated (correct under AMR where
        # nmb_total varies over the run)
        self.zone_cycles = self.nmb_updated * (mbi.nx1 * mbi.nx2 * mbi.nx3)
        self.zcps = self.zone_cycles / max(self.wall_seconds, 1e-12)

        # final outputs
        state = self._unpadded(state)
        for out in outputs:
            out.maybe_write(mesh, state["u"], state["w"], force=True,
                            state=state)
        if self._block_phys is not None:
            self.phys = self._block_phys
        return state

    # ------------------------------------------------------------------
    def finalize_report(self) -> str:
        """zone-cycles/s report + load-balance telemetry (reference:
        Driver::Finalize, src/driver/driver.cpp:465-525 and the per-rank
        cost print, src/mesh/mesh.cpp:392-422)."""
        lines = [f"zone-cycles/cpu_second = {self.zcps:.6e}",
                 f"cycles = {self.mesh.ncycle}, wall = "
                 f"{self.wall_seconds:.3f} s"]
        lay = getattr(self, "_layout", None)
        if self.dmesh is not None and lay is not None:
            c = lay.cost_eachrank
            lines.append(
                f"ranks = {lay.ndev}, "
                f"load balancing efficiency = {lay.lb_efficiency:.3f}, "
                f"max/min cost = {c.max() / max(c.min(), 1e-30):.3f}, "
                f"blocks/rank = {lay.nmb_eachrank.tolist()}")
        return "\n".join(lines)
