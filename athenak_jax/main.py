"""Entry point / CLI.

Parity target: reference src/main.cpp:61-420 CLI flags:
  -i <file>   input athinput file
  -d <dir>    run directory
  -n          dump parameters and quit
  -c          show configuration and quit
  -m          output mesh structure and quit
  -v          validate input deck (construct everything, check params, exit)
  -t hh:mm:ss wall-time limit
plus block/par=value command-line overrides.

Also exposes ``run(pin)``, the programmatic API the test-suite uses
(the reference test harness shells out to the binary; ours can do both).
"""

from __future__ import annotations

import argparse
import os
import sys
import time as _time

import numpy as np


def setup_precision(pin) -> None:
    """Enable f64 unless <job>/precision=single.

    The reference selects precision at compile time
    (reference: config.hpp.in SINGLE_PRECISION_ENABLED, src/athena.hpp:22-36);
    we select per-run before building any arrays.
    """
    import jax
    prec = "double"
    if pin.does_block_exist("job") and \
            pin.does_parameter_exist("job", "precision"):
        prec = pin.get_string("job", "precision")
    if prec == "double":
        jax.config.update("jax_enable_x64", True)
    elif prec != "single":
        raise ValueError(f"job/precision={prec} must be single|double")


def make_physics(pin, mesh, bvals):
    """Select and construct the physics module for this input deck
    (reference: MeshBlockPack::AddPhysics, meshblock_pack.cpp:102-235).
    Also used by the AMR rebuild (amr.py) after a tree update."""
    from .physics.hydro import Hydro

    if pin.does_block_exist("radiation") \
            and not pin.does_block_exist("hydro") \
            and not pin.does_block_exist("mhd"):
        # radiation-only transport (reference: AddPhysics radiation branch)
        from .radiation.radiation import Radiation
        phys = Radiation(pin, mesh, bvals)
    elif pin.does_block_exist("radiation") \
            and not (pin.does_block_exist("adm")
                     or pin.does_block_exist("z4c")):
        # coupled radiation + hydro/MHD (reference: AddPhysics
        # rad_hydro/rad_mhd branches + RadFluidCoupling)
        from .radiation.rad_fluid import RadiationFluid
        phys = RadiationFluid(pin, mesh, bvals)
    elif pin.does_block_exist("mhd") and (
            pin.does_block_exist("adm") or pin.does_block_exist("z4c")):
        # dynamical GRMHD: <mhd>+<adm> fixed spacetime, or <mhd>+<z4c>
        # fully coupled (reference: AddPhysics dyn_grmhd branch,
        # meshblock_pack.cpp:205-235)
        from .dyngr import DynGRMHD
        phys = DynGRMHD(pin, mesh, bvals)
    elif pin.does_block_exist("z4c"):
        # vacuum numerical relativity (reference: AddPhysics z4c branch)
        from .z4c.z4c import Z4c
        phys = Z4c(pin, mesh, bvals)
    elif pin.does_block_exist("ion-neutral"):
        # two-fluid: <hydro> neutrals + <mhd> ions, ImEx-coupled
        # (reference: meshblock_pack.cpp AddPhysics ion-neutral branch)
        from .physics.ion_neutral import IonNeutral
        if not (pin.does_block_exist("hydro")
                and pin.does_block_exist("mhd")):
            raise ValueError(
                "<ion-neutral> requires both <hydro> and <mhd> blocks")
        phys = IonNeutral(pin, mesh, bvals)
    elif pin.does_block_exist("mhd"):
        from .physics.mhd import MHD  # noqa: deferred import (round >=1 MHD)
        phys = MHD(pin, mesh, bvals)
    elif pin.does_block_exist("hydro"):
        phys = Hydro(pin, mesh, bvals)
    else:
        raise ValueError("no <hydro> or <mhd> block in input file")
    return phys


def build(pin, leaves=None):
    """Construct mesh -> physics -> pgen -> driver (reference main.cpp
    order).  ``leaves`` rebuilds an evolved tree on restart
    (reference: Mesh::BuildTreeFromRestart, mesh/build_tree.cpp)."""
    from .bvals import BoundaryValues
    from .driver import Driver
    from .mesh import Mesh
    from .pgen import get_pgen

    setup_precision(pin)
    mesh = Mesh(pin, leaves=leaves)
    bvals = BoundaryValues(mesh)
    phys = make_physics(pin, mesh, bvals)

    pgen_name = pin.get_string("problem", "pgen_name")
    pgen = get_pgen(pgen_name)
    state = pgen.init(pin, mesh, phys)

    # pgen may rescale tlim (linear wave); Driver reads <time> afterwards,
    # matching the reference construction order (main.cpp:351-374)
    driver = Driver(pin, mesh, phys)
    return mesh, phys, pgen, driver, state


def run(pin, verbose: bool = False):
    """Full run; returns (mesh, phys, driver, state)."""
    from .outputs import make_outputs

    mesh, phys, pgen, driver, state = build(pin)
    outputs = make_outputs(pin, mesh, phys)
    for out in outputs:
        out.driver = driver
    state = driver.initialize(state)
    state = driver.execute(state, outputs=outputs, verbose=verbose)
    # AMR rebuilds mesh/phys during execute; report against the final tree
    mesh, phys = driver.mesh, driver.phys
    if hasattr(pgen, "final"):
        pgen.final(pin, mesh, phys, state)
    return mesh, phys, driver, state


def run_restart(restart_file: str, overrides=None, verbose: bool = False):
    """Resume from a .rst checkpoint (reference restart path:
    src/main.cpp:250-277, Mesh::BuildTreeFromRestart).

    The mesh and physics are rebuilt from the stored parameter dump
    (cmdline overrides applied on top, like ``-r file -i deck`` merging);
    the evolved state replaces the problem generator's ICs.
    """
    from .athinput import ParameterInput
    from .outputs import load_restart, make_outputs

    params, time, dt, ncycle, rstate, extras = load_restart(
        restart_file, with_extras=True)
    pin = ParameterInput.from_string(params)
    if overrides:
        pin.modify_from_cmdline(overrides)

    # rebuild the EVOLVED tree, not the deck's initial tree
    # (reference: BuildTreeFromRestart reads the stored lloc list)
    mesh, phys, pgen, driver, state = build(
        pin, leaves=extras.get("tree_leaves"))
    if driver.pamr is not None and "amr_ncyc_since_ref" in extras:
        driver.pamr.ncyc_since_ref = np.asarray(
            extras["amr_ncyc_since_ref"]).copy()
    # replace pgen ICs with the checkpointed state; pgen.init already ran
    # so any user callbacks (BCs, srcterms) are enrolled
    state = {k: (v if not isinstance(v, dict)
                 else {k2: v2 for k2, v2 in v.items()})
             for k, v in rstate.items()}
    mesh.time, mesh.dt, mesh.ncycle = time, dt, ncycle
    driver.res_flag = True

    outputs = make_outputs(pin, mesh, phys)
    # skip output intervals already passed
    for out in outputs:
        if out.params.dt > 0.0:
            import math
            nskip = int(math.floor((time + 1e-12) / out.params.dt)) + 1
            out.params.file_number = nskip
            out.params.last_time = nskip * out.params.dt - out.params.dt

    state = driver.initialize(state)
    state = driver.execute(state, outputs=outputs, verbose=verbose)
    # AMR rebuilds mesh/phys during execute; report against the final tree
    mesh, phys = driver.mesh, driver.phys
    if hasattr(pgen, "final"):
        pgen.final(pin, mesh, phys, state)
    return mesh, phys, driver, state


def main(argv=None) -> int:
    from .athinput import ParameterInput

    from .utils import enable_compile_cache
    enable_compile_cache()

    ap = argparse.ArgumentParser(prog="athenak_jax")
    ap.add_argument("-i", dest="input", help="input athinput file")
    ap.add_argument("-r", dest="restart", help="restart (.rst) file",
                    default=None)
    ap.add_argument("-d", dest="rundir", help="run directory", default=None)
    ap.add_argument("-n", dest="dump_params", action="store_true",
                    help="dump parameters and quit")
    ap.add_argument("-c", dest="show_config", action="store_true",
                    help="show configuration and quit")
    ap.add_argument("-m", dest="show_mesh", action="store_true",
                    help="output mesh structure and quit")
    ap.add_argument("-v", dest="validate", action="store_true",
                    help="validate input file and quit")
    ap.add_argument("-t", dest="walltime", default=None,
                    help="wall time limit hh:mm:ss")
    ap.add_argument("-p", dest="profile_dir", default=None,
                    help="write a jax.profiler trace (TensorBoard/"
                         "Perfetto) of the run to this directory")
    ap.add_argument("-w", dest="watchdog", default=None, type=float,
                    help="watchdog hang-abort window in seconds")
    ap.add_argument("overrides", nargs="*",
                    help="block/par=value parameter overrides")
    args = ap.parse_args(argv)

    if args.show_config:
        import jax
        print(f"athenak_jax on jax {jax.__version__}, "
              f"devices: {jax.devices()}")
        return 0

    if args.restart:
        from .main import run_restart
        restart_path = os.path.abspath(args.restart)
        if args.rundir:
            os.makedirs(args.rundir, exist_ok=True)
            os.chdir(args.rundir)
        mesh, phys, driver, state = run_restart(
            restart_path, overrides=args.overrides, verbose=True)
        print(driver.finalize_report())
        return 0

    if not args.input:
        ap.error("an input file is required (-i)")
    pin = ParameterInput.from_file(args.input)
    pin.modify_from_cmdline(args.overrides)

    if args.rundir:
        os.makedirs(args.rundir, exist_ok=True)
        os.chdir(args.rundir)

    if args.dump_params:
        pin.dump(sys.stdout)
        return 0

    if args.show_mesh or args.validate:
        from .mesh import Mesh
        setup_precision(pin)
        mesh = Mesh(pin)
        if args.show_mesh:
            print(f"nmb_total={mesh.nmb_total} "
                  f"({mesh.nmb_x1}x{mesh.nmb_x2}x{mesh.nmb_x3} root blocks)")
            for gid in range(mesh.nmb_total):
                loc = mesh.lloc_eachmb[gid]
                lev = int(mesh.mb_lev[gid])
                print(f"  gid={gid} lloc=({loc[0]},{loc[1]},{loc[2]}) "
                      f"level={lev}")
        if args.validate:
            from .outputs import make_outputs
            _, phys2, _, _, _ = build(pin)
            make_outputs(pin, mesh, phys2)
            pin.check_unused_parameters()
            print("validation complete")
        return 0

    wd = None
    if args.watchdog:
        from .utils import WatchDog
        wd = WatchDog(args.watchdog)
    import athenak_jax.driver as _drv
    if args.walltime:
        from .utils import parse_walltime
        try:
            _drv.Driver.wall_limit = parse_walltime(args.walltime)
        except ValueError:
            ap.error(f"-t expects hh:mm:ss, got '{args.walltime}'")
    if wd is not None:
        _drv.Driver.watchdog = wd
    if args.profile_dir:
        # tracing/profiling parity: the reference relies on named Kokkos
        # kernels + external profilers (SURVEY section 5); here the XLA
        # ops land in a jax.profiler trace viewable in TensorBoard/Perfetto
        import jax
        with jax.profiler.trace(args.profile_dir):
            mesh, phys, driver, state = run(pin, verbose=True)
    else:
        mesh, phys, driver, state = run(pin, verbose=True)
    if wd is not None:
        wd.stop()
    print(driver.finalize_report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
