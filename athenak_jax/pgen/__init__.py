"""Problem generators (initial conditions + optional final error hooks).

Parity target: the reference pgen registry and callback enrollment
(reference: src/pgen/pgen.hpp:27-93).  Each generator is a module with

    init(pin, mesh, phys) -> (u, w)        # device arrays, ghosts unfilled
    final(pin, mesh, phys, u) -> None      # optional, e.g. error reports

selected by <problem>/pgen_name, like the reference's runtime dispatch
(reference: src/pgen/pgen.cpp:910+).
"""

from __future__ import annotations

from importlib import import_module

_REGISTRY = {
    "linear_wave": "athenak_jax.pgen.linear_wave",
    "shock_tube": "athenak_jax.pgen.shock_tube",
    "advection": "athenak_jax.pgen.advection",
    "orszag_tang": "athenak_jax.pgen.orszag_tang",
    "binary_gravity": "athenak_jax.pgen.binary_gravity",
    "be_collapse": "athenak_jax.pgen.be_collapse",
    "disk_magnetosphere": "athenak_jax.pgen.disk_magnetosphere",
    "dynbbh": "athenak_jax.pgen.dynbbh",
    "blast": "athenak_jax.pgen.blast",
    "cpaw": "athenak_jax.pgen.cpaw",
    "alfven_wave": "athenak_jax.pgen.cpaw",
    "diffusion_test": "athenak_jax.pgen.diffusion_test",
    "field_loop": "athenak_jax.pgen.field_loop",
    "implode": "athenak_jax.pgen.lw_implode",
    "lw_implode": "athenak_jax.pgen.lw_implode",
    "mri3d": "athenak_jax.pgen.mri3d",
    "mri2d": "athenak_jax.pgen.mri2d",
    "gr_bondi": "athenak_jax.pgen.gr_bondi",
    "gr_monopole": "athenak_jax.pgen.gr_monopole",
    "gravity": "athenak_jax.pgen.jeans_wave",
    "jeans": "athenak_jax.pgen.jeans_wave",
    "turb": "athenak_jax.pgen.turb",
    "twofluid": "athenak_jax.pgen.twofluid",
    "z4c_linear_wave": "athenak_jax.pgen.z4c_linear_wave",
    "z4c_one_puncture": "athenak_jax.pgen.z4c_one_puncture",
    "rad_hohlraum": "athenak_jax.pgen.rad_hohlraum",
    "rad_snake": "athenak_jax.pgen.rad_snake",
    "rad_relax": "athenak_jax.pgen.rad_relax",
    "rad_shadow": "athenak_jax.pgen.rad_shadow",
    "rad_diffusion": "athenak_jax.pgen.rad_diffusion",
    "gr_torus": "athenak_jax.pgen.gr_torus",
    "kh": "athenak_jax.pgen.kh",
    "current_sheet": "athenak_jax.pgen.current_sheet",
    "shock_cloud": "athenak_jax.pgen.shock_cloud",
    "slotted_cyl": "athenak_jax.pgen.slotted_cyl",
    "slotted_cylinder": "athenak_jax.pgen.slotted_cyl",
    "rt": "athenak_jax.pgen.rt",
    "shu_osher": "athenak_jax.pgen.shu_osher",
    "shwave": "athenak_jax.pgen.shwave",
    "rad_linear_wave": "athenak_jax.pgen.rad_linear_wave",
    "rad_beam": "athenak_jax.pgen.rad_beam",
    "z4c_two_punctures": "athenak_jax.pgen.z4c_two_punctures",
    "z4c_two_puncture": "athenak_jax.pgen.z4c_two_punctures",
    "z4c_kerr_schild": "athenak_jax.pgen.z4c_kerr_schild",
    "kerr_schild": "athenak_jax.pgen.z4c_kerr_schild",
    "z4c_gauge_wave": "athenak_jax.pgen.z4c_gauge_wave",
    "z4c_stability": "athenak_jax.pgen.z4c_stability",
    "robust_stability": "athenak_jax.pgen.z4c_stability",
    "gauge_wave": "athenak_jax.pgen.z4c_gauge_wave",
    "z4c_boosted_puncture": "athenak_jax.pgen.z4c_boosted_puncture",
    "z4c_adm_import": "athenak_jax.pgen.import_id",
    "dyngr_bns_import": "athenak_jax.pgen.import_id",
    "tov": "athenak_jax.pgen.dyngr_tov",
    "dyngr_tov": "athenak_jax.pgen.dyngr_tov",
}


def get_pgen(name: str):
    if name not in _REGISTRY:
        raise ValueError(f"problem/pgen_name = '{name}' not found "
                         f"(available: {sorted(_REGISTRY)})")
    return import_module(_REGISTRY[name])


def state_from_prims(phys, w, bfc=None):
    """Build the initial state from primitive arrays in ONE jitted program.

    Problem generators compute ICs in host numpy; the device tail
    (compute_bcc -> prim_to_cons) would otherwise run as dozens of eager
    ops, each paying dispatch + per-op compile latency.  One jit makes the
    whole tail a single compile + single dispatch, and the numpy -> device
    transfer of (w, bfc) happens once as the jit arguments.
    """
    import jax

    if bfc is not None:
        def tail(wj, bfcj):
            bcc = phys.compute_bcc(bfcj)
            return phys.prim_to_cons(wj, bcc), bcc
        u, bcc = jax.jit(tail)(w, bfc)
        return phys.make_state(u, w, bfc, bcc=bcc)
    u = jax.jit(phys.prim_to_cons)(w)
    return phys.make_state(u, w)
