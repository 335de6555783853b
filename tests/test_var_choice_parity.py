"""Output-variable parity vs the reference's 154-entry var_choice table
(reference: src/outputs/outputs.hpp:24-105).

Every reference name must resolve through outputs.variables.resolve on a
deck with the matching physics — this is the line-by-line inventory
check for SURVEY.md row 35.  Exceptions (documented): 'prtcl_all' is a
raw particle dump handled by the trk output type, not a grid variable.
"""

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build
from athenak_jax.outputs.variables import resolve

HYDRO_NAMES = [
    "hydro_u_d", "hydro_u_m1", "hydro_u_m2", "hydro_u_m3", "hydro_u_e",
    "hydro_u", "hydro_w_d", "hydro_w_vx", "hydro_w_vy", "hydro_w_vz",
    "hydro_w_e", "hydro_w", "hydro_u_s", "hydro_w_s",
    "hydro_wz", "hydro_w2", "hydro_sgs",
]

MHD_NAMES = [
    "mhd_u_d", "mhd_u_m1", "mhd_u_m2", "mhd_u_m3", "mhd_u_e", "mhd_u",
    "mhd_w_d", "mhd_w_vx", "mhd_w_vy", "mhd_w_vz", "mhd_w_e", "mhd_w",
    "mhd_u_s", "mhd_w_s", "mhd_wz", "mhd_w2",
    "mhd_bcc1", "mhd_bcc2", "mhd_bcc3", "mhd_bcc", "mhd_u_bcc",
    "mhd_w_bcc",
    "mhd_jz", "mhd_j2", "mhd_curv", "mhd_k_jxb", "mhd_curv_perp",
    "mhd_bmag", "mhd_divb", "mhd_jcon", "mhd_sgs", "mhd_dynamo_ks",
]

RAD_NAMES = ["rad_coord", "rad_fluid", "rad_coord_fluid"]
RAD_FLUID_PREFIXED = [
    "rad_hydro_u_d", "rad_hydro_u_m1", "rad_hydro_u_m2", "rad_hydro_u_m3",
    "rad_hydro_u_e", "rad_hydro_u", "rad_hydro_w_d", "rad_hydro_w_vx",
    "rad_hydro_w_vy", "rad_hydro_w_vz", "rad_hydro_w_e", "rad_hydro_w",
    "rad_hydro_u_s", "rad_hydro_w_s",
    "rad_mhd_u_d", "rad_mhd_u_m1", "rad_mhd_u_m2", "rad_mhd_u_m3",
    "rad_mhd_u_e", "rad_mhd_u", "rad_mhd_w_d", "rad_mhd_w_vx",
    "rad_mhd_w_vy", "rad_mhd_w_vz", "rad_mhd_w_e", "rad_mhd_w",
    "rad_mhd_u_s", "rad_mhd_w_s", "rad_mhd_bcc1", "rad_mhd_bcc2",
    "rad_mhd_bcc3", "rad_mhd_bcc", "rad_mhd_u_bcc", "rad_mhd_w_bcc",
]

ADM_NAMES = [
    "adm_gxx", "adm_gxy", "adm_gxz", "adm_gyy", "adm_gyz", "adm_gzz",
    "adm_Kxx", "adm_Kxy", "adm_Kxz", "adm_Kyy", "adm_Kyz", "adm_Kzz",
    "adm_psi4", "adm_alpha", "adm_betax", "adm_betay", "adm_betaz",
    "adm",
]

Z4C_NAMES = [
    "z4c_chi", "z4c_gxx", "z4c_gxy", "z4c_gxz", "z4c_gyy", "z4c_gyz",
    "z4c_gzz", "z4c_Khat", "z4c_Axx", "z4c_Axy", "z4c_Axz", "z4c_Ayy",
    "z4c_Ayz", "z4c_Azz", "z4c_Gamx", "z4c_Gamy", "z4c_Gamz",
    "z4c_Theta", "z4c_alpha", "z4c_betax", "z4c_betay", "z4c_betaz",
    "z4c",
]

WEYL_NAMES = ["weyl_rpsi4", "weyl_ipsi4", "weyl"]
CON_NAMES = ["con_C", "con_H", "con_M", "con_Z", "con_Mx", "con_My",
             "con_Mz", "con"]
TMUNU_NAMES = [
    "tmunu_Sxx", "tmunu_Sxy", "tmunu_Sxz", "tmunu_Syy", "tmunu_Syz",
    "tmunu_Szz", "tmunu_E", "tmunu_Sx", "tmunu_Sy", "tmunu_Sz", "tmunu"]
MISC_NAMES = ["turb_force", "prtcl_all", "prtcl_d", "grav_phi", "mhd_t"]

DOCUMENTED_EXCEPTIONS = {"prtcl_all"}  # raw dump -> trk output type


def test_name_count_matches_reference():
    total = (len(HYDRO_NAMES) + len(MHD_NAMES) + len(RAD_NAMES)
             + len(RAD_FLUID_PREFIXED) + len(ADM_NAMES) + len(Z4C_NAMES)
             + len(WEYL_NAMES) + len(CON_NAMES) + len(TMUNU_NAMES)
             + len(MISC_NAMES))
    assert total == 154


_DECK = """
<job>
basename = vc

<mesh>
nghost = 2
nx1 = 8
x1min = -0.5
x1max = 0.5
nx2 = 8
x2min = -0.5
x2max = 0.5
nx3 = 8
x3min = -0.5
x3max = 0.5

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 1.0

{phys}
"""

_MHD = """
<mhd>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hlld
nscalars = 1

<problem>
pgen_name = blast
inner_radius = 0.1
outer_radius = 0.25
prat = 10.0
b_amb = 0.5
"""

_HYDRO = """
<hydro>
eos = ideal
gamma = 1.4
reconstruct = plm
rsolver = hllc
nscalars = 1

<problem>
pgen_name = blast
inner_radius = 0.1
outer_radius = 0.25
prat = 10.0
"""


def _build(phys_block):
    pin = ParameterInput.from_string(_DECK.format(phys=phys_block))
    mesh, phys, pgen, driver, state = build(pin)
    state = driver.initialize(state)
    return mesh, phys, driver, state


def _check(names, phys, state, mesh):
    for name in names:
        if name in DOCUMENTED_EXCEPTIONS:
            continue
        labels, arr = resolve(name, phys, state, mesh)
        assert len(labels) == arr.shape[1], name
        assert np.isfinite(np.asarray(arr)).all(), name


def test_hydro_names():
    mesh, phys, driver, state = _build(_HYDRO)
    _check(HYDRO_NAMES, phys, state, mesh)


def test_mhd_names():
    mesh, phys, driver, state = _build(_MHD)
    phys._jcon_prev = (state["w"], state["bcc"], 0.01)
    try:
        _check([n for n in MHD_NAMES if n != "mhd_t"], phys, state, mesh)
    finally:
        phys._jcon_prev = None


def test_rad_prefixed_names():
    """rad_hydro_* / rad_mhd_* strip to the fluid fields (the reference
    exposes the same data under both names); the rad_* moment variables
    resolve on a radiation + hydro coupled deck."""
    mesh, phys, driver, state = _build(_MHD)
    _check([n for n in RAD_FLUID_PREFIXED if "mhd" in n],
           phys, state, mesh)
    mesh, phys, driver, state = _build(_HYDRO)
    _check([n for n in RAD_FLUID_PREFIXED if "hydro" in n],
           phys, state, mesh)

    import importlib.util
    import sys as _sys
    spec = importlib.util.spec_from_file_location(
        "trg", "tests/test_rad_gr.py")
    trg = importlib.util.module_from_spec(spec)
    _sys.modules["trg"] = trg
    spec.loader.exec_module(trg)
    pin = ParameterInput.from_string(trg.RAD_LWAVE_DECK)
    pin.modify_from_cmdline(["mesh/nx1=16", "meshblock/nx1=16"])
    mesh, phys, pgen, driver, state = build(pin)
    state = driver.initialize(state)
    _check(RAD_NAMES, phys, state, mesh)


def test_z4c_family_names():
    deck = """
<job>
basename = vc

<mesh>
nghost = 2
nx1 = 8
x1min = -4.0
x1max = 4.0
ix1_bc = outflow
ox1_bc = outflow
nx2 = 8
x2min = -4.0
x2max = 4.0
ix2_bc = outflow
ox2_bc = outflow
nx3 = 8
x3min = -4.0
x3max = 4.0
ix3_bc = outflow
ox3_bc = outflow

<time>
evolution = dynamic
integrator = rk3
cfl_number = 0.25
tlim = 0.1

<z4c>
diss = 0.1

<problem>
pgen_name = z4c_one_puncture
"""
    pin = ParameterInput.from_string(deck)
    mesh, phys, pgen, driver, state = build(pin)
    state = driver.initialize(state)
    _check(Z4C_NAMES + ADM_NAMES + CON_NAMES + WEYL_NAMES,
           phys, state, mesh)
