"""3D MRI on a statically refined mesh: shearing box x SMR.

The reference composes shearing-box boundaries with the mesh tree
(reference: src/shearing_box/shearing_box.hpp:77 FindTargetMB,
remap_fluxes.hpp:15-69); here the supported layout is z-slab refinement
(regions spanning the full x1/x2 extent — the standard refined
stratified/HGB configuration), with per-level sheared ring tables.
"""

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import build, run
from athenak_jax.vis.readers import read_hst

DECK = """
<job>
basename = HGBR

<mesh>
nghost = 2
nx1 = 32
x1min = -0.5
x1max = 0.5
ix1_bc = shear_periodic
ox1_bc = shear_periodic
nx2 = 32
x2min = -1.0
x2max = 1.0
ix2_bc = periodic
ox2_bc = periodic
nx3 = 16
x3min = -0.5
x3max = 0.5
ix3_bc = periodic
ox3_bc = periodic

<meshblock>
nx1 = 16
nx2 = 16
nx3 = 4

<mesh_refinement>
refinement = static
num_levels = 2

<refined_region1>
level = 1
x1min = -0.5
x1max = 0.5
x2min = -1.0
x2max = 1.0
x3min = -0.25
x3max = 0.25

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
nlim = -1
tlim = {tlim}
ndiag = 200

<shearing_box>
qshear = 1.5
omega0 = 1.0

<mhd>
eos = isothermal
reconstruct = plm
rsolver = hlle
iso_sound_speed = 1.0

<problem>
pgen_name = mri3d
beta = 200
amp = 0.01
ifield = 2
nwx = 1

<output1>
file_type = hst
dt = 0.5
data_format = %12.5e
user_hist_only = true
"""


def test_mri3d_smr_builds_rings():
    """Per-level sheared ring tables pair same-level columns only."""
    pin = ParameterInput.from_string(DECK.format(tlim=1.0))
    mesh, phys, pgen, driver, state = build(pin)
    assert mesh.multilevel
    sbox = phys.psbox
    assert sbox is not None and sbox.oa_active
    levels = {lv for lv, _, _ in sbox.ring["m"]}
    assert levels == {0, 1}, levels
    for side in ("m", "p"):
        for lv, ring, lmask in sbox.ring[side]:
            for g in np.where(lmask)[0]:
                assert (sbox.mb_lev[ring[g]] == lv).all(), \
                    "ring row mixes levels"


@pytest.mark.slow
def test_mri3d_smr_growth(tmp_path):
    """Refined HGB box: MRI grows, Maxwell stress positive, no blow-up
    (same physical checks as the uniform tests/test_mri3d.py)."""
    pin = ParameterInput.from_string(DECK.format(tlim=5.0))
    pin.modify_from_cmdline([f"job/basename={tmp_path}/HGBR"])
    mesh, phys, driver, state = run(pin)
    assert np.isfinite(np.asarray(state["u"])).all()

    hst = read_hst(f"{tmp_path}/HGBR.user.hst")
    t = np.asarray(hst["time"])
    me1 = np.asarray(hst["1-ME"])
    me3 = np.asarray(hst["3-ME"])
    dbxby = np.asarray(hst["dBxBy"])
    # radial field energy grows from the organizing MRI mode
    tmin = me1[(t > 2.5) & (t < 3.5)].min()
    late = me1[t > 4.8].max()
    assert late > 1.5 * tmin, (tmin, late)
    assert np.isfinite(me1).all() and me3.max() < 1.0
    # Maxwell stress -BxBy positive once the mode develops
    assert (dbxby[t > 1.5] > 0.0).all()


def test_sbox_smr_rejects_mixed_level_rows():
    """A refinement region NOT spanning the full x extent must refuse
    (ring pairing would cross levels)."""
    bad = DECK.format(tlim=1.0).replace(
        "x1min = -0.5\nx1max = 0.5\nx2min = -1.0",
        "x1min = 0.0\nx1max = 0.5\nx2min = -1.0")
    pin = ParameterInput.from_string(bad)
    with pytest.raises(NotImplementedError):
        build(pin)
