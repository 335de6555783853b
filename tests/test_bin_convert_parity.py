"""Binary-output parity: the REFERENCE's own reader
(vis/python/bin_convert.py) must read our .bin dumps unmodified
(reference: src/outputs/binary.cpp writer format).
"""

import shutil
import sys

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import run

REF_VIS = "/root/reference/vis/python"

DECK = """
<job>
basename = binpar

<mesh>
nghost = 2
nx1 = 16
x1min = -0.5
x1max = 0.5
nx2 = 16
x2min = -0.5
x2max = 0.5
nx3 = 8
x3min = -0.25
x3max = 0.25

<meshblock>
nx1 = 8
nx2 = 8
nx3 = 8

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
nlim = 4
tlim = 1.0

<mhd>
eos = ideal
reconstruct = plm
rsolver = hlld
gamma = 1.6666666666666667

<problem>
pgen_name = blast
prat = 10.0
drat = 2.0
inner_radius = 0.02
outer_radius = 0.1
pi_amb = 1.0
di_amb = 1.0
b_amb = 0.1

<output1>
file_type = bin
variable = mhd_w_bcc
dt = 100.0

<output2>
file_type = cbin
variable = mhd_w_bcc
coarsen_factor = 2
dt = 100.0

<output3>
file_type = pdf
variable = mhd_w_bcc
bin_min = 0.1
bin_max = 30.0
nbin = 16
dt = 100.0

<output4>
file_type = cartgrid
variable = mhd_w_bcc
center_x = 0.0
center_y = 0.0
center_z = 0.0
extent_x = 0.25
extent_y = 0.25
extent_z = 0.125
numpoints_x = 8
numpoints_y = 8
numpoints_z = 4
dt = 100.0

<output5>
file_type = sphsurf
variable = mhd_w_bcc
radius = 0.2
ntheta = 8
dt = 100.0
"""


@pytest.mark.skipif(not shutil.os.path.isdir(REF_VIS),
                    reason="reference vis tools not available")
def test_reference_bin_convert_reads_our_output(tmp_path):
    pin = ParameterInput.from_string(DECK)
    pin.modify_from_cmdline([f"job/basename={tmp_path}/binpar"])
    mesh, phys, driver, state = run(pin)

    sys.path.insert(0, REF_VIS)
    try:
        import bin_convert
        fname = f"{tmp_path}/binpar.mhd_w_bcc.00001.bin"
        data = bin_convert.read_binary(fname)
    finally:
        sys.path.remove(REF_VIS)

    # structure
    assert data["n_mbs"] == mesh.nmb_total
    assert set(["dens", "velx", "vely", "velz", "eint",
                "bcc1", "bcc2", "bcc3"]).issubset(data["var_names"])
    assert abs(data["time"] - mesh.time) < 1e-12
    assert data["cycle"] == mesh.ncycle

    # values: reassemble block 0's density and compare with the state
    mbi = mesh.mb_indcs
    w = np.asarray(state["w"], dtype=np.float64)
    dens_idx = data["var_names"].index("dens")
    blk = np.asarray(data["mb_data"][data["var_names"][dens_idx]][0])
    ours = w[0, 0, mbi.ks:mbi.ke + 1, mbi.js:mbi.je + 1,
             mbi.is_:mbi.ie + 1]
    assert blk.shape == ours.shape
    assert np.allclose(blk, ours, rtol=0, atol=0), \
        "bit-exact payload mismatch"

    # geometry metadata per block
    for gid in range(mesh.nmb_total):
        geo = data["mb_geometry"][gid]
        assert abs(geo[0] - mesh.mb_size["x1min"][gid]) < 1e-12
        assert abs(geo[1] - mesh.mb_size["x1max"][gid]) < 1e-12

    # --- cbin: the reference's read_coarsened_binary reads our file and
    # the payload equals a 2x2x2 mean-pool of the bin payload ---
    sys.path.insert(0, REF_VIS)
    try:
        import bin_convert
        cfile = (f"{tmp_path}/cbin_mhd_w_bcc_2/"
                 f"binpar.mhd_w_bcc.00001.cbin")
        cdata = bin_convert.read_coarsened_binary(cfile)
    finally:
        sys.path.remove(REF_VIS)
    assert cdata["n_mbs"] == mesh.nmb_total
    assert cdata["number_of_moments"] == 1
    assert cdata["nx1_mb"] == mbi.nx1 // 2
    cblk = np.asarray(cdata["mb_data"]["dens"][0])
    pooled = ours.reshape(mbi.nx3 // 2, 2, mbi.nx2 // 2, 2,
                          mbi.nx1 // 2, 2).mean(axis=(1, 3, 5))
    assert cblk.shape == pooled.shape
    assert np.allclose(cblk, pooled, rtol=1e-6, atol=1e-7)

    # --- pdf: bins + table exist, total weight = domain volume ---
    pdir = f"{tmp_path}/pdf_mhd_w_bcc"
    tab = np.loadtxt(f"{pdir}/binpar.00001.pdf")
    assert tab.shape == (18,)  # nbin + 2 outlier bins
    vol = ((mesh.mesh_size.x1max - mesh.mesh_size.x1min)
           * (mesh.mesh_size.x2max - mesh.mesh_size.x2min)
           * (mesh.mesh_size.x3max - mesh.mesh_size.x3min))
    assert abs(tab.sum() - vol) < 1e-4 * vol  # %12.5e text precision
    edges = np.loadtxt(f"{pdir}/binpar.bins.pdf")
    assert edges.shape == (17,)

    # --- cartgrid: packed metadata + float32 grid round-trips ---
    import struct
    with open(f"{tmp_path}/cart/binpar.mhd_w_bcc.00001.bin", "rb") as f:
        md = struct.unpack("=if3f3f3i?3xi", f.read(52))
        assert md[0] == mesh.ncycle
        assert md[8:11] == (8, 8, 4)
        nlab = struct.unpack("=i", f.read(4))[0]
        labs = f.read(nlab).decode().split()
        assert labs[0] == "dens"
        grid = np.frombuffer(f.read(), dtype=np.float32).reshape(
            md[12], 4, 8, 8)
        assert np.isfinite(grid).all() and grid[0].min() > 0.0

    # --- sphsurf: vtk file with weights summing to 4 pi r^2 ---
    sfile = f"{tmp_path}/sph/binpar.r=0.20.mhd_w_bcc.00001.vtk"
    raw = open(sfile, "rb").read()
    assert b"DATASET STRUCTURED_GRID" in raw
    assert b"SCALARS weights float 1" in raw
    off = raw.index(b"LOOKUP_TABLE default\n") + len(
        b"LOOKUP_TABLE default\n")
    nang = 2 * 8 * 8
    wts = np.frombuffer(raw[off:off + 4 * nang], dtype=">f4")
    assert abs(wts.sum() - 4 * np.pi * 0.2 ** 2) < 1e-5
