"""Vis tooling: bin -> athdf/xdmf conversion round-trip and quick-look
plots (reference: vis/python/bin_convert.py write_athdf/write_xdmf_for,
plot_slice.py, plot_hst.py)."""

import glob
import os

import numpy as np

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import run

DECK = """
<job>
basename = Vis

<mesh>
nghost = 2
nx1 = 32
x1min = -0.5
x1max = 0.5
nx2 = 16
x2min = -0.25
x2max = 0.25
nx3 = 16
x3min = -0.25
x3max = 0.25

<meshblock>
nx1 = 16
nx2 = 16
nx3 = 16

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
nlim = 4
tlim = 1.0

<mhd>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hlld

<problem>
pgen_name = blast
inner_radius = 0.08
outer_radius = 0.15
prat = 10.0
b_amb = 0.2

<output1>
file_type = bin
variable = mhd_w_bcc
dt = 100.0

<output2>
file_type = hst
dt = 0.0001
"""


def _run(tmp_path):
    pin = ParameterInput.from_string(DECK)
    pin.modify_from_cmdline([f"job/basename={tmp_path}/Vis"])
    return run(pin)


def test_bin_to_athdf_roundtrip(tmp_path):
    import h5py

    from athenak_jax.vis.convert import convert
    from athenak_jax.vis.readers import read_binary

    _run(tmp_path)
    binfile = sorted(glob.glob(f"{tmp_path}/Vis.mhd_w_bcc.*.bin"))[0]
    athdf = convert(binfile)
    assert os.path.exists(athdf) and os.path.exists(athdf + ".xdmf")

    f = read_binary(binfile)
    with h5py.File(athdf, "r") as h:
        assert h.attrs["NumMeshBlocks"] == f["n_mbs"]
        assert abs(h.attrs["Time"] - f["time"]) < 1e-12
        names = [n.decode() for n in h.attrs["VariableNames"]]
        assert names[:5] == ["dens", "velx", "vely", "velz", "eint"]
        assert "bcc1" in names
        uov = np.asarray(h["uov"])
        np.testing.assert_allclose(
            uov[0], f["mb_data"]["dens"], rtol=1e-6)
        B = np.asarray(h["B"])
        np.testing.assert_allclose(
            B[0], f["mb_data"]["bcc1"], rtol=1e-6)
        x1f = np.asarray(h["x1f"])
        assert x1f.shape == (f["n_mbs"], 17)
        # block face coordinates span the block extents exactly
        np.testing.assert_allclose(x1f[:, 0], f["mb_geometry"][:, 0])
        np.testing.assert_allclose(x1f[:, -1], f["mb_geometry"][:, 1])
    with open(athdf + ".xdmf") as fp:
        x = fp.read()
    assert "MeshBlock0" in x and ":/uov" in x and ":/B" in x


def test_plot_slice_and_hst(tmp_path):
    from athenak_jax.vis.plot import plot_hst, plot_slice

    _run(tmp_path)
    binfile = sorted(glob.glob(f"{tmp_path}/Vis.mhd_w_bcc.*.bin"))[0]
    png = plot_slice(binfile, "dens", f"{tmp_path}/slice.png",
                     dim="x3", coord=0.0)
    assert os.path.getsize(png) > 5000
    png2 = plot_slice(binfile, "bcc1", f"{tmp_path}/slice2.png",
                      dim="x1", coord=0.1)
    assert os.path.getsize(png2) > 5000
    hst = plot_hst(f"{tmp_path}/Vis.hst", "tot-E",
                   f"{tmp_path}/hst.png")
    assert os.path.getsize(hst) > 5000
