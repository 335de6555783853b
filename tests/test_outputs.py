"""Outputs: bin format read back by the REFERENCE reader, restart/resume
bit-exactness, hst readers.

(reference: src/outputs/binary.cpp, restart.cpp; vis/python/bin_convert.py)
"""

import os
import sys

import numpy as np
import pytest

from athenak_jax.athinput import ParameterInput
from athenak_jax.main import run, run_restart
from athenak_jax.vis.readers import read_binary, read_hst

DECK = """
<job>
basename = outtest

<mesh>
nghost = 2
nx1 = 32
x1min = -0.5
x1max = 0.5
nx2 = 16
x2min = -0.5
x2max = 0.5
nx3 = 1
x3min = -0.5
x3max = 0.5

<meshblock>
nx1 = 16
nx2 = 16

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.4
tlim = 0.2

<mhd>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hlld

<problem>
pgen_name = orszag_tang

<output1>
file_type = bin
variable = mhd_w_bcc
dt = 0.1

<output2>
file_type = hst
dt = 0.05

<output3>
file_type = rst
dt = 0.1
"""


def _run_in(tmp_path, deck):
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        pin = ParameterInput.from_string(deck)
        return run(pin)
    finally:
        os.chdir(cwd)


def test_unknown_file_type_is_fatal():
    """A deck typo like file_type = binn must refuse to run, matching
    the reference output factory (reference: outputs.cpp:224-260)."""
    from athenak_jax.main import build
    from athenak_jax.outputs import make_outputs
    pin = ParameterInput.from_string(
        DECK.replace("file_type = bin\n", "file_type = binn\n"))
    mesh, phys, pgen, driver, state = build(pin)
    with pytest.raises(ValueError, match="binn"):
        make_outputs(pin, mesh, phys)


def test_bin_output_reference_reader(tmp_path):
    mesh, phys, driver, state = _run_in(tmp_path, DECK)
    files = sorted(tmp_path.glob("outtest.mhd_w_bcc.*.bin"))
    assert len(files) >= 2

    # our reader
    d = read_binary(str(files[-1]))
    assert d["var_names"] == ["dens", "velx", "vely", "velz", "eint",
                              "bcc1", "bcc2", "bcc3"]
    assert d["n_mbs"] == mesh.nmb_total
    assert np.isclose(d["time"], mesh.time)
    # data round-trips: compare dens of block 0 against the state
    mbi = mesh.mb_indcs
    dens_state = np.asarray(state["w"])[0, 0, mbi.ks:mbi.ke + 1,
                                        mbi.js:mbi.je + 1,
                                        mbi.is_:mbi.ie + 1]
    np.testing.assert_allclose(d["mb_data"]["dens"][0], dens_state,
                               rtol=1e-12)

    # THE REFERENCE READER parses our file unchanged
    ref_vis = "/root/reference/vis/python"
    if not os.path.isdir(ref_vis):
        pytest.skip("reference vis tools not available")
    sys.path.insert(0, ref_vis)
    try:
        import bin_convert
        rd = bin_convert.read_binary(str(files[-1]))
    finally:
        sys.path.remove(ref_vis)
    assert rd["n_mbs"] == mesh.nmb_total
    np.testing.assert_allclose(rd["mb_data"]["dens"][0], dens_state,
                               rtol=1e-12)
    np.testing.assert_allclose(rd["mb_geometry"], d["mb_geometry"])


def test_restart_resume_bit_exact(tmp_path):
    # uninterrupted run to t=0.2
    d1 = tmp_path / "full"
    d1.mkdir()
    mesh1, phys1, drv1, st1 = _run_in(d1, DECK)

    # interrupted by cycle limit (same dt sequence, no tlim clamp at the
    # interruption point) then resumed
    ncyc_half = mesh1.ncycle // 2
    d2 = tmp_path / "half"
    d2.mkdir()
    half_deck = DECK.replace("file_type = rst\ndt = 0.1",
                             f"file_type = rst\ndcycle = {ncyc_half}") \
        + f"\nnlim = {ncyc_half}\n"
    # the nlim must go in the <time> block: append properly
    half_deck = DECK.replace(
        "file_type = rst\ndt = 0.1",
        f"file_type = rst\ndcycle = {ncyc_half}")
    pin = None
    cwd = os.getcwd()
    os.chdir(d2)
    try:
        pin = ParameterInput.from_string(half_deck)
        pin.set_value("time", "nlim", ncyc_half)
        run(pin)
        rst = sorted(d2.glob("outtest.*.rst"))[-1]
        mesh2, phys2, drv2, st2 = run_restart(
            str(rst), overrides=["time/nlim=-1"])
    finally:
        os.chdir(cwd)

    assert np.isclose(mesh1.time, mesh2.time)
    np.testing.assert_allclose(np.asarray(st2["u"]), np.asarray(st1["u"]),
                               rtol=1e-13, atol=1e-15)
    for c in ("x1f", "x2f", "x3f"):
        np.testing.assert_allclose(np.asarray(st2["bfc"][c]),
                                   np.asarray(st1["bfc"][c]),
                                   rtol=1e-13, atol=1e-15)


def test_hst_reader(tmp_path):
    _run_in(tmp_path, DECK)
    h = read_hst(str(tmp_path / "outtest.hst"))
    assert "time" in h and "mass" in h
    assert len(h["time"]) >= 3
    # mass conservation in the periodic box
    np.testing.assert_allclose(h["mass"], h["mass"][0], rtol=1e-10)


def test_vtk_output_roundtrip(tmp_path):
    """VTK dumps agree with the bin dumps of the same cycle and carry a
    correct STRUCTURED_POINTS header (reference: vtk_mesh.cpp:93-137)."""
    deck = DECK.replace(
        "<output3>\nfile_type = rst\ndt = 0.1",
        "<output3>\nfile_type = vtk\nvariable = mhd_w_bcc\ndt = 0.1")
    mesh, phys, driver, state = _run_in(tmp_path, deck)
    from athenak_jax.vis.readers import read_vtk
    vfiles = sorted(tmp_path.glob("outtest.mhd_w_bcc.*.vtk"))
    bfiles = sorted(tmp_path.glob("outtest.mhd_w_bcc.*.bin"))
    assert len(vfiles) >= 2
    meta, data = read_vtk(str(vfiles[-1]))
    assert meta["origin"] == [-0.5, -0.5, -0.5]
    assert np.isclose(meta["spacing"][0], 1.0 / 32)
    assert set(data) == {"dens", "velx", "vely", "velz", "eint",
                         "bcc1", "bcc2", "bcc3"}
    assert data["dens"].shape == (1, 16, 32)
    # same payload as the bin dump, to f32 precision
    b = read_binary(str(bfiles[-1]))
    for v in data:
        gb = np.zeros_like(data[v])
        for mb, loc in zip(b["mb_data"][v], b["mb_logical"]):
            l1, l2 = loc[0], loc[1]
            gb[:, l2 * 16:(l2 + 1) * 16, l1 * 16:(l1 + 1) * 16] = mb
        assert np.allclose(data[v], gb, rtol=1e-6, atol=1e-6), v
