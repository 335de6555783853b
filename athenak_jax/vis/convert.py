"""bin -> athdf (+ xdmf) conversion.

Parity target: reference vis/python/bin_convert.py write_athdf /
write_xdmf_for — produces Athena++-style .athdf HDF5 files (uov/B
datasets, Levels, LogicalLocations, per-block face/center coordinates,
the standard attribute set) plus the paired .athdf.xdmf so ParaView /
VisIt / yt can open the output directly.

CLI:  python -m athenak_jax.vis.convert file1.bin [file2.bin ...]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .readers import read_binary


def _from_header(header, block, key):
    cur = None
    for ln in header:
        if ln.startswith("<"):
            cur = ln.strip("<>")
            continue
        k, v = ln.split("=", 1)
        if cur == block and k.strip() == key:
            return v.strip()
    raise KeyError(f"{block}/{key}")


def write_athdf(filename: str, fdata, varsize_bytes: int = 4,
                locsize_bytes: int = 8) -> None:
    """Write an .athdf file from a read_binary(...) dict (format spec:
    reference bin_convert.py:write_athdf)."""
    import h5py

    locfmt = "<f4" if locsize_bytes == 4 else "<f8"
    varfmt = "<f4" if varsize_bytes == 4 else "<f8"

    nmb = fdata["n_mbs"]
    header = fdata["header"]
    idx = fdata["mb_index"]
    nx1 = int(idx[0][1] - idx[0][0]) + 1
    nx2 = int(idx[0][3] - idx[0][2]) + 1
    nx3 = int(idx[0][5] - idx[0][4]) + 1

    vars_no_b = [v for v in fdata["var_names"] if "bcc" not in v]
    vars_b = [v for v in fdata["var_names"] if v not in vars_no_b]

    levels = fdata["mb_logical"][:, 3].astype(np.int64)
    loglocs = fdata["mb_logical"][:, :3].astype(np.int64)
    uov = np.stack([fdata["mb_data"][v] for v in vars_no_b])
    B = np.stack([fdata["mb_data"][v] for v in vars_b]) if vars_b else None

    x1f = np.zeros((nmb, nx1 + 1))
    x2f = np.zeros((nmb, nx2 + 1))
    x3f = np.zeros((nmb, nx3 + 1))
    for mb in range(nmb):
        g = fdata["mb_geometry"][mb]
        x1f[mb] = np.linspace(g[0], g[1], nx1 + 1)
        x2f[mb] = np.linspace(g[2], g[3], nx2 + 1)
        x3f[mb] = np.linspace(g[4], g[5], nx3 + 1)

    names = [np.array("uov", dtype="|S21")]
    nvars = [len(vars_no_b)]
    if vars_b:
        names.append(np.array("B", dtype="|S21"))
        nvars.append(len(vars_b))

    with h5py.File(filename, "w") as hfp:
        hfp.attrs["Header"] = header
        hfp.attrs["Time"] = fdata["time"]
        hfp.attrs["NumCycles"] = fdata["cycle"]
        hfp.attrs["Coordinates"] = np.array("cartesian", dtype="|S11")
        hfp.attrs["NumMeshBlocks"] = nmb
        hfp.attrs["MaxLevel"] = int(levels.max())
        hfp.attrs["MeshBlockSize"] = [nx1, nx2, nx3]
        hfp.attrs["RootGridSize"] = [fdata["Nx1"], fdata["Nx2"],
                                     fdata["Nx3"]]
        for d in ("x1", "x2", "x3"):
            hfp.attrs[f"RootGrid{d.upper()[0]}{d[1]}"] = [
                float(_from_header(header, "mesh", f"{d}min")),
                float(_from_header(header, "mesh", f"{d}max")), 1.0]
        hfp.attrs["DatasetNames"] = names
        hfp.attrs["NumVariables"] = nvars
        hfp.attrs["VariableNames"] = [
            np.array(v, dtype="|S21") for v in (vars_no_b + vars_b)]

        if B is not None:
            hfp.create_dataset("B", data=B, dtype=varfmt)
        hfp.create_dataset("Levels", data=levels, dtype=">i4")
        hfp.create_dataset("LogicalLocations", data=loglocs, dtype=">i8")
        hfp.create_dataset("uov", data=uov, dtype=varfmt)
        hfp.create_dataset("x1f", data=x1f, dtype=locfmt)
        hfp.create_dataset("x1v",
                           data=0.5 * (x1f[:, 1:] + x1f[:, :-1]),
                           dtype=locfmt)
        hfp.create_dataset("x2f", data=x2f, dtype=locfmt)
        hfp.create_dataset("x2v",
                           data=0.5 * (x2f[:, 1:] + x2f[:, :-1]),
                           dtype=locfmt)
        hfp.create_dataset("x3f", data=x3f, dtype=locfmt)
        hfp.create_dataset("x3v",
                           data=0.5 * (x3f[:, 1:] + x3f[:, :-1]),
                           dtype=locfmt)


def write_xdmf_for(xdmfname: str, dumpname: str, fdata) -> None:
    """Paired xdmf pointing hyperslabs into the athdf datasets
    (format spec: reference bin_convert.py:write_xdmf_for)."""
    nmb = fdata["n_mbs"]
    idx = fdata["mb_index"]
    nx1 = int(idx[0][1] - idx[0][0]) + 1
    nx2 = int(idx[0][3] - idx[0][2]) + 1
    nx3 = int(idx[0][5] - idx[0][4]) + 1
    vars_no_b = [v for v in fdata["var_names"] if "bcc" not in v]
    vars_b = [v for v in fdata["var_names"] if v not in vars_no_b]

    with open(xdmfname, "w") as fp:
        fp.write('<?xml version="1.0" ?>\n'
                 '<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>\n'
                 '<Xdmf Version="2.0">\n'
                 '<Information Name="TimeVaryingMetaData" Value="True"/>\n'
                 '<Domain>\n<Grid Name="Mesh" GridType="Collection">\n'
                 f' <Time Value="{fdata["time"]}"/>\n')
        for mb in range(nmb):
            fp.write(f'  <Grid Name="MeshBlock{mb}" GridType="Uniform">\n'
                     '   <Topology TopologyType="3DRectMesh"  '
                     f'NumberOfElements="{nx3+1} {nx2+1} {nx1+1}"/>\n'
                     '   <Geometry GeometryType="VXVYVZ">\n')
            for d, nx in (("x1f", nx1), ("x2f", nx2), ("x3f", nx3)):
                fp.write(
                    f'    <DataItem ItemType="HyperSlab" '
                    f'Dimensions="{nx+1}">\n'
                    f'     <DataItem Dimensions="3 2" NumberType="Int">'
                    f' {mb} 0 1 1 1 {nx+1} </DataItem>\n'
                    f'     <DataItem Dimensions="{nmb} {nx+1}"'
                    f' Format="HDF"> {dumpname}:/{d} </DataItem>\n'
                    '    </DataItem>\n')
            fp.write('   </Geometry>\n')
            for ds, vlist in (("uov", vars_no_b), ("B", vars_b)):
                for vi, var in enumerate(vlist):
                    fp.write(
                        f'   <Attribute Name="{var}" Center="Cell">\n'
                        f'    <DataItem ItemType="HyperSlab" '
                        f'Dimensions="{nx3} {nx2} {nx1}">\n'
                        '     <DataItem Dimensions="3 5" '
                        'NumberType="Int">\n'
                        f'      {vi} {mb} 0 0 0 1 1 1 1 1 1 1 '
                        f'{nx3} {nx2} {nx1}\n'
                        '     </DataItem>\n'
                        f'     <DataItem Dimensions="{len(vlist)} {nmb} '
                        f'{nx3} {nx2} {nx1}" Format="HDF">\n'
                        f'      {dumpname}:/{ds}\n'
                        '     </DataItem>\n'
                        '    </DataItem>\n'
                        '   </Attribute>\n')
            fp.write('  </Grid>\n')
        fp.write(' </Grid>\n</Domain>\n</Xdmf>\n')


def convert(binname: str) -> str:
    """bin -> .athdf + .athdf.xdmf next to the input file."""
    fdata = read_binary(binname)
    athdf = binname[:-4] + ".athdf" if binname.endswith(".bin") \
        else binname + ".athdf"
    write_athdf(athdf, fdata)
    write_xdmf_for(athdf + ".xdmf", os.path.basename(athdf), fdata)
    return athdf


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not args:
        print("usage: python -m athenak_jax.vis.convert file.bin [...]")
        return 1
    for f in args:
        print(convert(f))
    return 0


if __name__ == "__main__":
    sys.exit(main())
