"""VTK .vtu export of hoomd-schema trajectories (the port's copy of
``tpgsd.vtu``, reading through :mod:`tpgsd_torch.hoomd`).

Capability parity with the reference converter (reference:
test_pgsd2vtu.py and pgsd/doc/pgsd.tex:1226-1265): every frame becomes a
point cloud with density / pressure / slength / velocity point data.
Unlike the reference this needs no pyevtk - the VTU XML (UnstructuredGrid
of VTK_VERTEX cells) is emitted directly, inline-binary base64 by default
or ascii with ``--ascii``.

Usage:
    python -m tpgsd_torch.vtu trajectory.gsd [-o OUTDIR] [--ascii]
                              [--fields density,pressure,...] [--frames 0:10]
"""

import argparse
import base64
import os
import sys

import numpy

_VTK_TYPES = {
    numpy.dtype("float32"): "Float32",
    numpy.dtype("float64"): "Float64",
    numpy.dtype("int32"): "Int32",
    numpy.dtype("int64"): "Int64",
    numpy.dtype("uint8"): "UInt8",
    numpy.dtype("uint32"): "UInt32",
    numpy.dtype("uint64"): "UInt64",
}


def _data_array(out, name, array, fmt):
    """Write one <DataArray> element (inline binary or ascii)."""
    array = numpy.ascontiguousarray(array)
    ncomp = array.shape[1] if array.ndim == 2 else 1
    vtype = _VTK_TYPES[array.dtype]
    out.write(
        '        <DataArray type="%s" Name="%s" NumberOfComponents="%d" format="%s">\n'
        % (vtype, name, ncomp, fmt)
    )
    if fmt == "ascii":
        flat = array.reshape(-1)
        for i in range(0, flat.size, 9):
            out.write("          " + " ".join(map(str, flat[i : i + 9])) + "\n")
    else:
        # inline base64: UInt64 byte-count header + raw little-endian data,
        # encoded as one base64 block (header_type="UInt64" declared on the
        # VTKFile element)
        raw = array.tobytes()
        blob = numpy.uint64(len(raw)).tobytes() + raw
        out.write("          " + base64.b64encode(blob).decode("ascii") + "\n")
    out.write("        </DataArray>\n")


def write_vtu(path, points, point_data, ascii_format=False):
    """Write a VTU point-cloud file: N points, N VTK_VERTEX cells.

    Args:
        path: output file path.
        points: ``[N, 3]`` float array of positions.
        point_data: dict name -> ``[N]`` or ``[N, C]`` array.
        ascii_format: emit ascii instead of inline-binary base64.
    """
    points = numpy.ascontiguousarray(points, dtype=numpy.float32)
    n = points.shape[0]
    fmt = "ascii" if ascii_format else "binary"

    with open(path, "w") as out:
        out.write('<?xml version="1.0"?>\n')
        out.write(
            '<VTKFile type="UnstructuredGrid" version="1.0" '
            'byte_order="LittleEndian" header_type="UInt64">\n'
        )
        out.write("  <UnstructuredGrid>\n")
        out.write(
            '    <Piece NumberOfPoints="%d" NumberOfCells="%d">\n' % (n, n)
        )

        out.write("      <Points>\n")
        _data_array(out, "Points", points.reshape(n, 3), fmt)
        out.write("      </Points>\n")

        out.write("      <Cells>\n")
        _data_array(
            out, "connectivity", numpy.arange(n, dtype=numpy.int64), fmt
        )
        _data_array(
            out, "offsets", numpy.arange(1, n + 1, dtype=numpy.int64), fmt
        )
        _data_array(
            out, "types", numpy.full(n, 1, dtype=numpy.uint8), fmt  # VTK_VERTEX
        )
        out.write("      </Cells>\n")

        out.write("      <PointData>\n")
        for name, data in point_data.items():
            _data_array(out, name, data, fmt)
        out.write("      </PointData>\n")

        out.write("    </Piece>\n")
        out.write("  </UnstructuredGrid>\n")
        out.write("</VTKFile>\n")


#: SPH fields exported by default (reference: pgsd/doc/pgsd.tex:1253-1258)
DEFAULT_FIELDS = ["density", "pressure", "slength", "velocity"]


def convert(
    traj_path, outdir=None, fields=None, frames=None, ascii_format=False, quiet=False
):
    """Convert ``traj_path`` to one .vtu per frame; returns written paths."""
    import tpgsd_torch.hoomd

    fields = fields or DEFAULT_FIELDS
    base = os.path.basename(traj_path)
    if base.endswith(".gsd"):
        base = base[:-4]
    outdir = outdir or os.path.dirname(os.path.abspath(traj_path))
    os.makedirs(outdir, exist_ok=True)

    written = []
    with tpgsd_torch.hoomd.open(traj_path, mode="r") as traj:
        indices = range(len(traj))
        if frames is not None:
            indices = range(*frames.indices(len(traj)))
        for count, idx in enumerate(indices, start=1):
            snapshot = traj[idx]
            point_data = {}
            for field in fields:
                value = getattr(snapshot.particles, field, None)
                if value is not None:
                    point_data[field] = numpy.asarray(value)
            pname = os.path.join(outdir, "%s_%05d.vtu" % (base, count))
            write_vtu(
                pname,
                snapshot.particles.position,
                point_data,
                ascii_format=ascii_format,
            )
            written.append(pname)
            if not quiet:
                print("Frame %d: N=%d -> %s" % (count, snapshot.particles.N, pname))
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert a hoomd-schema GSD trajectory to VTK .vtu files."
    )
    parser.add_argument("file", help="trajectory .gsd file")
    parser.add_argument("-o", "--outdir", default=None, help="output directory")
    parser.add_argument(
        "--fields",
        default=",".join(DEFAULT_FIELDS),
        help="comma-separated particle fields to export",
    )
    parser.add_argument(
        "--frames",
        default=None,
        help="frame slice start:stop[:step] (default: all)",
    )
    parser.add_argument(
        "--ascii", action="store_true", help="write ascii instead of binary"
    )
    args = parser.parse_args(argv)

    frames = None
    if args.frames:
        parts = [int(p) if p else None for p in args.frames.split(":")]
        frames = slice(*parts)

    convert(
        args.file,
        outdir=args.outdir,
        fields=[f for f in args.fields.split(",") if f],
        frames=frames,
        ascii_format=args.ascii,
    )


if __name__ == "__main__":
    sys.exit(main())
