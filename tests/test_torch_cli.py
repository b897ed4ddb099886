"""The port's command line, ``python -m tpgsd_torch``, against the JAX
package's, ``python -m tpgsd``.

Every case of ``tests/test_cli.py`` runs again on the port's CLI, on a
file that the port wrote.  Then both CLIs run ``info``, ``dump`` and
``verify`` (on the intact file and on a copy truncated inside its last
frame's data) on a file written by each package, and must give the same
standard output, line for line, and the same exit code; the port's runs
happen with ``torch``, ``jax`` and ``tpgsd`` blocked in ``sys.modules``,
since the CLI reads files with numpy alone.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import numpy
import pytest

import tpgsd.hoomd
import tpgsd_torch
import tpgsd_torch.fl
import tpgsd_torch.hoomd

REPO = pathlib.Path(__file__).resolve().parent.parent
ENV = dict(os.environ, PYTHONPATH=str(REPO))


def _write(hoomd, path, frames=1):
    """The sample trajectory of ``tests/test_cli.py`` through ``hoomd``,
    with ``frames`` frames (positions and density moved by the frame)."""
    with hoomd.open(path, mode="w") as traj:
        for k in range(frames):
            frame = hoomd.Frame()
            frame.configuration.step = 10 * k
            frame.particles.N = 4
            frame.particles.position = (
                numpy.arange(12, dtype=numpy.float32).reshape(4, 3) + k)
            frame.particles.density = (
                numpy.array([1.0, 2.0, 3.0, 4.0], numpy.float32) + k)
            traj.append(frame)
    return path


@pytest.fixture
def sample_file(tmp_path):
    return _write(tpgsd_torch.hoomd, tmp_path / "cli_sample.gsd")


def _run(args, package="tpgsd_torch", **kw):
    return subprocess.run(
        [sys.executable, "-m", package] + args,
        capture_output=True,
        text=True,
        timeout=120,
        cwd=str(REPO),
        env=ENV,
        **kw,
    )


def test_version():
    result = _run(["--version"])
    assert result.returncode == 0
    assert result.stdout.startswith("tpgsd_torch ")
    ref = _run(["--version"], package="tpgsd")
    assert ref.returncode == 0
    assert result.stdout == ref.stdout.replace("tpgsd ", "tpgsd_torch ", 1)


def test_no_subcommand_prints_usage():
    result = _run([])
    assert result.returncode == 2
    ref = _run([], package="tpgsd")
    assert ref.returncode == 2
    # the longer name moves argparse's line break, not a word
    assert result.stdout.split() == (
        ref.stdout.replace("tpgsd", "tpgsd_torch").split())


def test_info(sample_file):
    result = _run(["info", str(sample_file)])
    assert result.returncode == 0
    assert "schema: hoomd" in result.stdout
    assert "frames: 1" in result.stdout
    assert "particles/position" in result.stdout
    assert "[4 x 3] float32" in result.stdout


def test_dump(sample_file):
    result = _run(["dump", str(sample_file), "-n", "particles/density", "-f", "0"])
    assert result.returncode == 0
    assert "1." in result.stdout and "4." in result.stdout


def test_dump_missing_chunk_errors(sample_file):
    result = _run(["dump", str(sample_file), "-n", "no/such"])
    assert result.returncode == 1
    assert "Error" in result.stderr


def test_read_repl_hoomd(sample_file):
    result = _run(
        ["read", str(sample_file)],
        input="print('NFRAMES', len(traj), handle.schema, "
        "tpgsd_torch.__name__)\n",
    )
    assert result.returncode == 0
    assert "NFRAMES 1 hoomd tpgsd_torch" in result.stdout
    # code.interact writes the banner to stderr
    assert "Number of frames: 1" in result.stderr
    assert "tpgsd_torch %s" % tpgsd_torch.version in result.stderr


def test_read_repl_schema_none(sample_file):
    result = _run(
        ["read", str(sample_file), "-s", "none"],
        input="print('NN', handle.nnames)\n",
    )
    assert result.returncode == 0
    assert "NN" in result.stdout


def test_read_missing_file_errors(tmp_path):
    result = _run(["read", str(tmp_path / "nope.gsd")])
    assert result.returncode == 1
    assert "Error" in result.stderr


def test_convert_subcommand(sample_file, tmp_path):
    outdir = tmp_path / "vtu_out"
    result = _run(
        ["convert", str(sample_file), "-o", str(outdir), "--fields", "density"]
    )
    assert result.returncode == 0, result.stderr
    assert "Frame 1: N=4" in result.stdout
    vtu = outdir / "cli_sample_00001.vtu"
    assert vtu.exists()
    assert 'NumberOfPoints="4"' in vtu.read_text()


def test_package_version_matches_pyproject():
    """tpgsd_torch.version is the application string written into every
    file header; a desync with pyproject silently mislabels
    trajectories.  The port's console script names its ``main``."""
    text = (REPO / "pyproject.toml").read_text()
    m = re.search(r'^version = "([^"]+)"', text, re.M)
    assert m and m.group(1) == tpgsd_torch.version
    assert re.search(r'^tpgsd-torch = "tpgsd_torch.__main__:main"$', text,
                     re.M)


#: Runs one package's CLI over a list of argument lists the way
#: ``python -m`` does (``runpy.run_module`` with ``alter_sys``), one
#: subprocess for them all; prints ``[[exit code, stdout], ...]`` as
#: JSON.  argv: package, "block" or "", the JSON list of argument lists.
_CLI_LOOP = r"""
import contextlib, io, json, runpy, sys

package, block, runs = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
if block:
    for name in ("torch", "jax", "tpgsd"):
        sys.modules[name] = None
results = []
for args in runs:
    sys.argv = [package] + args
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out):
        try:
            runpy.run_module(package, run_name="__main__", alter_sys=True)
        except SystemExit as e:
            code = e.code
    results.append([code, out.getvalue()])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("torch", "jax", "tpgsd") and sys.modules[m] is not None)
print(json.dumps({"results": results, "loaded": loaded}))
"""


def _drive(package, runs, block=False):
    proc = subprocess.run(
        [sys.executable, "-c", _CLI_LOOP, package, "block" if block else "",
         json.dumps(runs)],
        capture_output=True, text=True, timeout=120, cwd=str(REPO), env=ENV,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.splitlines()[-1])


def _truncated_copy(path, out):
    """``out``: ``path`` cut in the middle of its last frame's position
    data."""
    with tpgsd_torch.fl.open(path, "r") as f:
        chunk = f._find_chunk(f.nframes - 1, "particles/position")
        cut = int(chunk["location"]) + 4 * 3 * int(chunk["N"]) // 2
    data = pathlib.Path(path).read_bytes()
    assert cut < len(data)
    pathlib.Path(out).write_bytes(data[:cut])
    return out


def test_port_cli_matches_the_reference_line_for_line(tmp_path):
    runs = []
    for writer, hoomd in (("tpgsd", tpgsd.hoomd), ("tpgsd_torch",
                                                   tpgsd_torch.hoomd)):
        path = _write(hoomd, str(tmp_path / ("%s.gsd" % writer)), frames=2)
        cut = _truncated_copy(path, str(tmp_path / ("%s_cut.gsd" % writer)))
        runs += [
            ["info", path],
            ["dump", path, "-n", "particles/density", "-f", "1"],
            ["dump", path, "-n", "particles/position", "-f", "0"],
            ["verify", path],
            ["verify", path, "--shallow"],
            ["verify", cut],
        ]
    ref = _drive("tpgsd", runs)
    port = _drive("tpgsd_torch", runs, block=True)
    assert port["loaded"] == []
    for args, (ref_code, ref_out), (code, out) in zip(
            runs, ref["results"], port["results"]):
        assert (code, out.splitlines()) == (ref_code, ref_out.splitlines()), (
            args)
    codes = [code for code, _ in port["results"]]
    assert codes == [0, 0, 0, 0, 0, 1] * 2
    for k in (3, 4, 9, 10):
        assert port["results"][k][1].splitlines()[-1] == "OK"
    for k in (5, 11):
        assert port["results"][k][1].splitlines()[-1].startswith("CORRUPT (")
    assert "frames: 2" in port["results"][0][1]
    assert "[4 x 3] float32" in port["results"][6][1]
