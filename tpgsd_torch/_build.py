"""Build the port's CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` file for Hopper (``sm_90a``) into
one shared library with a plain C interface, in the ``build/`` directory
beside the package (listed in ``.gitignore``).  The library's file name
carries a hash of the sources and flags, so an edited source builds
anew and an unchanged one loads at once.  Nothing here runs at import:
the CPU-only tests import every module, and this machine may have no
compiler.  A failed build raises; there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None


def nvcc_path():
    """``$CUDA_HOME/bin/nvcc`` when ``CUDA_HOME`` is set, else ``nvcc``
    on ``PATH``, else the CUDA toolkit's default install prefix."""
    home = os.environ.get("CUDA_HOME")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path():
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("libtpgsd_torch_%s.so" % digest.hexdigest()[:16])


def build():
    """Compile the library unless it exists; returns its path.  The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills
    per kernel) is kept beside it as ``<library>.log``."""
    path = library_path()
    if path.exists():
        return path
    nvcc = nvcc_path()
    if not Path(nvcc).exists():
        raise RuntimeError(
            "cannot build the CUDA kernels: nvcc not found at %s (set "
            "CUDA_HOME to the CUDA toolkit)" % nvcc
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".so.%d.tmp" % os.getpid())
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            "nvcc failed (exit %d): %s\n%s"
            % (proc.returncode, " ".join(cmd), log)
        )
    path.with_suffix(".so.log").write_text(log)
    os.replace(tmp, path)
    return path


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    density_pairs = [
        p, p, p, p, p,  # xc, mc, xn, mn, out
        i, i, i, i, i, i,  # nx, ny, nz, k, tile, kind
        f, f, f, f, f, f,  # inv2h, invh2, mfold, h, sigma, supp2
        p,  # stream
    ]
    accel_pairs = [
        p, p, p, p, p,  # xc, vc, rhoc, ptc, mc
        p, p, p, p, p,  # xn, vn, rhon, ptn, mn
        p, i,  # out, n_out (1: du/dt; 3: acc; 4: acc, drho/dt; 6, 7: + XSPH)
        i, i, i, i, i, i,  # nx, ny, nz, k, tile, kind
        f, f, f, f, f, f,  # inv2h, h, sigma, h2eps, cv, supp2
        f, f, f, f,  # adrho, ddfold, eta2, rho_floor (n_out = 4, 7)
        f,  # xfold (n_out = 6, 7)
        p,  # stream
    ]
    st_normals = [
        p, p, p, p, p, p,  # xc, mc, xn, rhon, mn, out
        i, i, i, i, i, i,  # nx, ny, nz, k, tile, kind
        f, f, f, f, f,  # inv2h, h, sigma, supp2, nfold
        p,  # stream
    ]
    st_force = [
        p, p, p, p,  # xc, nc, rhoc, mc
        p, p, p, p,  # xn, nn, rhon, mn
        p,  # out
        i, i, i, i, i,  # nx, ny, nz, k, tile
        f, f, f, f,  # supp2, inv_hs, cohfold, kfold
        p,  # stream
    ]
    for fn, argtypes in (
        (lib.tpgsd_density_pairs, density_pairs),
        (lib.tpgsd_accel_pairs, accel_pairs),
        (lib.tpgsd_st_normals, st_normals),
        (lib.tpgsd_st_force, st_force),
    ):
        fn.argtypes = argtypes
        fn.restype = i
    lib.tpgsd_tile_smem.argtypes = [i, i, i]
    lib.tpgsd_tile_smem.restype = ctypes.c_longlong
    lib.tpgsd_error_string.argtypes = [i]
    lib.tpgsd_error_string.restype = ctypes.c_char_p


def load():
    """The loaded kernel library (built on first call; raises on a
    failed build)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
    return _lib
