"""Build and load the port's CUDA kernels: one ``nvcc`` call, bound with ctypes.

Every source under ``csrc/`` has a plain C interface (no PyTorch headers),
so one ``nvcc`` call compiles all ``*.cu`` (which include the ``*.cuh``
headers beside them) into a shared library in seconds. The library links
nvcc's static CUDA runtime; each entry point takes the index of its
tensors' card and makes it current for its launch (``csrc/launch.cuh``).
PyTorch's own extension builder is not used: a source that includes
PyTorch's headers takes minutes to compile, it needs ``ninja``, and it can
wait forever on a stale lock file.

The library goes to ``build/tcsfm_torch/<digest>/libtcsfm_kernels.so`` at
the repository root, where ``<digest>`` hashes the sources and the flags,
so an edited source builds anew and an unchanged one is reused. The build
writes a temporary file and renames it into place; there is no lock file.
Nothing is built at import: ``load()`` builds at first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "tcsfm_torch"
LIB_NAME = "libtcsfm_kernels.so"
NVCC_TIMEOUT_S = 300    # a hung compiler is killed rather than waited on
# --threads 0: the one call compiles its sources in parallel
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--threads",
              "0")

_lib: ctypes.CDLL | None = None
build_log = ""          # nvcc's output of the build this process ran, if any
build_seconds = 0.0     # wall time of that build (0.0 when reused)


def find_nvcc() -> str:
    """nvcc from ``CUDA_HOME``, then ``/usr/local/cuda/bin``, then ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for them already exists."""
    global build_log, build_seconds
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.tmp.{os.getpid()}")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=NVCC_TIMEOUT_S)
    build_seconds = time.monotonic() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{build_log}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        # (pointers..., B, H, W, C[, Cg], device index, stream)
        lib.tcsfm_grid_sample_fwd.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.tcsfm_grid_sample_fwd.restype = i
        lib.tcsfm_grid_sample_fwd_grads.argtypes = [p, p, p, p, p,
                                                    i, i, i, i, i, p]
        lib.tcsfm_grid_sample_fwd_grads.restype = i
        lib.tcsfm_grid_sample_bwd_coords.argtypes = [p, p, p, p,
                                                     i, i, i, i, i, p]
        lib.tcsfm_grid_sample_bwd_coords.restype = i
        lib.tcsfm_grid_sample_bwd.argtypes = [p, p, p, p, p, u,
                                              i, i, i, i, i, i, p]
        lib.tcsfm_grid_sample_bwd.restype = i
        # (x, w1, b1, w2, b2, w3, b3, out, N, H, W, device index, stream)
        lib.tcsfm_decoder_tail_fwd.argtypes = [p] * 8 + [i, i, i, i, p]
        lib.tcsfm_decoder_tail_fwd.restype = i
        _lib = lib
    return _lib
