"""Build the package's CUDA kernels with nvcc at first use and load them.

Every ``*.cu`` under ``difficp_torch/csrc/`` is compiled for ``sm_90a`` by
one ``nvcc -shared`` call into ``build/libdifficp_torch_kernels.so`` at the
repository root.  The library has a plain C interface and is loaded with
``ctypes``; the kernel modules declare each function's ``argtypes``.  A build
is reused while it is newer than every source and was made with the same
nvcc command (kept in a stamp file beside it).  A failed build raises with
nvcc's output.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
LIB_PATH = BUILD_DIR / "libdifficp_torch_kernels.so"
STAMP_PATH = LIB_PATH.with_suffix(".cmd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_log = ""  # nvcc's output of the last build (register and spill report)
build_seconds = None  # wall time of the last build, None when none ran


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first use")


def _fresh(sources, cmd_key: str) -> bool:
    if not (LIB_PATH.exists() and STAMP_PATH.exists()):
        return False
    newest = max(s.stat().st_mtime for s in sources)
    return (LIB_PATH.stat().st_mtime >= newest
            and STAMP_PATH.read_text() == cmd_key)


def build(force: bool = False) -> Path:
    """Compile the sources unless a library from the same sources and
    command is already there."""
    global build_log, build_seconds
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    nvcc = _nvcc()
    cmd_key = " ".join([nvcc, *NVCC_FLAGS, *(s.name for s in sources)])
    if not force and _fresh(sources, cmd_key):
        return LIB_PATH
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private output name, then an atomic rename: concurrent builds do not
    # write over each other
    tmp = BUILD_DIR / f"{LIB_PATH.name}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, *map(str, sources), "-o", str(tmp)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA kernel build failed:\n$ {' '.join(cmd)}\n"
                           f"{proc.stdout}")
    os.replace(tmp, LIB_PATH)
    stamp_tmp = BUILD_DIR / f"{STAMP_PATH.name}.{os.getpid()}.tmp"
    stamp_tmp.write_text(cmd_key)
    os.replace(stamp_tmp, STAMP_PATH)
    build_log = proc.stdout
    build_seconds = time.perf_counter() - t0
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib
