"""Build the package's native code at first use and load it.

Every ``*.cu`` under ``difficp_torch/csrc/`` is compiled for ``sm_90a`` by its
own ``nvcc -c``, all started together, and the objects are linked by one
``nvcc -shared`` into ``build/libdifficp_torch_kernels.so`` at the repository
root.  The host code (``*.cpp``: the greedy decimation of decim support) is
built by one ``g++`` into ``build/libdifficp_torch_host.so``.  Each library
has a plain C interface and is loaded with ``ctypes``; the modules that call
it declare each function's ``argtypes``.  A build is reused while it is newer
than every source and header and was made with the same command (kept in a
stamp file beside it).  A failed build raises with the compiler's output:
there is no fallback.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

HOST_LIB_PATH = BUILD_DIR / "libdifficp_torch_host.so"
HOST_STAMP_PATH = HOST_LIB_PATH.with_suffix(".cmd")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_host_lib = None
host_build_seconds = None  # wall time of the last host build, None when none ran
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


def _fresh(inputs, cmd_key: str, lib=LIB_PATH, stamp=STAMP_PATH) -> bool:
    if not (lib.exists() and stamp.exists()):
        return False
    newest = max(s.stat().st_mtime for s in inputs)
    return lib.stat().st_mtime >= newest and stamp.read_text() == cmd_key


def _publish(tmp: Path, lib: Path, stamp: Path, cmd_key: str, tag: str):
    """Move a finished build and its stamp into place (atomic renames:
    concurrent builds do not write over each other)."""
    os.replace(tmp, lib)
    stamp_tmp = BUILD_DIR / f"{stamp.name}.{tag}"
    stamp_tmp.write_text(cmd_key)
    os.replace(stamp_tmp, stamp)


def build(force: bool = False) -> Path:
    """Compile the sources unless a library from the same sources and
    command is already there."""
    global build_log, build_seconds
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    nvcc = _nvcc()
    cmd_key = " ".join([nvcc, *NVCC_FLAGS, "-c", *(s.name for s in sources)])
    if not force and _fresh(sources + sorted(CSRC.glob("*.cuh")), cmd_key):
        return LIB_PATH
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # private output names, then an atomic rename: concurrent builds do not
    # write over each other
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in sources]
    jobs = [(s, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for s, o in zip(sources, objs)]
    logs, failed = [], []
    for src, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"$ nvcc ... -c {src.name}\n{out}")
    try:
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        tmp = BUILD_DIR / f"{LIB_PATH.name}.{tag}"
        link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o", str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"CUDA kernel link failed:\n{link.stdout}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    _publish(tmp, LIB_PATH, STAMP_PATH, cmd_key, tag)
    build_log = "".join(logs)
    build_seconds = time.perf_counter() - t0
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def build_host(force: bool = False) -> Path:
    """Compile the host sources (``csrc/*.cpp``) with g++ into one library,
    unless one from the same sources and command is already there."""
    global host_build_seconds
    sources = sorted(CSRC.glob("*.cpp"))
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host library is built at first use")
    cmd_key = " ".join([gxx, *GXX_FLAGS, *(s.name for s in sources)])
    if not force and _fresh(sources, cmd_key, HOST_LIB_PATH, HOST_STAMP_PATH):
        return HOST_LIB_PATH
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = BUILD_DIR / f"{HOST_LIB_PATH.name}.{tag}"
    out = subprocess.run([gxx, *GXX_FLAGS, *map(str, sources), "-o", str(tmp)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host library build failed:\n{out.stdout}")
    _publish(tmp, HOST_LIB_PATH, HOST_STAMP_PATH, cmd_key, tag)
    host_build_seconds = time.perf_counter() - t0
    return HOST_LIB_PATH


def host_library() -> ctypes.CDLL:
    """The loaded host library, built first if needed."""
    global _host_lib
    if _host_lib is None:
        _host_lib = ctypes.CDLL(str(build_host()))
    return _host_lib
