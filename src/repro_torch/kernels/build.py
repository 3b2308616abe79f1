"""Build and load the hand-written CUDA kernels.

The ``csrc/*.cu`` sources compile with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Each source compiles in
its own ``nvcc`` process, all started together, then one link.  The
library links the CUDA runtime alone: ``flash_attention_sm90.cu`` finds
``cuTensorMapEncodeTiled`` in ``libcuda.so.1`` with ``dlsym`` at run
time.

The library lands in ``build/repro_torch_kernels/`` at the root of the
checkout, named by a hash of the sources and flags: a changed source
builds anew, an unchanged one loads the library already there.  Nothing
here runs at import time -- :func:`library` builds on first use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("sig_hash.cu", "seg_count.cu", "flash_attention.cu",
           "flash_attention_sm90.cu", "linear_scan.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIB: ctypes.CDLL | None = None
_LIB_LOCK = threading.Lock()   # the sharded query drain launches from threads
BUILD_LOG = ""          # compiler output of the last build (ptxas -v lines)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of repro_torch build only where the CUDA toolkit is "
            "installed")
    return found


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (if this exact build is absent) and return the
    library path."""
    global BUILD_LOG
    lib_path = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (name + ".o") for name in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(n, log) for n, p, log in zip(SOURCES, procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {n}\n{log}" for n, log in failed))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
             str(tmp_lib)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)    # atomic: concurrent builds agree
    BUILD_LOG = "\n".join(logs)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (once, whichever
    thread asks first)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.repro_sig_hash.argtypes = [p, i64, i32, i64, p, i64, i64, p,
                                       i64, p, p]
        lib.repro_sig_hash.restype = i32
        lib.repro_seg_count.argtypes = [p, i64, i64, p, p, p]
        lib.repro_seg_count.restype = i32
        for fn in (lib.repro_flash_attention, lib.repro_flash_attention_sm90):
            fn.argtypes = [p, p, p, p, p, i64, i32, i32, i64, i64, i32,
                           ctypes.c_float, i32, i32, p]
            fn.restype = i32
        lib.repro_linear_scan.argtypes = [p, p, p, p, p, i64, i64, i64, i32,
                                          p]
        lib.repro_linear_scan.restype = i32
        _LIB = lib
    return _LIB


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")
