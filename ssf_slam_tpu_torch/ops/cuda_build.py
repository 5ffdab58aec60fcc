"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``ssf_slam_tpu_torch/build/``
and loaded through ``ctypes`` — no PyTorch headers, so a build takes
seconds. The library name carries a hash of the sources, so an edited
source is rebuilt and a stale library is never loaded. Nothing is built
when the module is imported: the first kernel launch (or ``build_all``)
does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# library name -> its source; every library also includes banded_common.cuh
SOURCES = {
    "ssf_band_knn": "band_knn.cu",
    "ssf_band_scatter": "band_scatter.cu",
    "ssf_cost_attention": "cost_attention.cu",
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures (all return a cudaError_t code)
SIGNATURES = {
    "ssf_band_knn": {
        "ssf_knn_group": [_P, _P, _P, _P] + [_I] * 9 + [_P, _P, _P, _P],
        "ssf_knn_idw": [_P, _P, _P, _P] + [_I] * 8 + [_F, _I]
        + [_P, _P, _P, _P],
    },
    "ssf_band_scatter": {
        "ssf_regroup": [_P, _P, _P] + [_I] * 8 + [_P, _P],
        "ssf_scatter_softmax_sum": [_P, _P, _P, _P] + [_I] * 8 + [_P, _P],
    },
    "ssf_cost_attention": {
        "ssf_cost_attention": [_P] * 9 + [_I] * 5 + [_P, _P, _P],
    },
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = (os.environ.get("NVCC") or shutil.which("nvcc")
            or "/usr/local/cuda/bin/nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked for {path})")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for f in (SOURCES[name], "banded_common.cuh"):
        with open(os.path.join(SRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_all(verbose: bool = False) -> dict[str, str]:
    """Compile every library that is not built yet, all nvcc processes
    started together. Returns {name: ptxas report} (empty unless verbose,
    which adds ``-Xptxas -v``: registers, shared memory and spills)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, src in SOURCES.items():
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, os.path.join(SRC_DIR, src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            os.unlink(tmp)
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            build_all()
        lib = ctypes.CDLL(path)
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.ssf_error_string.argtypes = [ctypes.c_int]
        lib.ssf_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def call(name: str, fn: str, *args) -> None:
    """Launch ``fn`` of library ``name``; raise on a nonzero CUDA error."""
    lib = load(name)
    code = getattr(lib, fn)(*args)
    if code != 0:
        msg = lib.ssf_error_string(code).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {code} ({msg})")
