"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``ssf_slam_tpu_torch/build/``
and loaded through ``ctypes`` — no PyTorch headers, so a build takes
seconds. The library name carries a hash of the sources, so an edited
source is rebuilt and a stale library is never loaded. Nothing is built
when the module is imported: the first kernel launch (or ``build_all``)
does it. A measurement build of a library with ``-D`` macros
(``build_all(variants=...)``, ``variant``) sits beside the library under
its own hash.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# library name -> its source; a source may include any header of csrc/
# (HEADERS), and every library's hash covers them all
SOURCES = {
    "ssf_band_knn": "band_knn.cu",
    "ssf_band_scatter": "band_scatter.cu",
    "ssf_cost_attention": "cost_attention.cu",
    "ssf_attention": "attention.cu",
}
HEADERS = ("banded_common.cuh", "mma_common.cuh")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures (all return a cudaError_t code)
SIGNATURES = {
    "ssf_band_knn": {
        "ssf_knn": [_P, _P, _P] + [_I] * 7 + [_P, _P, _P],
        "ssf_knn_group2": [_P] * 6 + [_I] * 9 + [_P] * 7,
        "ssf_knn_group": [_P, _P, _P, _P] + [_I] * 9 + [_P, _P, _P, _P],
        "ssf_knn_idw": [_P, _P, _P, _P] + [_I] * 8 + [_F, _I]
        + [_P, _P, _P, _P],
    },
    "ssf_band_scatter": {
        "ssf_regroup": [_P, _P, _P] + [_I] * 8 + [_P, _P],
        "ssf_scatter_add": [_P, _P, _P] + [_I] * 8 + [_P, _P],
        "ssf_scatter_softmax_sum": [_P, _P, _P, _P] + [_I] * 8 + [_P, _P],
    },
    "ssf_cost_attention": {
        "ssf_cost_attention": [_P] * 9 + [_I] * 5 + [_P, _P, _P],
    },
    "ssf_attention": {
        "ssf_attention": [_P, _P] + [_I] * 5 + [_P, _P, _P],
    },
}

# -Xptxas -v: each kernel's registers, stack frame and spills, kept beside
# the library (ptxas_report)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}
# library name -> the -D macros of the build that call() launches
_variants: dict[str, tuple[str, ...]] = {}


def nvcc() -> str:
    path = (os.environ.get("NVCC") or shutil.which("nvcc")
            or "/usr/local/cuda/bin/nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked for {path})")
    return path


def _flags(defines: tuple[str, ...]) -> list[str]:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def _lib_path(name: str, defines: tuple[str, ...] = ()) -> str:
    h = hashlib.sha256()
    for f in (SOURCES[name], *HEADERS):
        with open(os.path.join(SRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(_flags(defines)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def ptxas_report(name: str, defines: tuple[str, ...] = ()) -> str:
    """nvcc's ``-Xptxas -v`` report of the built library ``name`` (its
    build with the -D macros ``defines``)."""
    with open(_lib_path(name, defines)[:-3] + ".ptxas.txt") as f:
        return f.read()


def build_all(variants: tuple[tuple[str, tuple[str, ...]], ...] = ()) -> None:
    """Compile every library, and every (name, -D macros) build of
    ``variants``, that is not built yet, all nvcc processes started
    together."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name, defines in [(name, ()) for name in SOURCES] + list(variants):
        out = _lib_path(name, defines)
        if os.path.exists(out):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *_flags(defines), "-o", tmp,
               os.path.join(SRC_DIR, SOURCES[name])]
        procs.append((name, defines, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out))
    failed = []
    for name, defines, proc, tmp, out in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} {defines}: nvcc exit {proc.returncode}\n"
                          f"{log}")
            os.unlink(tmp)
            continue
        with open(out[:-3] + ".ptxas.txt", "w") as f:
            f.write(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library ``name`` (its build with the -D macros
    ``defines``), built first if needed."""
    lib = _loaded.get((name, defines))
    if lib is None:
        path = _lib_path(name, defines)
        if not os.path.exists(path):
            build_all(variants=((name, defines),))
        lib = ctypes.CDLL(path)
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.ssf_error_string.argtypes = [ctypes.c_int]
        lib.ssf_error_string.restype = ctypes.c_char_p
        _loaded[(name, defines)] = lib
    return lib


@contextlib.contextmanager
def variant(name: str, defines: tuple[str, ...]):
    """Within the block, every launch of library ``name`` goes to its build
    with the -D macros ``defines`` (a measurement build); after it, to the
    library again."""
    load(name, defines)
    _variants[name] = defines
    try:
        yield
    finally:
        del _variants[name]


def call(name: str, fn: str, *args) -> None:
    """Launch ``fn`` of library ``name``; raise on a nonzero CUDA error."""
    lib = load(name, _variants.get(name, ()))
    code = getattr(lib, fn)(*args)
    if code != 0:
        msg = lib.ssf_error_string(code).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {code} ({msg})")
