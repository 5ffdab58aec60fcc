"""ssfb: the native-backed sequence format and its loader: the port's copy
of ``ssf_slam_tpu/data/ssfb.py``.

Sequences are packed into one mmap-able binary file (``write_ssfb``); a
native reader thread (``native/loader.cc``) prefetches frames ahead of the
consumer through a ring buffer. The library is built from that source at
first use with the Makefile's flags (``g++ -O3 -std=c++17 -fPIC -pthread
-shared``) into ``ssf_slam_tpu_torch/build/libssfb-<hash>.so``, keyed by
the source's hash as the CUDA libraries are (``ops/cuda_build.py``);
nothing is written under ``native/``. A failed build raises, with the
compiler's output.

Schema of the CARLA npz frames (utils/datasets/carla.py:455-465):
pos1/pos2/gt/ego_flow [N,3] float32, s_fg_mask/mask1 [N] float32, time [1].
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
import warnings

import numpy as np

_MAGIC = 0x42465353
_MAX_FIELDS = 8
_FIELDS = [
    ("pos1", 3),
    ("pos2", 3),
    ("gt", 3),
    ("ego_flow", 3),
    ("s_fg_mask", 1),
    ("mask1", 1),
    ("time", 1),  # scalar broadcast into n_points floats (slot 0 used)
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "loader.cc")
BUILD_DIR = os.path.join(_PKG, "build")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]
_lib = None


def lib_path() -> str:
    """Where the library of the current ``native/loader.cc`` lives."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libssfb-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile ``native/loader.cc`` into the build directory unless that
    source's library is there already; returns its path."""
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building the ssfb loader failed ({cxx} exit "
                           f"{proc.returncode}):\n{proc.stderr[-2000:]}")
    os.replace(tmp, out)
    return out


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    lib.ssfb_open.restype = ctypes.c_void_p
    lib.ssfb_open.argtypes = [ctypes.c_char_p]
    lib.ssfb_info.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_uint32)
    ] * 3
    lib.ssfb_field_index.restype = ctypes.c_int
    lib.ssfb_field_index.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ssfb_field_dim.restype = ctypes.c_uint32
    lib.ssfb_field_dim.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ssfb_frame_ptr.restype = ctypes.POINTER(ctypes.c_float)
    lib.ssfb_frame_ptr.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_int]
    lib.ssfb_prefetch_start.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.c_int64]
    lib.ssfb_next.restype = ctypes.c_int64
    lib.ssfb_next.argtypes = [ctypes.c_void_p]
    lib.ssfb_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the loader library builds and loads here."""
    try:
        _load_lib()
    except (OSError, RuntimeError):
        return False
    return True


def write_ssfb(frames: list, path: str) -> None:
    """Pack a frame-dict sequence (data/synthetic.py schema) into one file."""
    n_frames = len(frames)
    n_points = len(frames[0]["pos1"])
    with open(path, "wb") as f:
        names = b""
        dims = []
        for name, dim in _FIELDS:
            names += name.encode().ljust(8, b"\0")[:8]
            dims.append(dim)
        dims += [0] * (_MAX_FIELDS - len(dims))
        names += b"\0" * 8 * (_MAX_FIELDS - len(_FIELDS))
        f.write(
            struct.pack(
                f"<5I{_MAX_FIELDS}I", _MAGIC, 1, n_frames, n_points,
                len(_FIELDS), *dims,
            )
        )
        f.write(names)
        for fr in frames:
            for name, dim in _FIELDS:
                if name == "time":
                    arr = np.zeros(n_points, np.float32)
                    arr[0] = np.float32(fr.get("time", 0.0))
                else:
                    arr = np.asarray(fr[name], np.float32)
                    if dim == 1:
                        arr = arr.reshape(n_points)
                    else:
                        arr = arr.reshape(n_points, dim)
                f.write(arr.tobytes())


class SsfbSequence:
    """Zero-copy mmap'd reader with native prefetch."""

    def __init__(self, path: str):
        lib = _load_lib()
        self._lib = lib
        self._h = lib.ssfb_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open {path}")
        nf, npnt, nfield = (ctypes.c_uint32() for _ in range(3))
        lib.ssfb_info(self._h, ctypes.byref(nf), ctypes.byref(npnt),
                      ctypes.byref(nfield))
        self.n_frames = nf.value
        self.n_points = npnt.value

    def field(self, frame: int, name: str) -> np.ndarray:
        idx = self._lib.ssfb_field_index(self._h, name.encode())
        if idx < 0:
            raise KeyError(name)
        dim = self._lib.ssfb_field_dim(self._h, idx)
        ptr = self._lib.ssfb_frame_ptr(self._h, frame, idx)
        n = self.n_points * dim
        arr = np.ctypeslib.as_array(ptr, shape=(n,))
        return arr.reshape(self.n_points, dim) if dim > 1 else arr

    def frame(self, i: int) -> dict:
        out = {name: np.array(self.field(i, name))
               for name, dim in _FIELDS if name != "time"}
        out["time"] = float(self.field(i, "time")[0])
        out["mask1"] = out["mask1"] > 0.5
        return out

    def prefetch_iter(self, start: int = 0, stride: int = 1):
        """Iterate frames with the native prefetcher running ahead."""
        self._lib.ssfb_prefetch_start(self._h, start, stride)
        while True:
            f = self._lib.ssfb_next(self._h)
            if f < 0:
                return
            yield f, self.frame(int(f))

    def close(self):
        if self._h:
            self._lib.ssfb_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception as exc:  # never raise from __del__, but say why
            warnings.warn(f"SsfbSequence teardown failed: {exc}")


class SsfbStripe:
    """Striped multi-sequence reader: one stream per sequence.

    The native layer prefetches every stream on its own thread and gathers
    frame k of ALL streams into persistent batch buffers ([S, N, dim]
    row-major) in one ctypes call (the GIL is released across the page
    wait and the copy); the buffers are double-buffered, so the batch
    handed out for scan k stays valid while the native side fills k+1. It
    is the host feed of the JAX package's sharded streaming runner
    (``parallel/mesh.py``), which the port has not ported yet.
    """

    def __init__(self, paths: list[str],
                 fields: tuple[str, ...] = ("pos1", "mask1", "time")):
        lib = _load_lib()
        self._lib = lib
        self._register_stripe_abi(lib)
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        self._h = lib.ssfb_stripe_open(arr, len(paths))
        if not self._h:
            raise IOError(f"cannot open stripe over {paths}")
        nf, npnt, nfield = (ctypes.c_uint32() for _ in range(3))
        lib.ssfb_stripe_info(self._h, ctypes.byref(nf), ctypes.byref(npnt),
                             ctypes.byref(nfield))
        self.n_seqs = len(paths)
        self.n_frames = nf.value
        self.n_points = npnt.value
        self.fields = tuple(fields)
        self._idx = []
        self._dims = []
        for name in self.fields:
            i = lib.ssfb_stripe_field_index(self._h, name.encode())
            if i < 0:
                raise KeyError(name)
            self._idx.append(i)
            self._dims.append(dict(_FIELDS)[name])
        self._fidx = (ctypes.c_int * len(self._idx))(*self._idx)
        # double buffers: the yielded batch must survive one more next() call
        self._bufs = [
            [np.empty((self.n_seqs, self.n_points * d), np.float32)
             for d in self._dims]
            for _ in range(2)
        ]
        self._flip = 0

    @staticmethod
    def _register_stripe_abi(lib):
        if getattr(lib, "_stripe_abi_done", False):
            return
        lib.ssfb_stripe_open.restype = ctypes.c_void_p
        lib.ssfb_stripe_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                         ctypes.c_int]
        lib.ssfb_stripe_info.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_uint32)] * 3
        lib.ssfb_stripe_field_index.restype = ctypes.c_int
        lib.ssfb_stripe_field_index.argtypes = [ctypes.c_void_p,
                                                ctypes.c_char_p]
        lib.ssfb_stripe_start.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                          ctypes.c_int64]
        lib.ssfb_stripe_next.restype = ctypes.c_int64
        lib.ssfb_stripe_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ]
        lib.ssfb_stripe_close.argtypes = [ctypes.c_void_p]
        lib._stripe_abi_done = True

    def batches(self, start: int = 0, stride: int = 1):
        """Yield (frame_idx, {field: [S, N, dim] or [S, N]}) per scan step."""
        self._lib.ssfb_stripe_start(self._h, start, stride)
        while True:
            bufs = self._bufs[self._flip]
            self._flip ^= 1
            outs = (ctypes.POINTER(ctypes.c_float) * len(bufs))(*[
                b.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
                for b in bufs
            ])
            f = self._lib.ssfb_stripe_next(self._h, self._fidx, len(bufs),
                                           outs)
            if f == -2:
                raise RuntimeError("stripe streams desynchronized")
            if f < 0:
                return
            batch = {}
            for name, dim, buf in zip(self.fields, self._dims, bufs):
                batch[name] = (buf.reshape(self.n_seqs, self.n_points, dim)
                               if dim > 1
                               else buf.reshape(self.n_seqs, self.n_points))
            yield int(f), batch

    def close(self):
        if self._h:
            self._lib.ssfb_stripe_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception as exc:
            warnings.warn(f"SsfbStripe teardown failed: {exc}")
