"""ctypes bridge to the native C++ point-cloud readers (``_native/reader.cpp``).

Build once:  python -m hgmm_torch.data.native --build

Counterpart of ``hgmm/data/native.py``, with its own copy of the source. The
loaders in ``hgmm_torch.data.ply`` and ``hgmm_torch.data.kitti`` call through
here when the shared library has been built, else take their numpy paths
(same results, bit for bit; the native path matters for 10M+-point ingest and
voxelization). The library is built with g++ into
``hgmm_torch/_build/libhgmm_io-<hash>.so``, the hash covering the source, the
flags, the machine and the host CPU (``-march=native``), so a stale or foreign
library is never loaded. Nothing is built or loaded at import.

Unlike the reference, a library that exists but fails to load, or an entry
point that raises, raises: only the documented ``None`` returns (a file the
native reader does not handle, no library) send a caller to the numpy path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "_native" / "reader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_handles: dict[Path, ctypes.CDLL] = {}


def _cpu_model() -> str:
    """The host CPU's model name: -march=native code may not run on another."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


@functools.cache
def _key() -> str:
    h = hashlib.sha256(SRC.read_bytes())
    for part in (*FLAGS, platform.machine(), _cpu_model()):
        h.update(b"\0" + part.encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libhgmm_io-{_key()}.so"


def build(verbose: bool = True) -> Path:
    """Compile reader.cpp with g++ unless a library of the same key exists.
    Writes a temporary name and renames it, so a concurrent process never
    loads a half-written library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = Path(tmp) / out.name
        cmd = ["g++", *FLAGS, str(SRC), "-o", str(lib)]
        if verbose:
            print("+", " ".join(cmd))
        subprocess.run(cmd, check=True)
        os.replace(lib, out)
    return out


def _load() -> ctypes.CDLL | None:
    """The loaded library, or None when it has not been built (not latched:
    it may be built later in the process). A library that exists and fails
    to load raises OSError."""
    path = library_path()
    lib = _handles.get(path)
    if lib is not None or not path.exists():
        return lib
    lib = ctypes.CDLL(str(path))
    for name in ("hgmm_read_kitti_bin", "hgmm_read_ply_xyz"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.hgmm_voxel_downsample.restype = ctypes.c_int64
    lib.hgmm_voxel_downsample.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
                                          ctypes.c_void_p]
    _handles[path] = lib
    return lib


def available() -> bool:
    return _load() is not None


def _read(fn_name: str, path: str) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    fn = getattr(lib, fn_name)
    n = fn(path.encode(), None)
    if n < 0:
        return None  # the caller's numpy parser reads it (or reports the error)
    out = np.empty((n, 3), np.float32)
    if fn(path.encode(), out.ctypes.data_as(ctypes.c_void_p)) != n:
        return None  # the file changed between the two calls
    return out


def load_kitti_bin(path: str) -> np.ndarray | None:
    """[N, 3] float32 xyz of a KITTI velodyne scan; None without the library
    or for a file that is not whole [N, 4] float32 records."""
    return _read("hgmm_read_kitti_bin", str(path))


def load_ply(path: str) -> np.ndarray | None:
    """[N, 3] float32 xyz of a binary little-endian PLY whose x, y, z are
    contiguous floats; None without the library or for any other layout
    (ascii, big-endian, doubles, list properties), which the numpy parser
    reads."""
    return _read("hgmm_read_ply_xyz", str(path))


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray | None:
    """One centroid per occupied voxel, in the order of the voxels' packed
    keys, float32: bit-equal to the numpy path of
    hgmm_torch.data.kitti.voxel_downsample on float32 points. None without the
    library, for no points or a voxel <= 0."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"voxel_downsample: points of shape {pts.shape}, not [N, 3]")
    out = np.empty_like(pts)
    n = lib.hgmm_voxel_downsample(pts.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(pts.shape[0]),
                                  ctypes.c_float(voxel), out.ctypes.data_as(ctypes.c_void_p))
    if n < 0:
        return None
    return out[:n].copy()


if __name__ == "__main__":
    if "--build" in sys.argv:
        print(f"built {build()}")
    else:
        print(f"native lib present: {available()} ({library_path()})")
