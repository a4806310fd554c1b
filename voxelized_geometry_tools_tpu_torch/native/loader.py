"""ctypes loader for the native CPU runtime (``vgt_native.cpp``, a copy of
the JAX package's source, byte for byte).

Port of ``voxelized_geometry_tools_tpu/native/loader.py`` with the same
functions. It compiles the shared library on first use with g++ into this
directory's ``_build/`` (git-ignored), keyed by a hash of the source and the
host's CPU flags, and exposes typed wrappers on numpy arrays. If no compiler
is available, :func:`available` returns False and the backend registry skips
the native backend.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "vgt_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_FAILED = False


def _build_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    # -march=native binaries are ISA-specific: fold the machine and its CPU
    # flags into the key, so a build directory shared across hosts never
    # serves another host's build.
    h.update(platform.machine().encode())
    try:
        with open("/proc/cpuinfo") as c:
            for line in c:
                if line.startswith("flags"):
                    h.update(line.encode())
                    break
    except OSError:
        pass
    return BUILD_DIR / f"libvgt_native_{h.hexdigest()[:16]}.so"


def _compile(so_path: Path):
    so_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-std=c++20", "-shared", "-fPIC",
           "-o", str(tmp), str(_SRC), "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        # Rename last, so a concurrent loader never sees a half-written file.
        os.replace(tmp, so_path)
    finally:
        tmp.unlink(missing_ok=True)


def get_library() -> Optional[ctypes.CDLL]:
    global _LIB, _FAILED
    if _LIB is not None or _FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _FAILED:
            return _LIB
        try:
            so_path = _build_path()
            if not so_path.exists():
                _compile(so_path)
            lib = ctypes.CDLL(str(so_path))

            lib.vgt_edt_sdf.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
                ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
            lib.vgt_edt_sdf.restype = None

            lib.vgt_raycast.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_float, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32)]
            lib.vgt_raycast.restype = None

            lib.vgt_filter.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float)]
            lib.vgt_filter.restype = None

            lib.vgt_hardware_threads.argtypes = []
            lib.vgt_hardware_threads.restype = ctypes.c_int
            _LIB = lib
        except (OSError, subprocess.CalledProcessError):
            _FAILED = True
    return _LIB


def available() -> bool:
    return get_library() is not None


def hardware_threads() -> int:
    lib = get_library()
    if lib is None:
        return os.cpu_count() or 1
    return int(lib.vgt_hardware_threads())


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _require() -> ctypes.CDLL:
    lib = get_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def edt_sdf(filled: np.ndarray, resolution: float,
            num_threads: int = 0) -> np.ndarray:
    """Signed distance field (float32) from a bool filled mask."""
    lib = _require()
    filled = np.ascontiguousarray(filled, dtype=np.uint8)
    nx, ny, nz = filled.shape
    out = np.empty(filled.shape, dtype=np.float32)
    threads = num_threads or hardware_threads()
    lib.vgt_edt_sdf(_ptr(filled, ctypes.c_uint8), nx, ny, nz,
                    ctypes.c_float(resolution), threads,
                    _ptr(out, ctypes.c_float))
    return out


def raycast(origins: np.ndarray, points: np.ndarray, max_range: float,
            counts, resolution: float, num_threads: int = 0):
    """Carve grid-frame rays into fresh {seen_free, seen_filled} counters."""
    lib = _require()
    points = np.ascontiguousarray(points, dtype=np.float32).reshape(-1, 3)
    origins = np.ascontiguousarray(
        np.broadcast_to(np.asarray(origins, np.float32).reshape(-1, 3),
                        points.shape))
    nx, ny, nz = counts
    seen_free = np.zeros((nx, ny, nz), dtype=np.int32)
    seen_filled = np.zeros((nx, ny, nz), dtype=np.int32)
    threads = num_threads or hardware_threads()
    lib.vgt_raycast(_ptr(origins, ctypes.c_float), _ptr(points, ctypes.c_float),
                    points.shape[0], ctypes.c_float(max_range),
                    nx, ny, nz, ctypes.c_float(resolution), threads,
                    _ptr(seen_free, ctypes.c_int32),
                    _ptr(seen_filled, ctypes.c_int32))
    return seen_free, seen_filled


def filter_grids(seen_free: np.ndarray, seen_filled: np.ndarray,
                 occupancy: np.ndarray, percent_seen_free: float = 1.0,
                 outlier_points_threshold: int = 1,
                 num_cameras_seen_free: int = 1,
                 num_threads: int = 0) -> np.ndarray:
    """Fuse stacked per-camera counters [C, nx, ny, nz] into occupancy."""
    lib = _require()
    seen_free = np.ascontiguousarray(seen_free, dtype=np.int32)
    seen_filled = np.ascontiguousarray(seen_filled, dtype=np.int32)
    out = np.ascontiguousarray(occupancy, dtype=np.float32).copy()
    c = seen_free.shape[0]
    v = int(np.prod(seen_free.shape[1:]))
    threads = num_threads or hardware_threads()
    lib.vgt_filter(_ptr(seen_free, ctypes.c_int32),
                   _ptr(seen_filled, ctypes.c_int32), c, v,
                   ctypes.c_float(percent_seen_free),
                   outlier_points_threshold, num_cameras_seen_free, threads,
                   _ptr(out, ctypes.c_float))
    return out.reshape(occupancy.shape)


def probe_available() -> bool:
    """Cheap availability probe for backend enumeration: true when the
    library is loaded, a cached build exists, or g++ is present, without
    the build that :func:`available` performs. A probe-positive backend can
    still fail to build."""
    if _LIB is not None:
        return True
    if _FAILED:
        return False
    try:
        if _build_path().exists():
            return True
    except OSError:
        return False
    return shutil.which("g++") is not None
