"""ctypes bindings for the repo's native host library (native/gaussreg_native.cpp):
furthest point sampling for host data loading, and a host voxel-grid
subsample.

The port's own copy of gaussreg_tpu/utils/native.py. The library is built
at first use from the repo's source into gaussreg_tpu_torch/_build/ (listed
in .gitignore), with the flags of native/build.sh.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "gaussreg_native.cpp")
_BUILD = os.path.join(_PKG, "_build")
_LIB_PATH = os.path.join(_BUILD, "libgaussreg_native.so")

_LIB = None
_TRIED = False


def _build() -> None:
    os.makedirs(_BUILD, exist_ok=True)
    # build under a temporary name and rename: concurrent test workers may
    # build at once, and a rename is atomic
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             _SRC, "-o", tmp],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_LIB_PATH):
        if not os.path.exists(_SRC):
            return None
        try:
            _build()
        except (OSError, subprocess.CalledProcessError):
            return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.gaussreg_bucket_fps.restype = ctypes.c_int
    lib.gaussreg_bucket_fps.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.gaussreg_fps.restype = ctypes.c_int
    lib.gaussreg_fps.argtypes = lib.gaussreg_bucket_fps.argtypes
    lib.gaussreg_grid_subsample.restype = ctypes.c_int64
    lib.gaussreg_grid_subsample.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def furthest_point_sample(
    points: np.ndarray, num_samples: int, seed: int = 0, exact: bool = False
) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    pts = np.ascontiguousarray(points, dtype=np.float32)
    out = np.empty(num_samples, dtype=np.int64)
    fn = lib.gaussreg_fps if exact else lib.gaussreg_bucket_fps
    rc = fn(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pts.shape[0],
        num_samples,
        seed,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        raise RuntimeError(f"native FPS failed: rc={rc}")
    return out


def grid_subsample_host(points: np.ndarray, voxel: float, capacity: int):
    """Voxel-grid subsample on the host: (the first min(total, capacity)
    voxel points (K, 3) f32, total voxels)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    pts = np.ascontiguousarray(points, dtype=np.float32)
    out = np.zeros((capacity, 3), dtype=np.float32)
    total = lib.gaussreg_grid_subsample(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pts.shape[0],
        voxel,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        capacity,
    )
    return out[: min(total, capacity)], int(total)
