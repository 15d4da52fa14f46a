"""ctypes binding of the frozen furthest point sampling (fps.cpp), built at
first use with g++ into portbench/_build/ (a fixed directory inside the
checkout, listed in .gitignore), the file name carrying a hash of the
source and flags so an edited source is rebuilt.

No -march=native: the generated inputs must not depend on the host CPU."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fps.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off"]
_LIB = None


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"fps-{digest}.so")


def _load():
    global _LIB
    if _LIB is None:
        path = _lib_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                               capture_output=True)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(path)
        lib.gaussreg_bucket_fps.restype = ctypes.c_int
        lib.gaussreg_bucket_fps.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _LIB = lib
    return _LIB


def furthest_point_sample(points: np.ndarray, num_samples: int, seed: int = 0) -> np.ndarray:
    """Indices (int64) of `num_samples` points chosen by exact furthest point
    sampling from a start drawn by `seed`; all indices when num_samples >= n."""
    n = points.shape[0]
    if num_samples >= n:
        return np.arange(n)
    pts = np.ascontiguousarray(points, dtype=np.float32)
    out = np.empty(num_samples, dtype=np.int64)
    rc = _load().gaussreg_bucket_fps(pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
                                     num_samples, seed,
                                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        raise RuntimeError(f"furthest point sampling failed: rc={rc}")
    return out
