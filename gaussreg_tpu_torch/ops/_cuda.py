"""Build, load and launch the port's hand-written CUDA kernels.

Each source under gaussreg_tpu_torch/csrc/ is compiled by nvcc for sm_90a
into its own shared library (one library for all the entry points of a
source) with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -I csrc -o _build/<stem>-<hash>.so csrc/<stem>.cu

Libraries are built at first use (or all at once, in parallel, by
`build_all`) into gaussreg_tpu_torch/_build/, which .gitignore lists; the
file name carries a hash of the source and the headers it may include
(csrc/*.cuh, and those beside a copy built from elsewhere), so an edited
kernel is rebuilt.
Nothing is compiled or imported when this module is imported.

Every C entry point returns the cudaError_t of its launch
(cudaGetLastError()); `CudaKernel.launch` raises on a non-zero code and
counts the launch. `launch_counts()` reads those counts beside the path's
other counters (`counter`), such as a CUDA graph's captures and replays;
a replay launches what its capture recorded, so the replaying code adds
those launches back (`add_launches`).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List, Sequence

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")
    return path


class CudaKernel:
    """One csrc/*.cu source, its C entry point and its launch count.

    `launches` is incremented once per launch of the kernel and nowhere
    else, so a run can show that its main path went through the kernel."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = os.path.join(CSRC, source)
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    @property
    def lib_path(self) -> str:
        h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
        # a source may include any header of its own directory or, failing
        # that, of csrc/ (a copy built from elsewhere: `build_command`'s -I)
        dirs = sorted({os.path.dirname(self.source), CSRC})
        headers = sorted(p for d in dirs for p in glob.glob(os.path.join(d, "*.cuh")))
        for path in [self.source, *headers]:
            with open(path, "rb") as f:
                h.update(f.read())
        digest = h.hexdigest()
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR, f"{stem}-{digest[:12]}.so")

    def build_command(self, out_path: str) -> List[str]:
        return [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", out_path, self.source]

    def _load(self):
        if self._fn is None:
            path = self.lib_path
            if not os.path.exists(path):
                _build([self])
            fn = getattr(ctypes.CDLL(path), self.symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = self.argtypes + [ctypes.c_void_p]  # + stream
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Launch on the current CUDA stream; raise if the launch failed."""
        fn = self._load()
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA launch failed with error {rc}")
        self.launches += 1


KERNELS: Dict[str, CudaKernel] = {}


def register(name: str, kernel: CudaKernel) -> CudaKernel:
    KERNELS[name] = kernel
    return kernel


class Counter:
    """A count read and reset with the kernels' launches that is not one
    kernel's launches."""

    def __init__(self):
        self.launches = 0


COUNTERS: Dict[str, Counter] = {}


def counter(name: str) -> Counter:
    """The counter `name` in `launch_counts()`, made at its first use."""
    return COUNTERS.setdefault(name, Counter())


def _build(kernels: Sequence[CudaKernel]) -> float:
    """Compile the given kernels' sources in parallel (one nvcc process each).
    Returns the wall seconds the build took; raises on a failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    jobs, queued = [], set()
    for k in kernels:
        out = k.lib_path
        if os.path.exists(out) or out in queued:  # kernels of one source share its library
            continue
        queued.add(out)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            k.build_command(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT
        )
        jobs.append((k, proc, tmp, out))
    errors = []
    for k, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            os.remove(tmp)
            errors.append(f"{k.source}:\n{log.decode(errors='replace')}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def build_all() -> float:
    """Build every registered kernel (importing the modules of the path's
    kernels first; a caller that also needs other kernels imports their
    modules before the call). Returns the wall seconds nvcc took."""
    from gaussreg_tpu_torch.gs.rasterizer import accumulate, kernels  # noqa: F401
    from gaussreg_tpu_torch.ops import fused_select, kpconv_kernel, select_k  # noqa: F401

    return _build(list(KERNELS.values()))


def reset_launch_counts() -> None:
    for k in (*KERNELS.values(), *COUNTERS.values()):
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches and each counter's count, by name."""
    return {name: k.launches for name, k in {**KERNELS, **COUNTERS}.items()}


def add_launches(counts: Dict[str, int]) -> None:
    """Add `counts` (by name, as launch_counts() gives them; negative to
    take off) to the kernels' and counters' counts."""
    every = {**KERNELS, **COUNTERS}
    for name, n in counts.items():
        every[name].launches += n


def check_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    """Validate a tensor before its pointer reaches a kernel."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
