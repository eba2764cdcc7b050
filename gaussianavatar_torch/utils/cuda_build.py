"""Build and load the port's hand-written CUDA kernels.

Each source under `gaussianavatar_torch/csrc/` has a plain C interface and
is compiled by `nvcc` for `sm_90a` into a shared library of its own, which
`ctypes` loads. Nothing includes PyTorch's headers, so a build takes
seconds, not minutes. Libraries go to `build/kernels/` in the checkout
(listed in .gitignore), named by a hash of the source and the flags, and are
built on first use. `build_all` starts one `nvcc` per source, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from os.path import abspath, dirname, join
from typing import Dict, Iterable, NamedTuple

_PKG = dirname(dirname(abspath(__file__)))
BUILD_DIR = join(dirname(_PKG), "build", "kernels")

# kernel name -> source under the package
SOURCES = {"blend_fwd": "csrc/blend_fwd.cu", "blend_bwd": "csrc/blend_bwd.cu"}

# kernel name -> launches so far in this process. Each wrapper adds one
# where it launches its kernel, and nowhere else, so a run can show which
# kernels its main path went through.
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """Each kernel's launches since `before`, a copy of LAUNCHES."""
    return {name: n - before.get(name, 0) for name, n in LAUNCHES.items()}

# -fmad=false: no fused multiply-adds, so the kernels round after every
# multiply and add exactly as their plain PyTorch versions do; the gating
# tests (alpha >= 1/255, T >= 1e-4) then decide the same way on both, and
# the per-pixel gradient terms agree bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildResult(NamedTuple):
    path: str
    seconds: float   # 0.0 when the library was already built
    log: str         # nvcc's output (ptxas register / shared-memory report)


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [join(cuda_home, "bin", "nvcc")] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA kernels "
                       "are built from source on first use")


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of its source, the headers beside
    it and the flags."""
    src = join(_PKG, SOURCES[name])
    csrc = dirname(src)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(join(csrc, n) for n in os.listdir(csrc) if n.endswith(".cuh")):
        with open(path, "rb") as f:
            h.update(f.read())
    return join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def build_all(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, BuildResult]:
    """Compile every named kernel that is not built yet, one nvcc process per
    source, all started together. Raises with nvcc's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs, results = {}, {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            results[name] = BuildResult(out, 0.0, "")
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, join(_PKG, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out, tmp, time.perf_counter())
    failed = []
    for name, (proc, out, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = BuildResult(out, seconds, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return results


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    return ctypes.CDLL(build_all([name])[name].path)
