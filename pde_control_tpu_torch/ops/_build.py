"""Builds the package's CUDA sources with nvcc at first use, loads them with
ctypes.

Every `csrc/*.cu` file goes into one shared library with a plain C
interface, compiled for Hopper (`sm_90a`). The library's file name carries
a hash of the sources, so an edited source is rebuilt and a stale binary is
never loaded. The build goes into `pde_control_tpu_torch/_build/`, which
git ignores; a process builds at most once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float      # nvcc wall time; 0.0 when the library was already built
    log: str            # nvcc's output (ptxas register / shared-memory report)


_lock = threading.Lock()
_loaded: tuple[ctypes.CDLL, BuildInfo] | None = None


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources under {CSRC}")
    return srcs


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                       "the CUDA kernels build only where the CUDA toolkit is")


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256()
    for path in srcs:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(srcs: list[Path], target: Path) -> BuildInfo:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in srcs if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, target)  # atomic: a concurrent reader never sees half a file
    return BuildInfo(target, seconds, log)


def load() -> tuple[ctypes.CDLL, BuildInfo]:
    """The kernels' library (built on first call) and how it was built."""
    global _loaded
    with _lock:
        if _loaded is None:
            srcs = _sources()
            target = BUILD_DIR / f"libpde_kernels_{_digest(srcs)}.so"
            info = (_compile(srcs, target) if not target.exists()
                    else BuildInfo(target, 0.0, ""))
            _loaded = (ctypes.CDLL(str(target)), info)
        return _loaded
