"""Builds the package's CUDA sources with nvcc at first use, loads them with
ctypes.

Every `csrc/*.cu` file goes into one shared library with a plain C
interface, compiled for Hopper (`sm_90a`): one `nvcc -c` per source, all
started together, then one link. The library's file name carries a hash
of the sources, so an edited source is rebuilt and a stale binary is never
loaded; nvcc's output (ptxas's report of registers, spills and shared
memory) is kept beside it. The build goes into
`pde_control_tpu_torch/_build/`, which git ignores; a process builds at most
once.
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
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float      # nvcc wall time (compiles and link); 0.0 when the
                        # library was already built
    log: str            # nvcc's output for each source (ptxas register /
                        # shared-memory report), from the build's log file
                        # when the library was already built


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
    tmp = BUILD_DIR / f"tmp{os.getpid()}"
    tmp.mkdir(exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in srcs if s.suffix == ".cu"):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(tmp / f"{src.stem}.o"), str(src)]
        jobs.append((src, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, cmd, proc in jobs:
        out = proc.communicate()[0]
        logs.append(f"-- {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if failed:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("\n".join(failed))
    lib = target.with_suffix(f".tmp{os.getpid()}")
    cmd = [nvcc, *_ARCH, "-shared", "-o", str(lib),
           *(str(tmp / f"{src.stem}.o") for src, _, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    shutil.rmtree(tmp, ignore_errors=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    target.with_suffix(".log").write_text("".join(logs))
    os.replace(lib, target)  # atomic: a concurrent reader never sees half a file
    return BuildInfo(target, time.perf_counter() - t0, "".join(logs))


def load() -> tuple[ctypes.CDLL, BuildInfo]:
    """The kernels' library (built on first call) and how it was built."""
    global _loaded
    with _lock:
        if _loaded is None:
            srcs = _sources()
            target = BUILD_DIR / f"libpde_kernels_{_digest(srcs)}.so"
            info = (_compile(srcs, target) if not target.exists()
                    else BuildInfo(target, 0.0,
                                   target.with_suffix(".log").read_text()))
            _loaded = (ctypes.CDLL(str(target)), info)
        return _loaded
