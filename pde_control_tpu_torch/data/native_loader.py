"""ctypes binding of the native C++ frame gather (`data/csrc/scene_loader.cpp`).

Counterpart of `pde_control_tpu/data/native_loader.py`, on the port's own
copy of the source. The library is compiled at first use with
`g++ -O3 -shared -fPIC -pthread -std=c++17` into
`pde_control_tpu_torch/_build/libsceneloader_<hash>.so`, the hash being the
source's, so an edited source is rebuilt and a stale binary is never
loaded. A failed build or load raises with the compiler's or the loader's
message, and a failed read raises with the file and the loader's code:
there is no fallback to numpy (the JAX package falls back quietly).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "scene_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
# The loader's return codes (scene_loader.cpp).
_CODES = {-2: "cannot open", -3: "bad .npy header or Fortran order",
          -4: "element count differs from the frame shape", -5: "short read",
          -6: "unsupported dtype (float32 or float64 only)"}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    """Where the library of the current source is (or will be) built."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libsceneloader_{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".tmp{os.getpid()}")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent reader never sees half


def get_lib() -> ctypes.CDLL:
    """The loader's library, built from the source on first use."""
    global _lib
    with _lock:
        if _lib is None:
            target = library_path()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            lib.npy_read_f32.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long]
            lib.npy_read_f32.restype = ctypes.c_int
            lib.gather_batch_f32.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int]
            lib.gather_batch_f32.restype = ctypes.c_int
            _lib = lib
        return _lib


def gather_frames(paths: list[str], frame_shape: tuple[int, ...],
                  n_threads: int = 8) -> np.ndarray:
    """Read N .npy frames (float32 or float64, all of `frame_shape`) into
    one (N, *frame_shape) float32 array with the native loader's threads."""
    n = len(paths)
    out = np.empty((n,) + tuple(frame_shape), np.float32)
    if n == 0:
        return out
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rc = get_lib().gather_batch_f32(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(np.prod(frame_shape)), n_threads)
    if rc != 0:
        # The loader reports the first failure's code, not its file: find it.
        one = np.empty(frame_shape, np.float32)
        for p in paths:
            code = get_lib().npy_read_f32(
                os.fsencode(p), one.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                one.size)
            if code == rc:
                break
        else:
            p = f"one of {n} files"
        raise OSError(f"native frame gather failed on {p}: "
                      f"{_CODES.get(rc, f'code {rc}')}")
    return out
