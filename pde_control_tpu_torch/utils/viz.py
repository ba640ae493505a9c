"""Field visualization: PNG dumps + TensorBoard images.

Counterpart of `pde_control_tpu/utils/viz.py`, with the same functions
and file names, written without matplotlib: fields are mapped through a
viridis table (17 anchors, linear in between) and written as 8-bit RGB
PNGs with `zlib` and `struct`. 2D fields are drawn with row 0 at the
bottom (matplotlib's origin="lower"), several panels side by side on one
color scale, each panel scaled up by a whole factor to at least 128
pixels. Titles and colorbars are left out. 1D fields are drawn as a
curve (one pixel per sample).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_VIRIDIS = np.array(
    [[68, 1, 84], [72, 24, 106], [71, 45, 123], [66, 64, 134], [59, 82, 139],
     [51, 99, 141], [44, 114, 142], [38, 130, 142], [33, 145, 140],
     [31, 160, 136], [40, 174, 128], [63, 188, 115], [94, 201, 98],
     [132, 212, 75], [173, 220, 48], [216, 226, 25], [253, 231, 37]],
    np.float64)
_GAP = 4          # background pixels between panels
_MIN_SIDE = 128   # panels are scaled up to at least this many pixels
_CURVE_H = 96     # height of a 1D field's plot


def _colorize(field: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """(H, W) → (H, W, 3) uint8 through the viridis table."""
    t = (np.asarray(field, np.float64) - lo) / (hi - lo if hi > lo else 1.0)
    t = np.clip(np.nan_to_num(t), 0.0, 1.0) * (len(_VIRIDIS) - 1)
    i = np.minimum(t.astype(np.int64), len(_VIRIDIS) - 2)
    f = (t - i)[..., None]
    rgb = _VIRIDIS[i] * (1 - f) + _VIRIDIS[i + 1] * f
    return np.round(rgb).astype(np.uint8)


def _panel(field: np.ndarray, lo: float, hi: float) -> np.ndarray:
    img = _colorize(field[::-1], lo, hi)  # row 0 at the bottom
    scale = max(1, -(-_MIN_SIDE // max(field.shape)))
    return img.repeat(scale, axis=0).repeat(scale, axis=1)


def _curve(curves: list[np.ndarray]) -> np.ndarray:
    """1D fields as curves on one white canvas, one color each."""
    n = max(len(c) for c in curves)
    lo = min(float(np.min(c)) for c in curves)
    hi = max(float(np.max(c)) for c in curves)
    img = np.full((_CURVE_H, n, 3), 255, np.uint8)
    for k, c in enumerate(curves):
        color = _colorize(np.array([[k / max(len(curves) - 1, 1)]]), 0, 1)[0, 0]
        rows = (_CURVE_H - 1) - np.round(
            (np.asarray(c, np.float64) - lo) / (hi - lo if hi > lo else 1.0)
            * (_CURVE_H - 1)).astype(np.int64)
        img[np.clip(rows, 0, _CURVE_H - 1), np.arange(len(c))] = color
    return img


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xffffffff))

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def _mid_slice(a: np.ndarray) -> np.ndarray:
    return a[a.shape[0] // 2] if a.ndim == 3 else a


def save_field_png(field: np.ndarray, path: str, title: str | None = None,
                   cmap: str = "viridis") -> None:
    """Render a 2D field (H, W) or a 1D field (N,) to a PNG (a volume:
    its mid-depth slice). `title` and `cmap` are accepted for the JAX
    package's signature; no title is drawn and the map is viridis."""
    field = _mid_slice(np.asarray(field))
    if field.ndim == 1:
        write_png(path, _curve([field]))
    else:
        write_png(path, _panel(field, float(field.min()), float(field.max())))


def save_trajectory_strip(frames: np.ndarray, path: str, every: int = 1,
                          cmap: str = "viridis") -> None:
    """Render a (T, H, W) trajectory as a horizontal strip of frames on
    one color scale."""
    frames = np.asarray(frames)[::every]
    lo, hi = float(frames.min()), float(frames.max())
    _write_row(path, [_panel(fr, lo, hi) for fr in frames])


def save_comparison_png(fields: dict[str, np.ndarray], path: str,
                        cmap: str = "viridis") -> None:
    """Render named fields side by side (2D images on a shared color scale,
    or 1D curves on one canvas) — the training-progress view."""
    arrays = [_mid_slice(np.asarray(v)) for v in fields.values()]
    if arrays[0].ndim == 1:
        write_png(path, _curve(arrays))
        return
    lo = min(float(a.min()) for a in arrays)
    hi = max(float(a.max()) for a in arrays)
    _write_row(path, [_panel(a, lo, hi) for a in arrays])


def _write_row(path: str, panels: list[np.ndarray]) -> None:
    h = max(p.shape[0] for p in panels)
    w = sum(p.shape[1] for p in panels) + _GAP * (len(panels) - 1)
    img = np.full((h, w, 3), 255, np.uint8)
    x = 0
    for p in panels:
        img[:p.shape[0], x:x + p.shape[1]] = p
        x += p.shape[1] + _GAP
    write_png(path, img)


def tb_image(logger, tag: str, field: np.ndarray, step: int) -> None:
    """Log a 2D field image to the MetricsLogger's TensorBoard writer."""
    tb = getattr(logger, "_tb", None)
    if tb is None:
        return
    f = np.asarray(field, np.float32)
    lo, hi = float(f.min()), float(f.max())
    norm = (f - lo) / (hi - lo + 1e-12)
    tb.add_image(tag, norm[None], step)  # (1, H, W) grayscale
