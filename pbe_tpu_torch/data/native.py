"""ctypes bindings for the C++ data-path helpers (port of
``pbe_tpu/data/native.py``).

``native/pbe_native.cpp`` (Bézier evaluation, polygon fill, mask bbox) is
compiled with ``native/Makefile``'s flags into this package's git-ignored
build directory (``csrc/build/libpbe_native-<hash>.so``, keyed on the
source and the flags) at first use; ``native/`` itself is only read. Where
no C++ compiler exists every entry point has a numpy fallback in
``masks.py``, and :func:`available` says which path runs. This is host-side
mask geometry, not a device kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "pbe_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "build"
_CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(_CXXFLAGS).encode())
    return _BUILD_DIR / f"libpbe_native-{h.hexdigest()[:16]}.so"


def _build() -> Path | None:
    """Compile the source unless this source's library exists; None when
    there is no source or no compiler, or the compile fails."""
    if not _SOURCE.exists():
        return None
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if cxx is None:
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a name of its own per process: test workers may build side by side
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run([cxx, *_CXXFLAGS, "-o", str(tmp), str(_SOURCE)], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        dptr = ctypes.POINTER(ctypes.c_double)
        u8ptr = ctypes.POINTER(ctypes.c_uint8)
        iptr = ctypes.POINTER(ctypes.c_int)
        lib.pbe_bezier_eval.argtypes = [dptr, ctypes.c_int, ctypes.c_int, dptr]
        lib.pbe_bezier_eval.restype = None
        lib.pbe_fill_polygon.argtypes = [dptr, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8ptr]
        lib.pbe_fill_polygon.restype = None
        lib.pbe_mask_bbox.argtypes = [u8ptr, ctypes.c_int, ctypes.c_int, iptr]
        lib.pbe_mask_bbox.restype = None
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def bezier_eval(ctrl: np.ndarray, n: int) -> np.ndarray | None:
    """(K,2) control points -> (n,2) curve, or None if native unavailable."""
    lib = _load()
    if lib is None:
        return None
    ctrl = np.ascontiguousarray(ctrl, np.float64)
    if ctrl.ndim != 2 or ctrl.shape[1] != 2 or ctrl.shape[0] < 1 or n < 1:
        raise ValueError(f"bezier_eval wants (K>=1, 2) points and n >= 1, got "
                         f"{ctrl.shape} and {n}")
    out = np.empty((n, 2), np.float64)
    lib.pbe_bezier_eval(ctrl.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                        ctrl.shape[0] - 1, n,
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def fill_polygon(poly_xy: np.ndarray, h: int, w: int) -> np.ndarray | None:
    """(N,2) x,y vertices -> (h,w) uint8 {0,1} filled polygon, or None if
    native unavailable."""
    lib = _load()
    if lib is None:
        return None
    poly = np.ascontiguousarray(poly_xy, np.float64)
    if poly.ndim != 2 or poly.shape[1] != 2:
        raise ValueError(f"fill_polygon wants (N, 2) vertices, got {poly.shape}")
    out = np.zeros((h, w), np.uint8)
    lib.pbe_fill_polygon(poly.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                         poly.shape[0], h, w,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def mask_bbox(mask01: np.ndarray) -> tuple[int, int, int, int] | None:
    """Returns (x1,y1,x2,y2), None for an empty mask, or raises if
    unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    m = np.ascontiguousarray((np.asarray(mask01) > 0.5).astype(np.uint8))
    if m.ndim != 2:
        raise ValueError(f"mask_bbox wants an (H, W) mask, got {m.shape}")
    out = np.empty(4, np.int32)
    lib.pbe_mask_bbox(m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), m.shape[0], m.shape[1],
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if out[0] < 0:
        return None
    return int(out[0]), int(out[1]), int(out[2]), int(out[3])
