"""ctypes binding to the native C++ data service (``native/libodsdata.so``,
built from ``native/dataservice.cpp`` by ``make -C native``): threaded JPEG
decode and image preparation giving the arrays of
``data/images.py::prepare_image``.

The port's own binding of the library the JAX package binds; it builds the
library on first use with g++ and libjpeg. ``load_native`` returns None
where it cannot be built or loaded, and ``run_benchmark(use_native=True)``
then reads images in Python (host input, not the device's path).
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libodsdata.so")
_lib = None


def build_native(force: bool = False) -> str:
    """Compile native/libodsdata.so (make). Returns the library path."""
    if force or not os.path.exists(_LIB_PATH):
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True)
    return _LIB_PATH


def load_native():
    """The library (built if needed), or None if it cannot be had."""
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(build_native())
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.ods_jpeg_shape.restype = ctypes.c_int
    lib.ods_jpeg_shape.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    i, vp = ctypes.c_int, ctypes.c_void_p
    lib.ods_decode_jpeg.restype = i
    lib.ods_decode_jpeg.argtypes = [ctypes.c_char_p, ctypes.c_long, vp, i, i]
    lib.ods_prepare_image.restype = i
    lib.ods_prepare_image.argtypes = [ctypes.c_char_p, i, i, i, i, i,
                                      vp, vp, vp, vp, vp]
    lib.ods_prepare_batch.restype = i
    lib.ods_prepare_batch.argtypes = [ctypes.c_char_p, i, i, i, i, i, i, i,
                                      vp, vp, vp, vp, vp]
    _lib = lib
    return lib


def native_available() -> bool:
    return load_native() is not None


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> RGB uint8 [H, W, 3]."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("native data service unavailable")
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.ods_jpeg_shape(data, len(data), ctypes.byref(h),
                          ctypes.byref(w)) != 0:
        raise ValueError("not a JPEG")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.ods_decode_jpeg(data, len(data),
                             out.ctypes.data_as(ctypes.c_void_p),
                             h.value, w.value)
    if rc != 0:
        raise ValueError(f"decode failed rc={rc}")
    return out


def prepare_batch_native(paths: list[str], canvas_hw: tuple[int, int],
                         oetr_hw: tuple[int, int] = (640, 640),
                         resize_max: int | None = 1024,
                         n_threads: int = 0) -> dict:
    """Threaded batch preparation: canvas [N, H, W, 3] f32, valid_hw
    [N, 2] i32, oetr_image [N, h, w, 3] f32, oetr_scale [N, 2] f32 and
    scale_to_orig [N, 2] f32."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("native data service unavailable")
    n = len(paths)
    ch, cw = canvas_hw
    oh, ow = oetr_hw
    out = {"canvas": np.empty((n, ch, cw, 3), np.float32),
           "valid_hw": np.empty((n, 2), np.int32),
           "oetr_image": np.empty((n, oh, ow, 3), np.float32),
           "oetr_scale": np.empty((n, 2), np.float32),
           "scale_to_orig": np.empty((n, 2), np.float32)}
    blob = b"".join(p.encode() + b"\x00" for p in paths)
    failures = lib.ods_prepare_batch(
        blob, n, ch, cw, oh, ow,
        -1 if resize_max is None else resize_max, n_threads,
        *(out[k].ctypes.data_as(ctypes.c_void_p)
          for k in ("canvas", "valid_hw", "oetr_image", "oetr_scale",
                    "scale_to_orig")))
    if failures:
        raise RuntimeError(f"{failures}/{n} images failed to load")
    return out
