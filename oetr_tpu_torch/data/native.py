"""ctypes binding to the native C++ data service (``native/dataservice.cpp``):
threaded JPEG decode and image preparation giving the arrays of
``data/images.py::prepare_image``.

The port's own binding of the library the JAX package binds. On first use
it compiles ``native/dataservice.cpp`` with the flags of ``native/Makefile``
into the port's git-ignored build directory (``oetr_tpu_torch/_build/``,
the library named by a hash of the source and flags), through
``ops/_build.build_once``: under a lock, into a fresh directory, then moved
into place, so processes that start together all load one whole library.
Nothing is written under ``native/``. ``load_native`` returns None where
the library cannot be built or loaded, and ``native_error`` says why;
``run_benchmark(use_native=True)`` then raises with that reason.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import subprocess
from pathlib import Path

import numpy as np

from ..ops import _build

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "dataservice.cpp"
# native/Makefile's CXXFLAGS and LDFLAGS.
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]
LD_FLAGS = ["-shared", "-ljpeg", "-lpthread"]
_lib = None
_error = None


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    h.update(NATIVE_SRC.read_bytes())
    return _build.BUILD_DIR / f"libodsdata_{h.hexdigest()[:16]}.so"


def build_native() -> Path:
    """Compile the data service (once; ``ops/_build.build_once``). Returns
    the library's path; raises RuntimeError with the compiler's message
    where it cannot be built."""
    lib = library_path()
    cxx = shlex.split(os.environ.get("CXX", "g++"))

    def build(work: Path) -> None:
        cmd = [*cxx, *CXX_FLAGS, str(NATIVE_SRC), "-o", str(work / lib.name),
               *LD_FLAGS]
        try:
            p = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"{cmd[0]}: {e}") from e
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{p.stderr}")

    _build.build_once([lib], build)
    return lib


def load_native():
    """The library (built if needed), or None if it cannot be had
    (``native_error`` says why)."""
    global _lib, _error
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build_native()))
    except (OSError, RuntimeError) as e:
        _error = str(e)
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
    _lib, _error = lib, None
    return lib


def native_error() -> str | None:
    """Why the last ``load_native`` found no library, or None."""
    return _error


def native_available() -> bool:
    return load_native() is not None


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> RGB uint8 [H, W, 3]."""
    lib = load_native()
    if lib is None:
        raise RuntimeError(f"native data service unavailable: {_error}")
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
        raise RuntimeError(f"native data service unavailable: {_error}")
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
