"""Zstandard decoding for the checkpoint reader: a ctypes binding to the
port's own decoder (``interop/zstd_decode.cpp``, RFC 8878, decode only).

On first use g++ compiles the source into the port's git-ignored build
directory (``oetr_tpu_torch/_build/``, the library named by a hash of the
source and flags) through ``ops/_build.build_once``, as
``data/native.py`` builds the data service. Where it cannot be built,
loading raises RuntimeError with the compiler's message; nothing falls
back to another decoder.
"""
from __future__ import annotations

import ctypes
import time
from pathlib import Path

from ..ops import _build

SRC = Path(__file__).resolve().with_name("zstd_decode.cpp")
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-shared"]
_ERR_CAP = 512
_lib = None
_record: dict = {}


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    return _build.host_library_path(SRC, "oetr_zstd", CXX_FLAGS)


def build_decoder() -> Path:
    """Compile the decoder (once). Returns the library's path; raises
    RuntimeError with the compiler's message where it cannot be built."""
    return _build.build_host_library(SRC, "oetr_zstd", CXX_FLAGS)


def load_decoder():
    """The decoder library (built if needed), argtypes set."""
    global _lib
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    built = not library_path().exists()
    lib = ctypes.CDLL(str(build_decoder()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    size = ctypes.c_size_t
    lib.oetr_zstd_decompress.restype = ctypes.c_int
    lib.oetr_zstd_decompress.argtypes = [
        ctypes.c_char_p, size, size, ctypes.POINTER(u8p),
        ctypes.POINTER(size), ctypes.c_char_p, size]
    lib.oetr_zstd_free.restype = None
    lib.oetr_zstd_free.argtypes = [u8p]
    lib.oetr_crc32c.restype = ctypes.c_uint32
    lib.oetr_crc32c.argtypes = [ctypes.c_char_p, size]
    _record.update(so=str(library_path()), built=built,
                   load_s=time.perf_counter() - t0)
    _lib = lib
    return lib


def decoder_record() -> dict:
    """The library's path, whether this process built it and the seconds
    that building (or finding) and loading it took; empty before the
    first load."""
    return dict(_record)


def decompress(data: bytes, max_out: int | None = None) -> bytes:
    """The bytes of the zstd frames in ``data`` (one or more, skippable
    frames skipped). Raises ValueError with the decoder's reason on a bad
    magic, a truncated or corrupt frame, a dictionary, a checksum that does
    not match or an output above ``max_out`` bytes."""
    lib = load_decoder()
    data = bytes(data)
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERR_CAP)
    limit = (1 << 63) if max_out is None else int(max_out)
    rc = lib.oetr_zstd_decompress(data, len(data), limit, ctypes.byref(out),
                                  ctypes.byref(n), err, _ERR_CAP)
    if rc != 0:
        raise ValueError(f"zstd: {err.value.decode(errors='replace')}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.oetr_zstd_free(out)


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    data = bytes(data)
    return int(load_decoder().oetr_crc32c(data, len(data)))
