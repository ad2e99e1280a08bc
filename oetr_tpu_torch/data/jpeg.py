"""Image files without cv2: JPEG, PNG and PPM/PGM reading, JPEG writing,
and cv2's uint8 bilinear and nearest resizes.

JPEG goes through the port's own baseline codec (``data/jpeg_codec.cpp``,
integer arithmetic only), which g++ builds on first use into
``oetr_tpu_torch/_build/`` through ``ops/_build.build_once`` and ctypes
binds; it computes libjpeg-turbo's ISLOW IDCT, fancy upsampling and color
tables, so ``imread`` gives ``cv2.imread``'s pixels, and ``imwrite_jpeg``
gives ``cv2.imwrite``'s bytes at its defaults (quality 95, 4:2:0), the
only setting the dataset writers use. It
links no libjpeg. Progressive, arithmetic-coded, lossless, 12-bit and CMYK
JPEGs raise ValueError naming the file and the SOF marker. Where the codec
cannot be built, loading raises RuntimeError with the compiler's message;
nothing falls back to another decoder.

PNG (8-bit gray, gray + alpha, RGB, RGBA and palette, not interlaced) and
binary PPM/PGM (P6/P5, maxval 255) are read in numpy and stdlib ``zlib``;
``imwrite_pnm`` writes the latter as cv2 does.
``imread`` dispatches on the file's first bytes, as cv2 does, not on its
extension, and applies a JPEG's EXIF orientation as ``cv2.imread`` does.

Images are RGB here (cv2's are BGR): ``imread`` returns uint8 [H, W, 3] RGB
or [H, W] gray, and ``imwrite_jpeg`` takes the same.
"""
from __future__ import annotations

import ctypes
import os
import struct
import time
import zlib
from pathlib import Path

import numpy as np

from ..ops import _build

SRC = Path(__file__).resolve().with_name("jpeg_codec.cpp")
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-shared"]
_ERR_CAP = 256
_lib = None
_record: dict = {}

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def library_path() -> Path:
    return _build.host_library_path(SRC, "oetr_jpeg", CXX_FLAGS)


def load_codec():
    """The codec library (built if needed), argtypes set."""
    global _lib
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    built = not library_path().exists()
    lib = ctypes.CDLL(str(_build.build_host_library(SRC, "oetr_jpeg",
                                                    CXX_FLAGS)))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.oetr_jpeg_decode.restype = ctypes.c_int
    lib.oetr_jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.POINTER(u8p),
        i32p, i32p, i32p, ctypes.c_char_p, ctypes.c_size_t]
    lib.oetr_jpeg_encode.restype = ctypes.c_int
    lib.oetr_jpeg_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_char_p, ctypes.c_size_t]
    lib.oetr_jpeg_free.restype = None
    lib.oetr_jpeg_free.argtypes = [u8p]
    _record.update(so=str(library_path()), built=built,
                   load_s=time.perf_counter() - t0)
    _lib = lib
    return lib


def codec_record() -> dict:
    """The library's path, whether this process built it and the seconds
    that building (or finding) and loading it took; empty before the
    first load."""
    return dict(_record)


# ------------------------------------------------------------------ JPEG --

def decode_jpeg(data: bytes, grayscale: bool = False,
                name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3] RGB or [H, W] gray, before any EXIF
    orientation. Raises ValueError naming ``name`` and the reason."""
    lib = load_codec()
    data = bytes(data)
    out = ctypes.POINTER(ctypes.c_uint8)()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_CAP)
    rc = lib.oetr_jpeg_decode(data, len(data), int(grayscale),
                              ctypes.byref(out), ctypes.byref(h),
                              ctypes.byref(w), ctypes.byref(c), err, _ERR_CAP)
    if rc != 0:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    try:
        n = h.value * w.value * c.value
        img = np.frombuffer(ctypes.string_at(out, n), np.uint8)
    finally:
        lib.oetr_jpeg_free(out)
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, 3)
    return img.reshape(shape)


def encode_jpeg(img: np.ndarray) -> bytes:
    """uint8 [H, W, 3] RGB or [H, W] gray -> baseline JPEG bytes: those
    ``cv2.imencode(".jpg", bgr)`` gives at its defaults."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_jpeg: uint8 expected, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = np.ascontiguousarray(img[..., 0])
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg: [H, W] or [H, W, 3] expected, got "
                         f"{img.shape}")
    lib = load_codec()
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERR_CAP)
    c = 1 if img.ndim == 2 else 3
    rc = lib.oetr_jpeg_encode(img.ctypes.data, img.shape[0], img.shape[1], c,
                              ctypes.byref(out), ctypes.byref(n), err,
                              _ERR_CAP)
    if rc != 0:
        raise ValueError(f"encode_jpeg: {err.value.decode(errors='replace')}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.oetr_jpeg_free(out)


def imwrite_jpeg(path: str, img: np.ndarray) -> None:
    """Write ``img`` (RGB or gray uint8) as a JPEG file: the bytes of
    ``cv2.imwrite(path, bgr)``."""
    data = encode_jpeg(img)
    with open(path, "wb") as f:
        f.write(data)


def exif_orientation(data: bytes) -> int:
    """The EXIF orientation (1-8) cv2 reads from a JPEG: the first APP1
    segment before the scan, past its 6-byte header, parsed as TIFF (byte
    order, the 42 mark, IFD0's entries, tag 0x0112's first 16 bits); 1
    where any of that is missing or out of range."""
    p = 2
    n = len(data)
    while p + 4 <= n:
        if data[p] != 0xFF:
            return 1
        marker = data[p + 1]
        if marker == 0xFF:
            p += 1
            continue
        if marker in (0xD9, 0xDA):
            return 1
        length = struct.unpack(">H", data[p + 2:p + 4])[0]
        if marker == 0xE1:
            return _tiff_orientation(data[p + 4 + 6:p + 2 + length])
        p += 2 + length
    return 1


def _tiff_orientation(tiff: bytes) -> int:
    try:
        order = {b"II": "<", b"MM": ">"}[bytes(tiff[:2])]
        if struct.unpack(order + "H", tiff[2:4])[0] != 0x2A:
            return 1
        ifd = struct.unpack(order + "I", tiff[4:8])[0]
        count = struct.unpack(order + "H", tiff[ifd:ifd + 2])[0]
        for i in range(count):
            e = ifd + 2 + 12 * i
            if len(tiff) < e + 12:
                return 1
            if struct.unpack(order + "H", tiff[e:e + 2])[0] == 0x0112:
                o = struct.unpack(order + "H", tiff[e + 8:e + 10])[0]
                return o if 1 <= o <= 8 else 1
    except (KeyError, struct.error, IndexError):
        return 1
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ``ApplyExifOrientation``: flips and transposes of [H, W, ...]."""
    t = lambda a: np.swapaxes(a, 0, 1)
    ops = {1: lambda a: a,
           2: lambda a: a[:, ::-1],
           3: lambda a: a[::-1, ::-1],
           4: lambda a: a[::-1],
           5: t,
           6: lambda a: t(a)[:, ::-1],
           7: lambda a: t(a)[::-1, ::-1],
           8: lambda a: t(a)[::-1]}
    return np.ascontiguousarray(ops[orientation](img))


# ------------------------------------------------------------------- PNG --

def _gray_png(rgb: np.ndarray) -> np.ndarray:
    """libpng's ``png_set_rgb_to_gray(1, 0.299, 0.587)`` on 8-bit RGB (as
    cv2's gray read asks): 15-bit weights 9797/19234/3737, truncated."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)


def _unfilter(raw: bytes, h: int, w: int, bpp: int, name: str) -> np.ndarray:
    """Undo the five PNG row filters: [h, w * bpp] uint8."""
    stride = w * bpp
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{name}: truncated PNG image data")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:                       # Sub: running sum per channel
            cur = (np.cumsum(line.reshape(w, bpp).astype(np.uint64), axis=0)
                   % 256).astype(np.uint8).reshape(stride)
        elif ftype == 2:                       # Up
            cur = line + prior
        elif ftype in (3, 4):                  # Average, Paeth: left to right
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    cur[x] = (cur[x] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{name}: bad PNG filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes, grayscale: bool = False,
               name: str = "<bytes>") -> np.ndarray:
    """8-bit PNG bytes -> uint8 [H, W, 3] RGB (alpha dropped, palette
    expanded) or [H, W] gray, as ``cv2.imread`` gives them."""
    if data[:8] != PNG_MAGIC:
        raise ValueError(f"{name}: not a PNG")
    p, idat, plte, ihdr = 8, [], None, None
    while p + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[p:p + 8])
        body = data[p + 8:p + 8 + n]
        if len(body) != n or p + 12 + n > len(data):
            raise ValueError(f"{name}: truncated PNG chunk {kind!r}")
        crc = struct.unpack(">I", data[p + 8 + n:p + 12 + n])[0]
        if kind[0] & 0x20 == 0 and zlib.crc32(kind + body) != crc:
            raise ValueError(f"{name}: PNG chunk {kind!r} fails its CRC")
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        p += 12 + n
    if ihdr is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype)
    if channels is None:
        raise ValueError(f"{name}: bad PNG color type {ctype}")
    if depth != 8:
        raise ValueError(f"{name}: {depth}-bit PNG (only 8-bit is read)")
    if interlace:
        raise ValueError(f"{name}: interlaced (Adam7) PNG")
    raw = zlib.decompress(b"".join(idat))
    px = _unfilter(raw, h, w, channels, name).reshape(h, w, channels)
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        idx = px[..., 0]
        if idx.max(initial=0) >= len(plte):
            raise ValueError(f"{name}: PNG palette index out of range")
        px = plte[idx]
    elif ctype in (4, 6):
        px = px[..., :-1]                       # alpha stripped
    if px.shape[2] == 1:
        return px[..., 0] if grayscale else np.repeat(px, 3, axis=2)
    return _gray_png(px) if grayscale else np.ascontiguousarray(px)


# --------------------------------------------------------------- PPM/PGM --

def _gray_pnm(rgb: np.ndarray) -> np.ndarray:
    """cv2's gray read of a P6 file (``icvCvt_BGR2Gray_8u_C3C1R``): 14-bit
    weights 4899/9617/1868, rounded."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((4899 * r + 9617 * g + 1868 * b + 8192) >> 14).astype(np.uint8)


def decode_pnm(data: bytes, grayscale: bool = False,
               name: str = "<bytes>") -> np.ndarray:
    """Binary PGM (P5) or PPM (P6) bytes with maxval 255 -> uint8 [H, W, 3]
    RGB or [H, W] gray."""
    kind = data[:2]
    if kind not in (b"P5", b"P6"):
        raise ValueError(f"{name}: not a binary PGM/PPM ({kind!r})")
    fields, p = [], 2
    while len(fields) < 3:
        while p < len(data) and data[p:p + 1].isspace():
            p += 1
        if data[p:p + 1] == b"#":
            while p < len(data) and data[p:p + 1] not in (b"\n", b"\r"):
                p += 1
            continue
        q = p
        while q < len(data) and data[q:q + 1].isdigit():
            q += 1
        if q == p:
            raise ValueError(f"{name}: bad PGM/PPM header")
        fields.append(int(data[p:q]))
        p = q
    w, h, maxval = fields
    if maxval != 255:
        raise ValueError(f"{name}: PGM/PPM maxval {maxval} (only 255 is read)")
    p += 1                                      # one whitespace byte
    c = 3 if kind == b"P6" else 1
    px = np.frombuffer(data, np.uint8, h * w * c, p) if len(data) >= \
        p + h * w * c else None
    if px is None:
        raise ValueError(f"{name}: truncated PGM/PPM data")
    px = px.reshape(h, w, c)
    if c == 1:
        return px[..., 0].copy() if grayscale else np.repeat(px, 3, axis=2)
    return _gray_pnm(px) if grayscale else px.copy()


def imwrite_pnm(path: str, img: np.ndarray) -> None:
    """Write uint8 RGB [H, W, 3] as binary PPM (P6) or gray [H, W] as PGM
    (P5), with cv2's header layout."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"imwrite_pnm: uint8 [H, W(, 3)] expected, got "
                         f"{img.dtype} {img.shape}")
    kind = b"P6" if img.ndim == 3 else b"P5"
    with open(path, "wb") as f:
        f.write(kind + b"\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())


# ----------------------------------------------------------------- imread --

def imread(path: str, grayscale: bool = False) -> np.ndarray:
    """Read an image file as ``cv2.imread(path, IMREAD_COLOR or
    IMREAD_GRAYSCALE)`` does, in RGB: uint8 [H, W, 3] or [H, W]. The format
    comes from the file's first bytes. Raises FileNotFoundError for a
    missing file and ValueError, naming the file, for a format or feature
    this reader does not cover."""
    path = os.fspath(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        data = f.read()
    if data[:3] == b"\xff\xd8\xff":
        img = decode_jpeg(data, grayscale, path)
        o = exif_orientation(data)
        return apply_orientation(img, o) if o != 1 else img
    if data[:8] == PNG_MAGIC:
        return decode_png(data, grayscale, path)
    if data[:2] in (b"P5", b"P6"):
        return decode_pnm(data, grayscale, path)
    raise ValueError(f"{path}: unsupported image format (magic "
                     f"{data[:4]!r}); JPEG, PNG and binary PGM/PPM are read")


# ---------------------------------------------------------------- resizes --

def _linear_taps(src: int, dst: int):
    """cv2's INTER_LINEAR taps along one axis: source index and the 11-bit
    fixed-point weights of it and the next, from float32 offsets
    ``(d + 0.5) * scale - 0.5`` (clamped at the edges on x; on y cv2
    clamps the rows, not the weights)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    return s, f


def _fixed(f: np.ndarray):
    """(1 - f, f) as cv2's saturate_cast<short>(x * 2048): rounded to
    nearest even."""
    a0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    a1 = np.rint(f * np.float32(2048)).astype(np.int64)
    return a0, a1


def resize_linear_u8(img: np.ndarray, size_wh: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size_wh, interpolation=cv2.INTER_LINEAR)`` of a
    uint8 [H, W] or [H, W, C] image: cv2's fixed-point path (11-bit
    weights, rows summed as ``((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4))
    >> 16) + 2 >> 2``), and its 2x2 average where the image halves exactly
    on both axes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_linear_u8: uint8 expected, got {img.dtype}")
    h, w = img.shape[:2]
    dw, dh = int(size_wh[0]), int(size_wh[1])
    if (dw, dh) == (w, h):
        return img.copy()
    if w == 2 * dw and h == 2 * dh:             # cv2 takes INTER_AREA's path
        s = img.astype(np.uint32)
        return ((s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2]
                 + s[1::2, 1::2] + 2) >> 2).astype(np.uint8)
    sx, fx = _linear_taps(w, dw)
    edge = (sx < 0) | (sx >= w - 1)
    fx[edge] = 0
    sx = np.clip(sx, 0, w - 1)
    ax0, ax1 = _fixed(fx)
    x1 = np.minimum(sx + 1, w - 1)
    sy, fy = _linear_taps(h, dh)
    by0, by1 = _fixed(fy)
    y0 = np.clip(sy, 0, h - 1)
    y1 = np.clip(sy + 1, 0, h - 1)
    col = lambda a: a.reshape(-1, *[1] * (img.ndim - 2))
    row = lambda a: a.reshape(-1, *[1] * (img.ndim - 1))
    src = img.astype(np.int64)
    rows = src[:, sx] * col(ax0) + src[:, x1] * col(ax1)    # [h, dw, ...]
    s0, s1 = rows[y0] >> 4, rows[y1] >> 4
    out = (((row(by0) * s0) >> 16) + ((row(by1) * s1) >> 16) + 2) >> 2
    return out.astype(np.uint8)


def resize_nearest(img: np.ndarray, size_wh: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size_wh, interpolation=cv2.INTER_NEAREST)`` of an
    [H, W] or [H, W, C] array of any dtype: source index ``floor(d *
    src / dst)``, clamped."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    dw, dh = int(size_wh[0]), int(size_wh[1])
    ix = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / w))).astype(
        np.int64), w - 1)
    iy = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / h))).astype(
        np.int64), h - 1)
    return np.ascontiguousarray(img[iy][:, ix])
