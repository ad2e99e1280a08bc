"""The port's own image and HDF5 I/O against cv2 and h5py, on the CPU.

``data/jpeg.py`` and its codec (``data/jpeg_codec.cpp``) must give
``cv2.imread``'s pixels in every listed JPEG mode (sampling 4:4:4, 4:2:2,
4:4:0, 4:2:0, 4:1:1; gray files and gray reads; restart intervals;
qualities 50/75/95/100; odd sizes; EXIF orientations 1-8 in both byte
orders; SOF1; 16-bit DQT; optimized Huffman tables) and
``cv2.imwrite``'s bytes at its defaults; PNG (gray, RGB, RGBA, gray +
alpha, palette, each of the five row filters) and PPM/PGM reads equal
cv2's; ``resize_linear_u8`` and ``resize_nearest`` equal ``cv2.resize``.
``utils/hdf5.py`` reads h5py's files (every dtype, scalars, ``[2, 0]``,
chunked with gzip and shuffle, ``libver`` earliest and latest) and h5py
reads the port's, both equal. Every refused feature raises, naming the
file. All bounds are exact.
"""
import hashlib
import os
import struct
import zlib

import cv2
import h5py
import numpy as np
import pytest

import chip_smoke
from oetr_tpu_torch.data import jpeg
from oetr_tpu_torch.utils import hdf5


def _texture(seed, h, w, c=3):
    """Smooth waves plus noise: blocks with both DC and AC energy."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    wave = np.sin(xx / 7.0)[..., None] * np.cos(yy / 5.0)[..., None]
    img = 128 + 60 * wave + rng.normal(0, 25, (h, w, c))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img if c == 3 else img[..., 0]


def _cv2_read(data: bytes, gray: bool) -> np.ndarray:
    img = cv2.imdecode(np.frombuffer(data, np.uint8),
                       cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    return img if gray else img[..., ::-1]


def _cv2_jpeg(img, **params) -> bytes:
    flags = {"quality": cv2.IMWRITE_JPEG_QUALITY,
             "sampling": cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
             "restart": cv2.IMWRITE_JPEG_RST_INTERVAL,
             "optimize": cv2.IMWRITE_JPEG_OPTIMIZE,
             "progressive": cv2.IMWRITE_JPEG_PROGRESSIVE}
    args = [x for k, v in params.items() for x in (flags[k], v)]
    bgr = img[..., ::-1] if img.ndim == 3 else img
    ok, buf = cv2.imencode(".jpg", bgr, args)
    assert ok
    return buf.tobytes()


def _same_decode(data: bytes):
    for gray in (False, True):
        want = _cv2_read(data, gray)
        got = jpeg.decode_jpeg(data, gray)
        assert got.shape == want.shape, (gray, got.shape, want.shape)
        assert np.array_equal(got, want), (
            gray, np.abs(got.astype(int) - want.astype(int)).max())


# ------------------------------------------------------------ JPEG decode --

SIZES = [(8, 8), (16, 16), (17, 23), (1, 1), (3, 5), (33, 2), (2, 33),
         (100, 77), (64, 129)]
SAMPLING = {"420": 0x221111, "422": 0x211111, "440": 0x121111,
            "444": 0x111111, "411": 0x411111}


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_decode_sampling_matches_cv2(size, sampling):
    img = _texture(1, *size)
    for q in (50, 95):
        _same_decode(_cv2_jpeg(img, quality=q, sampling=SAMPLING[sampling]))


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("channels", [1, 3])
def test_decode_quality_matches_cv2(quality, channels):
    for size in ((97, 131), (480, 640)):
        _same_decode(_cv2_jpeg(_texture(2, *size, c=channels),
                               quality=quality))


@pytest.mark.parametrize("restart", [1, 3, 17])
@pytest.mark.parametrize("sampling", ["420", "422", "440", "444"])
def test_decode_restart_intervals_match_cv2(restart, sampling):
    data = _cv2_jpeg(_texture(3, 97, 131), quality=75, restart=restart,
                     sampling=SAMPLING[sampling])
    assert b"\xff\xdd" in data
    _same_decode(data)


def test_decode_optimized_huffman_matches_cv2():
    _same_decode(_cv2_jpeg(_texture(4, 61, 93), optimize=1))


def _segments(data: bytes):
    """(marker, body) of each segment before the scan, then the rest."""
    p, out = 2, []
    while True:
        m = data[p + 1]
        n = struct.unpack(">H", data[p + 2:p + 4])[0]
        out.append((m, data[p + 4:p + 2 + n]))
        if m == 0xDA:
            return out, data[p + 2 + n:]
        p += 2 + n


def _join(segments, rest):
    return b"\xff\xd8" + b"".join(
        b"\xff" + bytes([m]) + struct.pack(">H", len(b) + 2) + b
        for m, b in segments) + rest


def test_decode_sof1_and_16bit_tables_match_cv2():
    data = _cv2_jpeg(_texture(5, 45, 70), quality=90)
    segs, rest = _segments(data)
    sof1 = [(0xC1 if m == 0xC0 else m, b) for m, b in segs]
    wide = []
    for m, b in segs:
        if m == 0xDB:                          # one table a segment here
            b = bytes([0x10 | b[0]]) + b"".join(
                struct.pack(">H", v) for v in b[1:65])
        wide.append((m, b))
    for variant in (_join(sof1, rest), _join(wide, rest)):
        assert variant != data
        _same_decode(variant)


def _with_exif(data: bytes, orientation: int, order: bytes) -> bytes:
    f = "<" if order == b"II" else ">"
    tiff = (order + struct.pack(f + "HI", 42, 8) + struct.pack(f + "H", 1)
            + struct.pack(f + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(f + "I", 0))
    app1 = b"Exif\0\0" + tiff
    return (data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1
            + data[2:])


@pytest.mark.parametrize("orientation", range(0, 10))
@pytest.mark.parametrize("order", [b"II", b"MM"], ids=["intel", "motorola"])
def test_imread_applies_exif_orientation_as_cv2(tmp_path, orientation,
                                                order):
    """Orientations 1-8 written by hand in an APP1 segment (0 and 9 are
    out of range: no rotation), through ``imread`` against ``cv2.imread``
    in both modes."""
    path = str(tmp_path / "o.jpg")
    with open(path, "wb") as f:
        f.write(_with_exif(_cv2_jpeg(_texture(6, 37, 58)), orientation,
                           order))
    for gray in (False, True):
        want = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray
                          else cv2.IMREAD_COLOR)
        want = want if gray else want[..., ::-1]
        got = jpeg.imread(path, gray)
        assert got.shape == want.shape and np.array_equal(got, want)


# ------------------------------------------------------------ JPEG encode --

@pytest.mark.parametrize("size", SIZES + [(480, 640), (640, 640)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("channels", [1, 3])
def test_encode_equals_cv2_imwrite_bytes(tmp_path, size, channels):
    img = _texture(7, *size, c=channels)
    got = str(tmp_path / "p.jpg")
    want = str(tmp_path / "c.jpg")
    jpeg.imwrite_jpeg(got, img)
    cv2.imwrite(want, img[..., ::-1] if channels == 3 else img)
    assert open(got, "rb").read() == open(want, "rb").read()


@pytest.mark.parametrize("quality", [50, 75, 100])
def test_reencode_equals_cv2(quality):
    """A file cv2 wrote at ``quality``, decoded (blocky, ringing content)
    and written again at the defaults: cv2's bytes."""
    img = jpeg.decode_jpeg(_cv2_jpeg(_texture(8, 71, 103), quality=quality))
    assert jpeg.encode_jpeg(img) == _cv2_jpeg(img)


def test_codec_probe_digests():
    """The digests the card's phase holds its host's codec to:
    ``chip_smoke.codec_probe_image()`` encoded (cv2's bytes) and decoded
    back (cv2's pixels), both confirmed by cv2 here."""
    img = chip_smoke.codec_probe_image()
    data = jpeg.encode_jpeg(img)
    assert data == _cv2_jpeg(img)
    pixels = jpeg.decode_jpeg(data)
    assert np.array_equal(pixels, _cv2_read(data, False))
    assert hashlib.sha256(data).hexdigest() == \
        chip_smoke.CODEC_DIGESTS["probe_bytes"]
    assert hashlib.sha256(pixels.tobytes()).hexdigest() == \
        chip_smoke.CODEC_DIGESTS["probe_pixels"]


def test_first_scene_image_digests():
    """The first image the card's phase writes (``generate_scene_3d`` at
    its size and seed): the render's pixels, the encoder's bytes and the
    decoder's pixels, cv2 confirming the last two."""
    import tempfile

    from oetr_tpu_torch.data import synthetic

    renders = []
    render = synthetic._render_planes

    def recorded(*args, **kwargs):
        renders.append(render(*args, **kwargs))
        return renders[-1]

    with tempfile.TemporaryDirectory() as base:
        synthetic._render_planes = recorded
        try:
            synthetic.generate_scene_3d(base, n_pairs=1,
                                        **chip_smoke.EVAL_SCENE_KW)
        finally:
            synthetic._render_planes = render
        data = open(os.path.join(base, "imgs", "a0.jpg"), "rb").read()
    assert hashlib.sha256(renders[0][0].tobytes()).hexdigest() == \
        chip_smoke.CODEC_DIGESTS["scene_render"]
    pixels = jpeg.decode_jpeg(data)
    assert np.array_equal(pixels, _cv2_read(data, False))
    assert jpeg.encode_jpeg(_cv2_read(data, False)) == _cv2_jpeg(
        _cv2_read(data, False))
    assert hashlib.sha256(data).hexdigest() == \
        chip_smoke.CODEC_DIGESTS["scene_bytes"]
    assert hashlib.sha256(pixels.tobytes()).hexdigest() == \
        chip_smoke.CODEC_DIGESTS["scene_pixels"]


# ---------------------------------------------------------------- refusals --

def _patched(data: bytes, marker: int, body=None) -> bytes:
    segs, rest = _segments(data)
    out = []
    for m, b in segs:
        if m == 0xC0:
            m, b = marker, (b if body is None else body(b))
        out.append((m, b))
    return _join(out, rest)


REFUSED = {
    "progressive": (lambda d: _cv2_jpeg(_texture(9, 40, 40), progressive=1),
                    "progressive JPEG (SOF2)"),
    "arithmetic": (lambda d: _patched(d, 0xC9), "arithmetic-coded JPEG "
                   "(SOF9)"),
    "lossless": (lambda d: _patched(d, 0xC3), "lossless JPEG (SOF3)"),
    "hierarchical": (lambda d: _patched(d, 0xC5), "hierarchical JPEG (SOF5)"),
    "12bit": (lambda d: _patched(d, 0xC1, lambda b: b"\x0c" + b[1:]),
              "12-bit precision (SOF1)"),
    "cmyk": (lambda d: _patched(d, 0xC0, lambda b: b[:5] + b"\x04" + b[6:]
                                + b"\x04\x11\x00"),
             "4-component (CMYK/YCCK) JPEG (SOF0)"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_decoder_refuses_naming_file_and_marker(tmp_path, case):
    make, reason = REFUSED[case]
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(make(_cv2_jpeg(_texture(9, 40, 40))))
    with pytest.raises(ValueError) as e:
        jpeg.imread(str(path))
    assert str(path) in str(e.value) and reason in str(e.value)


def test_imread_refuses_other_formats(tmp_path):
    cv2.imwrite(str(tmp_path / "a.bmp"), _texture(10, 8, 8))
    with pytest.raises(ValueError, match="unsupported image format"):
        jpeg.imread(str(tmp_path / "a.bmp"))
    with pytest.raises(FileNotFoundError):
        jpeg.imread(str(tmp_path / "missing.jpg"))
    img16 = (np.arange(64, dtype=np.uint16) * 1000).reshape(8, 8)
    cv2.imwrite(str(tmp_path / "d.png"), img16)
    with pytest.raises(ValueError, match="16-bit PNG"):
        jpeg.imread(str(tmp_path / "d.png"))
    (tmp_path / "m.pgm").write_bytes(b"P5\n2 2\n65535\n" + bytes(8))
    with pytest.raises(ValueError, match="maxval 65535"):
        jpeg.imread(str(tmp_path / "m.pgm"))


# -------------------------------------------------------------- PNG / PNM --

def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _write_png(path, px, ctype, filters, plte=None):
    """An 8-bit PNG whose row y uses ``filters[y % len(filters)]``."""
    h, w = px.shape[:2]
    bpp = 1 if px.ndim == 2 else px.shape[2]
    rows = px.reshape(h, w * bpp).astype(int)
    raw, prior = bytearray(), np.zeros(w * bpp, int)
    for y in range(h):
        f, cur, line = filters[y % len(filters)], rows[y], []
        for x in range(w * bpp):
            a = cur[x - bpp] if x >= bpp else 0
            b = prior[x]
            c = prior[x - bpp] if x >= bpp else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][f]
            line.append((cur[x] - pred) & 255)
        raw += bytes([f]) + bytes(line)
        prior = cur
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if plte is not None:
        data += _chunk(b"PLTE", plte.tobytes())
    data += _chunk(b"IDAT", zlib.compress(bytes(raw))) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


def _same_read(path):
    for gray in (False, True):
        want = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray
                          else cv2.IMREAD_COLOR)
        want = want if gray else want[..., ::-1]
        got = jpeg.imread(path, gray)
        assert got.shape == want.shape and np.array_equal(got, want), gray


PNG_TYPES = {"gray": (0, 1), "rgb": (2, 3), "rgba": (6, 4),
             "gray_alpha": (4, 2), "palette": (3, 1)}


@pytest.mark.parametrize("ctype", sorted(PNG_TYPES))
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4],
                                     [0, 1, 2, 3, 4]],
                         ids=["none", "sub", "up", "average", "paeth",
                              "mixed"])
def test_png_matches_cv2(tmp_path, ctype, filters):
    rng = np.random.default_rng(11)
    code, c = PNG_TYPES[ctype]
    plte = None
    if code == 3:
        plte = rng.integers(0, 256, (20, 3), dtype=np.uint8)
        px = rng.integers(0, 20, (13, 17), dtype=np.uint8)
    else:
        px = rng.integers(0, 256, (13, 17, c), dtype=np.uint8)
        px = px[..., 0] if c == 1 else px
    path = str(tmp_path / "t.png")
    _write_png(path, px, code, filters, plte)
    _same_read(path)


def test_cv2_written_png_ppm_pgm_match_cv2(tmp_path):
    img = _texture(12, 50, 61)
    for name, data in (("a.png", img[..., ::-1]), ("a.ppm", img[..., ::-1]),
                       ("a.pgm", img[..., 0])):
        cv2.imwrite(str(tmp_path / name), data)
        _same_read(str(tmp_path / name))
    jpeg.imwrite_pnm(str(tmp_path / "p.ppm"), img)
    assert (tmp_path / "p.ppm").read_bytes() == (tmp_path /
                                                 "a.ppm").read_bytes()
    jpeg.imwrite_pnm(str(tmp_path / "p.pgm"), img[..., 0])
    assert (tmp_path / "p.pgm").read_bytes() == (tmp_path /
                                                 "a.pgm").read_bytes()


def test_imread_dispatches_on_magic_not_extension(tmp_path):
    img = _texture(13, 20, 30)
    (tmp_path / "jpeg.png").write_bytes(_cv2_jpeg(img))
    cv2.imwrite(str(tmp_path / "png.jpg.tmp.png"), img)
    os.replace(tmp_path / "png.jpg.tmp.png", tmp_path / "png.jpg")
    for name in ("jpeg.png", "png.jpg"):
        _same_read(str(tmp_path / name))


# --------------------------------------------------------------- resizes --

RESIZE_SRC = [(97, 131), (64, 64), (480, 640), (5, 3), (1, 7)]


@pytest.mark.parametrize("src", RESIZE_SRC, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("channels", [1, 3])
def test_resizes_match_cv2(src, channels):
    h, w = src
    img = _texture(14, h, w, c=channels)
    depth = np.random.default_rng(15).uniform(0, 10, (h, w)).astype(
        np.float32)
    sizes = [(w // 2, h // 2), (w * 2, h * 2), (w + 3, max(h - 1, 1)),
             (37, 41), (w, h), (int(w * 1.37), max(int(h * 0.61), 1)),
             (320, 240), (1, 1)]
    for dw, dh in (s for s in sizes if min(s) >= 1):
        want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR)
        assert np.array_equal(jpeg.resize_linear_u8(img, (dw, dh)), want)
        want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_NEAREST)
        assert np.array_equal(jpeg.resize_nearest(img, (dw, dh)), want)
        want = cv2.resize(depth, (dw, dh), interpolation=cv2.INTER_NEAREST)
        assert np.array_equal(jpeg.resize_nearest(depth, (dw, dh)), want)


# ------------------------------------------------------------------ HDF5 --

DTYPES = ["<i1", "<i2", "<i4", "<i8", "<u1", "<u2", "<u4", "<u8", "<f2",
          "<f4", "<f8", ">i4", ">f8", ">u2", ">f4"]


def _arrays():
    rng = np.random.default_rng(16)
    out = {f"a_{dt[1:]}_{'be' if dt[0] == '>' else 'le'}":
           rng.normal(0, 100, (5, 7)).astype(dt) for dt in DTYPES}
    out.update(scalar=np.float64(0.7), scalar_i=np.int64(-3),
               empty=np.zeros((2, 0), np.int64),
               empty1=np.zeros((0,), np.float32),
               big=rng.normal(size=(300, 201)).astype(np.float32),
               vec=np.arange(6.0))
    return out


def _equal(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype.newbyteorder("=")
    assert np.array_equal(got, want)


@pytest.mark.parametrize("chunked", [False, True])
def test_hdf5_reads_h5pys_files(tmp_path, chunked):
    """h5py's default layout (libver earliest): a root of 300+ entries,
    nested groups, every dtype, scalars, empty arrays, and with
    ``chunked`` gzip + shuffle chunks that do not divide the shape."""
    want = _arrays()
    path = tmp_path / "h.h5"
    with h5py.File(path, "w") as f:
        for k, v in want.items():
            kw = {}
            if chunked and np.ndim(v) and np.size(v):
                kw = dict(chunks=tuple(max(1, s // 3) for s in np.shape(v)),
                          compression="gzip", shuffle=True)
            f.create_dataset(k, data=v, **kw)
        f.create_group("grp").create_group("sub").create_dataset(
            "y", data=np.ones(3))
        for i in range(300):
            f.create_dataset(f"many/k{i:04d}", data=np.arange(i % 5))
    with hdf5.File(path) as f:
        assert f.keys() == sorted(list(want) + ["grp", "many"])
        for k, v in want.items():
            _equal(f[k][()], v)
            assert f[k].shape == np.shape(v)
        _equal(np.asarray(f["/grp/sub/y"]), np.ones(3))
        assert len(f["many"]) == 300 and "k0123" in f["many"]
        _equal(f["many"]["k0123"][()], np.arange(3))
        assert isinstance(f["scalar"][()], np.float64)


def test_hdf5_reads_h5pys_latest_layout(tmp_path):
    """``libver="latest"``: superblock v3, v2 object headers, compact link
    messages (a group of at most 8 links)."""
    want = {"K": np.eye(3) * 5, "R": np.arange(9.0).reshape(3, 3),
            "T": np.arange(3, dtype=">f4"), "s": np.float32(2),
            "e": np.zeros((2, 0), np.int64),
            "u": np.arange(4, dtype=np.uint16)}
    path = tmp_path / "l.h5"
    with h5py.File(path, "w", libver="latest") as f:
        for k, v in want.items():
            f.create_dataset(k, data=v)
        f.create_group("g").create_dataset("x", data=np.arange(3))
    with hdf5.File(path) as f:
        assert f.keys() == sorted(list(want) + ["g"])
        for k, v in want.items():
            _equal(f[k][()], v)
        _equal(f["g/x"][()], np.arange(3))


def test_h5py_reads_the_ports_files(tmp_path):
    want = _arrays()
    path = tmp_path / "p.h5"
    with hdf5.File(path, "w") as f:
        for k, v in want.items():
            f.create_dataset(k, data=v)
        f.create_dataset("grp/x", data=np.arange(5))
        f.create_dataset("/grp/sub/y", data=np.ones(3))
        for i in range(700):
            f.create_dataset(f"many/k{i:04d}", data=np.arange(i % 5))
    with h5py.File(path, "r") as f:
        for k, v in want.items():
            _equal(f[k][()], v)
        _equal(f["grp/x"][()], np.arange(5))
        _equal(f["/grp/sub/y"][()], np.ones(3))
        assert len(f["many"].keys()) == 700
        _equal(f["many"]["k0699"][()], np.arange(4))
    with hdf5.File(path) as f:
        for k, v in want.items():
            _equal(f[k][()], v)


HDF5_REFUSED = {
    "dense group": (lambda f: [f.create_dataset(f"d{i}", data=[i])
                               for i in range(9)], "latest",
                    "dense group storage"),
    "fixed array index": (lambda f: f.create_dataset(
        "c", data=np.arange(100.0), chunks=(10,), compression="gzip"),
        "latest", "chunk index 'fixed array'"),
    "string": (lambda f: f.create_dataset("s", data="abc"), "earliest",
               "variable-length datatype"),
    "bool": (lambda f: f.create_dataset("b", data=np.ones(3, bool)),
             "earliest", "enum"),
    "fletcher32": (lambda f: f.create_dataset(
        "f", data=np.arange(10.0), chunks=(5,), fletcher32=True),
        "earliest", "filter fletcher32"),
    "compound": (lambda f: f.create_dataset(
        "c", data=np.zeros(2, [("a", "i4"), ("b", "f4")])), "earliest",
        "compound datatype"),
}


@pytest.mark.parametrize("case", sorted(HDF5_REFUSED))
def test_hdf5_refuses_naming_file_and_feature(tmp_path, case):
    make, libver, reason = HDF5_REFUSED[case]
    path = tmp_path / "r.h5"
    with h5py.File(path, "w", libver=libver) as f:
        make(f)
    with pytest.raises(hdf5.HDF5Error) as e:
        with hdf5.File(path) as f:
            for k in f.keys():
                f[k][()]
    assert str(path) in str(e.value) and reason in str(e.value)
    with pytest.raises(hdf5.HDF5Error, match="not an HDF5 file"):
        (tmp_path / "x.h5").write_bytes(b"\0" * 64)
        hdf5.File(tmp_path / "x.h5")
    with pytest.raises(hdf5.HDF5Error, match="cannot write dtype"):
        with hdf5.File(tmp_path / "w.h5", "w") as f:
            f.create_dataset("b", data=np.ones(2, bool))
