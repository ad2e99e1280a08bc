"""The port's zstd decoder (``interop/zstd_decode.cpp`` through
``interop/zstd.py``) against the ``zstandard`` package, on the CPU.

Every frame of the four committed checkpoint stores: each data file's run
of value frames (zarr chunks) decoded whole, as concatenated frames, and
each manifest and B-tree node record's frame; synthetic inputs (random and
repetitive bytes, float32 arrays, more than one 128 KiB block) at levels
1, 3, 9 and 19, with and without checksum and content size, streamed with
block flushes, and concatenated and skippable frames; and the errors:
bad magic, truncation at every cut, a flipped checksum byte, a dictionary,
an output above its limit. ``zstandard`` is the oracle here only.
"""
import struct
from pathlib import Path

import numpy as np
import pytest
import zstandard

from oetr_tpu_torch.interop import zstd

ROOT = Path(__file__).resolve().parents[1]
STORES = [".ckpt_matching_r5/superpoint", ".ckpt_matching_r5/superglue",
          ".ckpt_loftr_r5/loftr", ".ckpt_oetr_r5/params"]
RECORD_MAGICS = (bytes.fromhex("0cdb3a2a"), bytes.fromhex("0cdb20de"))
ZSTD_MAGIC = bytes.fromhex("28b52ffd")


def _frame_end(data: bytes, pos: int) -> int:
    """Where the zstd frame at ``pos`` ends, from its header and block
    headers alone (RFC 8878 section 3.1.1)."""
    assert data[pos:pos + 4] == ZSTD_MAGIC
    fhd = data[pos + 4]
    single = fhd >> 5 & 1
    fcs = (0, 2, 4, 8)[fhd >> 6] or single
    p = pos + 5 + (1 - single) + (0, 1, 2, 4)[fhd & 3] + fcs
    while True:
        head = int.from_bytes(data[p:p + 3], "little")
        p += 3 + (1 if (head >> 1) & 3 == 1 else head >> 3)
        if head & 1:
            return p + 4 * (fhd >> 2 & 1)


def _pieces(data: bytes):
    """An OCDBT file cut into ('frame', start, end) zstd frames and
    ('record', start, end) manifest or node records; trailing zero
    padding ends it."""
    pos, out = 0, []
    while pos < len(data):
        if not data[pos:].strip(b"\0"):
            break
        if data[pos:pos + 4] in RECORD_MAGICS:
            end = pos + struct.unpack_from("<Q", data, pos + 4)[0]
            out.append(("record", pos, end))
        else:
            end = _frame_end(data, pos)
            out.append(("frame", pos, end))
        pos = end
    return out


def _oracle(data: bytes, frames) -> bytes:
    """``zstandard``'s decoding of the frames [start, end) of ``data``."""
    return b"".join(zstandard.ZstdDecompressor().decompressobj().decompress(
        data[s:e]) for s, e in frames)


@pytest.mark.parametrize("store", STORES)
def test_every_frame_of_the_stores(store):
    files = [p for p in sorted((ROOT / store).rglob("*")) if p.is_file()
             and p.read_bytes()[:4] in RECORD_MAGICS + (ZSTD_MAGIC,)]
    assert files
    n_frames = 0
    for path in files:
        data = path.read_bytes()
        pieces = _pieces(data)
        frames = [(s, e) for kind, s, e in pieces if kind == "frame"]
        if frames:                       # the file's values, decoded whole
            run = data[frames[0][0]:frames[-1][1]]
            assert sum(e - s for s, e in frames) == len(run)
            assert zstd.decompress(run) == _oracle(data, frames), path
            n_frames += len(frames)
        for kind, s, e in pieces:
            if kind == "record":         # header 14 bytes, crc32c 4
                body = data[s + 14:e - 4]
                assert zstd.decompress(body) == _oracle(
                    data, [(s + 14, e - 4)]), (path, s)
                assert zstd.crc32c(data[s:e - 4]) == struct.unpack_from(
                    "<I", data, e - 4)[0]
                n_frames += 1
    assert n_frames > 10


def _inputs():
    rng = np.random.default_rng(0)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon"]
    return {
        "empty": b"",
        "one_byte": b"a",
        "random": rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
        "repetitive": (b"abcabcabd" * 3000)[:20000],
        "text": b" ".join(rng.choice(words, size=40000)),
        "f32": rng.normal(size=70000).astype(np.float32).tobytes(),
        "f32_small": (rng.normal(size=3000) * 0.01).astype(
            np.float32).tobytes(),
        "multi_block": rng.integers(0, 8, 400000, dtype=np.uint8).tobytes(),
        "zeros": bytes(300000),
        "skewed": rng.geometric(0.3, size=200000).astype(np.uint8).tobytes(),
    }


@pytest.mark.parametrize("content_size", [False, True])
@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [1, 3, 9, 19])
def test_synthetic_frames(level, checksum, content_size):
    comp = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=content_size)
    for name, data in _inputs().items():
        assert zstd.decompress(comp.compress(data)) == data, name


def test_streams_windows_and_concatenated_frames():
    inputs = list(_inputs().values())
    # one frame of flushed blocks: repeat-mode tables and treeless literals
    obj = zstandard.ZstdCompressor(level=5).compressobj()
    parts = []
    for data in inputs:
        parts += [obj.compress(data),
                  obj.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)]
    parts.append(obj.flush())
    assert zstd.decompress(b"".join(parts)) == b"".join(inputs)
    # small windows, long matches
    for wlog in (10, 12, 17):
        params = zstandard.ZstdCompressionParameters(window_log=wlog,
                                                     compression_level=19)
        frame = zstandard.ZstdCompressor(
            compression_params=params).compress(b"".join(inputs))
        assert zstd.decompress(frame) == b"".join(inputs), wlog
    # concatenated frames of several levels, a skippable frame among them
    frames = [zstandard.ZstdCompressor(level=lv, write_checksum=True)
              .compress(d) for lv, d in zip((1, 3, 9, 19) * 3, inputs)]
    skippable = struct.pack("<II", 0x184D2A53, 5) + b"12345"
    assert zstd.decompress(skippable.join(frames)) == b"".join(inputs)


def test_errors_raise_and_return_nothing():
    data = _inputs()["text"]
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
        data)
    with pytest.raises(ValueError, match="bad magic"):
        zstd.decompress(b"\0" + frame[1:])
    with pytest.raises(ValueError, match="empty"):
        zstd.decompress(b"")
    for cut in range(0, len(frame), max(1, len(frame) // 200)):
        with pytest.raises(ValueError):
            zstd.decompress(frame[:cut])
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(frame[:-1] + bytes([frame[-1] ^ 1]))
    with pytest.raises(ValueError, match="limit"):
        zstd.decompress(frame, max_out=len(data) - 1)
    assert zstd.decompress(frame, max_out=len(data)) == data
    # a dictionary id (flag 1, one byte) in an otherwise whole frame
    fhd = frame[4]
    assert fhd & 3 == 0
    at = 5 if fhd & 0x20 else 6          # after the window descriptor
    with_dict = frame[:4] + bytes([fhd | 1]) + frame[5:at] + b"\x07" + \
        frame[at:]
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(with_dict)
    # random damage raises or decodes, never crashes
    rng = np.random.default_rng(1)
    for _ in range(200):
        bad = bytearray(frame)
        bad[rng.integers(4, len(bad))] ^= 1 << rng.integers(0, 8)
        try:
            zstd.decompress(bytes(bad))
        except ValueError:
            pass


def test_crc32c_and_build_record():
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(b"") == 0
    rec = zstd.decoder_record()
    assert Path(rec["so"]).exists() and rec["so"].endswith(".so")
    assert zstd.library_path().parent.name == "_build"
