"""A reader of tensorstore's OCDBT key-value databases, the format orbax
writes checkpoints in (``use_ocdbt``), with no tensorstore.

A database is a directory. ``manifest.ocdbt`` holds its config and its
versions; the newest version names the root of a B-tree whose nodes live
in data files under ``d/``; a leaf entry holds its value inline or points
at bytes of a data file (orbax's values lie under ``ocdbt.process_0/d/``,
named relative to the root). Every manifest and node is a record:

  magic (u32, big-endian: 0x0cdb3a2a manifest, 0x0cdb20de B-tree node)
  length (u64 LE, the whole record) | version (varint, 0)
  compression (varint: 0 none, 1 zstd) | body | crc32c of all before (u32 LE)

and a body is columns of varints: a data-file table (each path the
previous one's first ``prefix`` bytes plus a suffix, split into a base
path and a relative path), then a node's keys (each the previous key's
first ``prefix`` bytes plus a suffix; a child's keys omit the prefix its
parent entry names) and their values or child references. Values are not
compressed here; zarr compressed them (``interop/orbax_read.py``).

``OcdbtStore(path).keys()`` lists every key in order and ``.read(key)``
returns a value's bytes. Malformed input raises ValueError.
"""
from __future__ import annotations

import struct
from pathlib import Path

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE


class _Reader:
    """Cursor over a body: varints, bytes and u8s, bounds-checked."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def fail(self, why: str):
        raise ValueError(f"{self.what}: {why} (at byte {self.pos})")

    def varint(self) -> int:
        val = shift = 0
        while True:
            if self.pos >= len(self.data):
                self.fail("truncated varint")
            c = self.data[self.pos]
            self.pos += 1
            val |= (c & 0x7F) << shift
            if c < 0x80:
                return val
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail(f"truncated: {n} bytes wanted")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u64s(self, n: int) -> list[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def end(self):
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} bytes left over")


def read_record(data: bytes, magic: int, what: str,
                max_body: int | None = None) -> bytes:
    """The body of a manifest or node record, its header and checksum
    checked and its compression undone."""
    if len(data) < 18:
        raise ValueError(f"{what}: {len(data)} bytes is too short a record")
    got_magic, length = struct.unpack_from(">I", data)[0], \
        struct.unpack_from("<Q", data, 4)[0]
    if got_magic != magic:
        raise ValueError(f"{what}: bad magic {got_magic:#010x}, "
                         f"expected {magic:#010x}")
    if length != len(data):
        raise ValueError(f"{what}: record says {length} bytes, has "
                         f"{len(data)}")
    want = struct.unpack_from("<I", data, len(data) - 4)[0]
    if zstd.crc32c(data[:-4]) != want:
        raise ValueError(f"{what}: crc32c mismatch")
    r = _Reader(data[:-4], what)
    r.pos = 12
    version = r.varint()
    if version != 0:
        r.fail(f"format version {version} unknown")
    compression = r.varint()
    body = data[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body, max_body)
    r.fail(f"compression {compression} unknown")


def _data_file_table(r: _Reader) -> list[str]:
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base = r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("data file prefix longer than the previous path")
        path = prev[:prefix[i]] + r.take(suffix[i])
        if base[i] > len(path):
            r.fail("data file base path longer than its path")
        paths.append(path.decode())
        prev = path
    return paths


def _keys(r: _Reader, n: int, interior: bool):
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else [0] * n
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("key prefix longer than the previous key")
        key = prev[:prefix[i]] + r.take(suffix[i])
        if common[i] > len(key):
            r.fail("subtree prefix longer than its key")
        keys.append(key)
        prev = key
    return keys, common


def _file_id(r: _Reader, files: list[str], i: int) -> str:
    if i >= len(files):
        r.fail(f"data file {i} outside its table of {len(files)}")
    return files[i]


def parse_manifest(body: bytes) -> dict:
    """The config and versions of a manifest body. The newest version is
    the last of the inline ones; older versions sit in version-tree nodes
    the reader does not need, whose references it parses and keeps."""
    r = _Reader(body, "manifest")
    cfg = {"uuid": r.take(16).hex(), "manifest_kind": r.varint(),
           "max_inline_value_bytes": r.varint(),
           "max_decoded_node_bytes": r.varint(),
           "version_tree_arity_log2": r.u8(), "compression": r.varint()}
    if cfg["compression"] == 1:
        cfg["zstd_level"] = struct.unpack("<i", r.take(4))[0]
    elif cfg["compression"] != 0:
        r.fail(f"compression {cfg['compression']} unknown")
    if cfg["manifest_kind"] != 0:
        r.fail("numbered manifests are not supported (only the single "
               "manifest orbax writes)")
    files = _data_file_table(r)
    n = r.varint()
    gen = r.varints(n)
    height = list(r.take(n))
    fid, off, length, nkeys, ntree, nind = (r.varints(n) for _ in range(6))
    time = r.u64s(n)
    versions = [{"generation": gen[i], "root_height": height[i],
                 "root": None if length[i] == 0 else
                 (_file_id(r, files, fid[i]), off[i], length[i]),
                 "num_keys": nkeys[i], "num_tree_bytes": ntree[i],
                 "num_indirect_value_bytes": nind[i], "commit_time": time[i]}
                for i in range(n)]
    m = r.varint()
    ref_gen, ref_fid, ref_off, ref_len, ref_count = (r.varints(m)
                                                     for _ in range(5))
    ref_time, ref_height = r.u64s(m), list(r.take(m))
    nodes = [{"generation": ref_gen[i], "height": ref_height[i],
              "node": (_file_id(r, files, ref_fid[i]), ref_off[i],
                       ref_len[i]),
              "num_generations": ref_count[i], "commit_time": ref_time[i]}
             for i in range(m)]
    r.end()
    return {"config": cfg, "versions": versions, "version_tree_nodes": nodes}


class OcdbtStore:
    """Read-only view of the OCDBT database in directory ``path``, at its
    newest version."""

    def __init__(self, path):
        self.root = Path(path)
        mpath = self.root / "manifest.ocdbt"
        if not mpath.is_file():
            raise FileNotFoundError(f"no OCDBT manifest: {mpath}")
        self.manifest = parse_manifest(read_record(
            mpath.read_bytes(), MANIFEST_MAGIC, str(mpath)))
        cfg = self.manifest["config"]
        self._max_node = cfg["max_decoded_node_bytes"] or None
        if not self.manifest["versions"]:
            raise ValueError(f"{mpath}: no version")
        self.version = self.manifest["versions"][-1]
        self._index: dict[bytes, tuple] | None = None

    def _file(self, rel: str) -> Path:
        p = (self.root / rel).resolve()
        if self.root.resolve() not in p.parents:
            raise ValueError(f"data file {rel} outside the database")
        return p

    def _bytes(self, rel: str, offset: int, length: int) -> bytes:
        with open(self._file(rel), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{rel}: {length} bytes at {offset} wanted, "
                             f"{len(data)} there")
        return data

    def _walk(self, ref, height: int, prefix: bytes, out: dict):
        rel, offset, length = ref
        what = f"B-tree node {rel}@{offset}"
        body = read_record(self._bytes(rel, offset, length), NODE_MAGIC,
                           what, self._max_node)
        r = _Reader(body, what)
        if r.u8() != height:
            r.fail(f"height differs from its parent's count ({height})")
        files = _data_file_table(r)
        n = r.varint()
        keys, common = _keys(r, n, height > 0)
        if height > 0:
            fid, off, ln = r.varints(n), r.varints(n), r.varints(n)
            for _ in range(3):                  # subtree statistics
                r.varints(n)
            r.end()
            for i in range(n):
                self._walk((_file_id(r, files, fid[i]), off[i], ln[i]),
                           height - 1, prefix + keys[i][:common[i]], out)
            return
        lengths = r.varints(n)
        kinds = list(r.take(n))
        if any(k > 1 for k in kinds):
            r.fail("value kind other than inline (0) or in a data file (1)")
        ni = sum(kinds)
        fid, off = r.varints(ni), r.varints(ni)
        j = 0
        for i in range(n):
            if kinds[i]:
                out[prefix + keys[i]] = ("file", _file_id(r, files, fid[j]),
                                         off[j], lengths[i])
                j += 1
        for i in range(n):
            if not kinds[i]:
                out[prefix + keys[i]] = ("inline", r.take(lengths[i]))
        r.end()

    def _entries(self) -> dict:
        if self._index is None:
            index: dict[bytes, tuple] = {}
            root = self.version["root"]
            if root is not None:
                self._walk(root, self.version["root_height"], b"", index)
            if len(index) != self.version["num_keys"]:
                raise ValueError(f"{self.root}: {len(index)} keys read, the "
                                 f"manifest counts {self.version['num_keys']}")
            self._index = dict(sorted(index.items()))
        return self._index

    def keys(self) -> list[str]:
        """Every key, in order."""
        return [k.decode() for k in self._entries()]

    def __contains__(self, key) -> bool:
        return (key.encode() if isinstance(key, str) else key) in \
            self._entries()

    def read(self, key) -> bytes:
        """The value of ``key`` (str or bytes); KeyError where absent."""
        k = key.encode() if isinstance(key, str) else bytes(key)
        entry = self._entries().get(k)
        if entry is None:
            raise KeyError(key)
        if entry[0] == "inline":
            return entry[1]
        return self._bytes(*entry[1:])
