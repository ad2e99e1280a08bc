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

``write_store(path, items)`` writes a one-version database of its own: the
manifest, one data file ``d/<hex>`` with the values longer than
``MAX_INLINE_VALUE_BYTES`` and then the B-tree's nodes, leaves first, each
node at most ``MAX_DECODED_NODE_BYTES`` (a tree of interior nodes above the
leaves where one node would pass it); the two are tensorstore's defaults,
which the committed stores' manifests record. Every record is uncompressed
(compression 0), since the port has no zstd encoder, and the manifest's
config says so.
"""
from __future__ import annotations

import os
import struct
import time
from pathlib import Path

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_ROOT = 2 ** 64 - 1      # a version's root length where it has none


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
                 "root": None if length[i] in (0, _NO_ROOT) else
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
        self._files: dict[str, Path] = {}

    def _file(self, rel: str) -> Path:
        if rel not in self._files:
            p = (self.root / rel).resolve()
            if self.root.resolve() not in p.parents:
                raise ValueError(f"data file {rel} outside the database")
            self._files[rel] = p
        return self._files[rel]

    def _bytes(self, rel: str, offset: int, length: int, into=None):
        """``length`` bytes at ``offset`` of a data file, or read into the
        writable buffer ``into`` of that length."""
        with open(self._file(rel), "rb") as f:
            f.seek(offset)
            if into is None:
                data = f.read(length)
                got = len(data)
            else:
                data, got = into, f.readinto(into)
        if got != length:
            raise ValueError(f"{rel}: {length} bytes at {offset} wanted, "
                             f"{got} there")
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

    def _entry(self, key):
        k = key.encode() if isinstance(key, str) else bytes(key)
        entry = self._entries().get(k)
        if entry is None:
            raise KeyError(key)
        return entry

    def read(self, key) -> bytes:
        """The value of ``key`` (str or bytes); KeyError where absent."""
        entry = self._entry(key)
        if entry[0] == "inline":
            return entry[1]
        return self._bytes(*entry[1:])

    def size(self, key) -> int:
        """The length of ``key``'s value."""
        entry = self._entry(key)
        return len(entry[1]) if entry[0] == "inline" else entry[3]

    def read_into(self, key, buf) -> None:
        """The value of ``key`` into the writable buffer ``buf`` of its
        length (``size(key)``)."""
        entry = self._entry(key)
        view = memoryview(buf).cast("B")
        if len(view) != self.size(key):
            raise ValueError(f"{key}: {self.size(key)} bytes, a buffer of "
                             f"{len(view)}")
        if entry[0] == "inline":
            view[:] = entry[1]
        else:
            self._bytes(*entry[1:], into=view)


# ----------------------------------------------------------------- writer --

def _uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _uvarints(values) -> bytes:
    return b"".join(_uvarint(v) for v in values)


def _common_prefix(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def write_record(magic: int, body: bytes) -> bytes:
    """A manifest or node record around ``body``: magic, length, format
    version 0, compression 0, the body and its crc32c."""
    head = _uvarint(0) + _uvarint(0)
    length = 12 + len(head) + len(body) + 4
    data = struct.pack(">I", magic) + struct.pack("<Q", length) + head + body
    return data + struct.pack("<I", zstd.crc32c(data))


def _file_table(paths: list[str]) -> bytes:
    raw = [p.encode() for p in paths]
    prefix = [_common_prefix(raw[i - 1], raw[i]) for i in range(1, len(raw))]
    suffix = [raw[i][(prefix[i - 1] if i else 0):] for i in range(len(raw))]
    return (_uvarint(len(raw)) + _uvarints(prefix)
            + _uvarints(len(s) for s in suffix)
            + _uvarints(0 for _ in raw) + b"".join(suffix))


def _key_columns(keys: list[bytes], common: list[int] | None) -> bytes:
    prefix = [_common_prefix(keys[i - 1], keys[i])
              for i in range(1, len(keys))]
    suffix = [keys[i][(prefix[i - 1] if i else 0):] for i in range(len(keys))]
    out = _uvarint(len(keys)) + _uvarints(prefix) + _uvarints(
        len(s) for s in suffix)
    if common is not None:
        out += _uvarints(common)
    return out + b"".join(suffix)


def _leaf_body(keys, entries, data_file: str) -> bytes:
    """entries: ("inline", bytes) or ("file", offset, length)."""
    indirect = [e for e in entries if e[0] == "file"]
    body = bytes([0]) + _file_table([data_file] if indirect else [])
    body += _key_columns(keys, None)
    body += _uvarints(len(e[1]) if e[0] == "inline" else e[2]
                      for e in entries)
    body += bytes(int(e[0] == "file") for e in entries)
    body += _uvarints(0 for _ in indirect) + _uvarints(e[1] for e in indirect)
    return body + b"".join(bytes(e[1]) for e in entries
                           if e[0] == "inline")


def _interior_body(height, keys, common, children, data_file) -> bytes:
    """children: (offset, length, num_keys, tree_bytes, indirect_bytes)."""
    body = bytes([height]) + _file_table([data_file])
    body += _key_columns(keys, common)
    body += _uvarints(0 for _ in children)
    for col in range(5):
        body += _uvarints(c[col] for c in children)
    return body


def _groups(costs: list[int], limit: int) -> list[tuple[int, int]]:
    """Consecutive [start, stop) runs whose costs sum to at most ``limit``
    (one entry at least each)."""
    out, start, total = [], 0, 0
    for i, c in enumerate(costs):
        if i > start and total + c > limit:
            out.append((start, i))
            start, total = i, 0
        total += c
    out.append((start, len(costs)))
    return out


# Upper bound of a node's bytes besides its entries: header, height, a
# one-file table with a 34-byte path, the count, the crc.
_NODE_OVERHEAD = 80

# The writer's config, as the manifest records it.
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000


def write_store(path, items) -> None:
    """Write the OCDBT database of ``items`` ((key, value) pairs, keys str
    or bytes, each once, values any bytes-like object) into the empty or
    absent directory ``path``: one version, uncompressed records, values
    above ``MAX_INLINE_VALUE_BYTES`` out of line. Raises ValueError on a
    repeated key or on a node limit too small for one entry."""
    max_inline_value_bytes = MAX_INLINE_VALUE_BYTES
    max_decoded_node_bytes = MAX_DECODED_NODE_BYTES
    root = Path(path)
    pairs = sorted(((k.encode() if isinstance(k, str) else bytes(k),
                     memoryview(v).cast("B")) for k, v in items),
                   key=lambda kv: kv[0])
    for a, b in zip(pairs, pairs[1:]):
        if a[0] == b[0]:
            raise ValueError(f"key {a[0]!r} given twice")
    (root / "d").mkdir(parents=True, exist_ok=True)
    data_file = f"d/{os.urandom(16).hex()}"
    offset = indirect_bytes = tree_bytes = 0
    with open(root / data_file, "wb") as f:
        def put(blob: bytes) -> tuple[int, int]:
            nonlocal offset
            f.write(blob)
            offset += len(blob)
            return offset - len(blob), len(blob)

        entries, costs = [], []
        for key, value in pairs:
            if len(value) > max_inline_value_bytes:
                entries.append(("file", *put(value)))
                indirect_bytes += len(value)
                cost = len(key) + 40
            else:
                entries.append(("inline", value))
                cost = len(key) + len(value) + 30
            if cost + _NODE_OVERHEAD > max_decoded_node_bytes:
                raise ValueError(f"max_decoded_node_bytes "
                                 f"{max_decoded_node_bytes} cannot hold key "
                                 f"{key!r}")
            costs.append(cost)
        keys = [k for k, _ in pairs]
        limit = max_decoded_node_bytes - _NODE_OVERHEAD
        # Each level: (first key, last key, the keys' common prefix, the
        # node's offset, length and subtree statistics).
        # A node's keys omit the prefix its parent's entry names; the
        # root's keep theirs (the manifest names no prefix).
        level, height = [], 0
        groups = _groups(costs, limit) if pairs else []
        for a, b in groups:
            cp = (_common_prefix(keys[a], keys[b - 1]) if len(groups) > 1
                  else 0)
            body = _leaf_body([k[cp:] for k in keys[a:b]], entries[a:b],
                              data_file)
            ref = put(write_record(NODE_MAGIC, body))
            tree_bytes += ref[1]
            nind = sum(e[2] for e in entries[a:b] if e[0] == "file")
            level.append((keys[a], keys[b - 1], cp,
                          (*ref, b - a, ref[1], nind)))
        while len(level) > 1:
            height += 1
            costs = [len(first) + 70 for first, *_ in level]
            nxt = []
            groups = _groups(costs, limit)
            for a, b in groups:
                group = level[a:b]
                cp = (_common_prefix(group[0][0], group[-1][1])
                      if len(groups) > 1 else 0)
                body = _interior_body(
                    height, [g[0][cp:] for g in group],
                    [g[2] - cp for g in group], [g[3] for g in group],
                    data_file)
                ref = put(write_record(NODE_MAGIC, body))
                tree_bytes += ref[1]
                stats = [sum(g[3][i] for g in group) for i in (2, 3, 4)]
                nxt.append((group[0][0], group[-1][1], cp,
                            (*ref, stats[0], stats[1] + ref[1], stats[2])))
            level = nxt
        root_ref = level[0][3] if level else None
    body = os.urandom(16) + _uvarint(0) + _uvarint(max_inline_value_bytes)
    body += _uvarint(max_decoded_node_bytes) + bytes([4]) + _uvarint(0)
    # (no root: tensorstore's empty path at offset and length 2^64 - 1)
    body += _file_table([data_file] if root_ref else [""])
    ref = root_ref or (_NO_ROOT, _NO_ROOT)
    body += _uvarint(1) + _uvarint(1) + bytes([height])
    body += _uvarints([0, ref[0], ref[1], len(pairs), tree_bytes,
                       indirect_bytes])
    body += struct.pack("<Q", time.time_ns()) + _uvarint(0)
    (root / "manifest.ocdbt").write_bytes(write_record(MANIFEST_MAGIC, body))
