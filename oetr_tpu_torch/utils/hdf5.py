"""A pure-Python subset of HDF5: what the port's h5 files need, read and
written without h5py.

Reader: superblock versions 0, 1, 2 and 3; object headers v1 and v2 with
their continuation blocks; groups stored as a symbol table (v1 B-tree,
SNOD nodes, local heap) or as compact link messages; datasets whose
layout is compact, contiguous, or chunked with a v1 B-tree index, under
the deflate and shuffle filters; fixed-point and IEEE float types of
either byte order; scalar, simple and empty dataspaces (a dataset with no
storage, such as h5py's ``[2, 0]``, reads as its fill, zeros). That is
what h5py writes by default and with ``libver="latest"`` for these files.
Anything else (dense groups in a fractal heap, other chunk indexes, other
filters, string, compound, enum and other types, soft and external links)
raises ``HDF5Error`` naming the file and the feature.

Writer: superblock v0, symbol-table groups, v1 object headers and
contiguous datasets (compact where the data is at most
``COMPACT_MAX`` bytes; no storage where it is empty), little-endian
integers and IEEE floats: what ``utils/h5io.py``, the scene generators'
depth maps and the IMC calibration files need. h5py reads the result.

API: ``File(path, "r" | "w")`` as a context manager, ``f[name]`` (a
``Group`` or a ``Dataset``; names may be paths), ``keys()``, ``ds[()]``,
``np.asarray(ds)`` and ``f.create_dataset(name, data=...)``, so call sites
read as they do with h5py.
"""
from __future__ import annotations

import math
import mmap
import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
COMPACT_MAX = 64

# Message types.
_DATASPACE, _LINK_INFO, _DATATYPE, _LINK, _LAYOUT = 0x1, 0x2, 0x3, 0x6, 0x8
_FILTERS, _CONTINUATION, _SYMBOL_TABLE = 0xB, 0x10, 0x11
_DEFLATE, _SHUFFLE = 1, 2


class HDF5Error(ValueError):
    """A file or a feature this subset does not read or write."""


# ================================================================ reader ==

class _Reader:
    """The bytes of one file and the decoding of its structures."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        size = os.fstat(self._f.fileno()).st_size
        if size == 0:
            self._f.close()
            raise HDF5Error(f"{path}: empty file")
        self.buf = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self.base = self._find_superblock()
        self.root = self._read_superblock()

    def close(self):
        if self.buf is not None:
            self.buf.close()
            self._f.close()
            self.buf = None

    def fail(self, what: str):
        raise HDF5Error(f"{self.path}: {what}")

    def _find_superblock(self) -> int:
        off = 0
        while off + 8 <= len(self.buf):
            if self.buf[off:off + 8] == SIGNATURE:
                return off
            off = 512 if off == 0 else 2 * off
        self.fail("not an HDF5 file (no superblock signature)")

    def u(self, pos: int, n: int) -> int:
        return int.from_bytes(self.buf[pos:pos + n], "little")

    def _read_superblock(self) -> int:
        p = self.base
        version = self.buf[p + 8]
        if version in (0, 1):
            self.so, self.sl = self.buf[p + 13], self.buf[p + 14]
            q = p + (28 if version == 1 else 24)
            self.addr_base = self.u(q, self.so)
            q += 4 * self.so                      # base, free, EOF, VFD info
            return self.addr(self.u(q + self.so, self.so))  # root entry
        if version in (2, 3):
            self.so, self.sl = self.buf[p + 9], self.buf[p + 10]
            q = p + 12
            self.addr_base = self.u(q, self.so)
            return self.addr(self.u(q + 3 * self.so, self.so))
        self.fail(f"superblock version {version}")

    def addr(self, a: int) -> int:
        return a + self.addr_base

    def defined(self, a: int) -> bool:
        return a != (1 << (8 * self.so)) - 1

    # ---------------------------------------------------- object headers --
    def messages(self, addr: int) -> list[tuple[int, int, int, int]]:
        """(type, flags, data offset, data size) of an object header's
        messages, continuation blocks followed."""
        out, chunks = [], []
        if self.buf[addr:addr + 4] == b"OHDR":
            version, flags = self.buf[addr + 4], self.buf[addr + 5]
            if version != 2:
                self.fail(f"object header version {version}")
            p = addr + 6 + (16 if flags & 0x20 else 0) + \
                (4 if flags & 0x10 else 0)
            n = 1 << (flags & 3)
            size = self.u(p, n)
            chunks.append((p + n, p + n + size, 2, flags))
        else:
            version = self.buf[addr]
            if version != 1:
                self.fail(f"object header version {version} at {addr}")
            size = self.u(addr + 8, 4)
            chunks.append((addr + 16, addr + 16 + size, 1, 0))
        while chunks:
            start, end, version, flags = chunks.pop(0)
            p = start
            head = 8 if version == 1 else 4 + (2 if flags & 0x04 else 0)
            while p + head <= end:
                if version == 1:
                    mtype, msize = self.u(p, 2), self.u(p + 2, 2)
                    mflags = self.buf[p + 4]
                else:
                    mtype, msize = self.buf[p], self.u(p + 1, 2)
                    mflags = self.buf[p + 3]
                data = p + head
                if mtype == _CONTINUATION:
                    caddr = self.addr(self.u(data, self.so))
                    clen = self.u(data + self.so, self.sl)
                    if version == 1:
                        chunks.append((caddr, caddr + clen, 1, 0))
                    else:
                        if self.buf[caddr:caddr + 4] != b"OCHK":
                            self.fail("bad object header continuation")
                        chunks.append((caddr + 4, caddr + clen - 4, 2, flags))
                elif mtype != 0:
                    out.append((mtype, mflags, data, msize))
                p = data + msize
        return out

    # ------------------------------------------------------------ groups --
    def links(self, addr: int) -> dict[str, int]:
        """A group's children: name -> object header address."""
        msgs = self.messages(addr)
        names: dict[str, int] = {}
        for mtype, _, p, _ in msgs:
            if mtype == _SYMBOL_TABLE:
                btree = self.addr(self.u(p, self.so))
                heap = self.addr(self.u(p + self.so, self.so))
                self._symbol_table(btree, self._heap_data(heap), names)
            elif mtype == _LINK_INFO:
                flags = self.buf[p + 1]
                q = p + 2 + (8 if flags & 1 else 0)
                if self.defined(self.u(q, self.so)):
                    self.fail("dense group storage (fractal heap)")
            elif mtype == _LINK:
                name, target = self._link(p)
                names[name] = target
        return names

    def _heap_data(self, heap: int) -> int:
        if self.buf[heap:heap + 4] != b"HEAP":
            self.fail("bad local heap")
        return self.addr(self.u(heap + 8 + 2 * self.sl, self.so))

    def _cstring(self, p: int) -> str:
        end = self.buf.find(b"\0", p)
        return self.buf[p:end].decode("utf-8")

    def _symbol_table(self, node: int, heap: int, names: dict) -> None:
        if self.buf[node:node + 4] != b"TREE" or self.buf[node + 4] != 0:
            self.fail("bad group B-tree node")
        level, used = self.buf[node + 5], self.u(node + 6, 2)
        p = node + 8 + 2 * self.so + self.sl        # past key 0
        for _ in range(used):
            child = self.addr(self.u(p, self.so))
            p += self.so + self.sl
            if level > 0:
                self._symbol_table(child, heap, names)
                continue
            if self.buf[child:child + 4] != b"SNOD":
                self.fail("bad symbol table node")
            n = self.u(child + 6, 2)
            e = child + 8
            for _ in range(n):
                name = self._cstring(heap + self.u(e, self.so))
                names[name] = self.addr(self.u(e + self.so, self.so))
                e += 2 * self.so + 24

    def _link(self, p: int) -> tuple[str, int]:
        flags = self.buf[p + 1]
        q = p + 2
        ltype = 0
        if flags & 0x08:
            ltype = self.buf[q]
            q += 1
        if flags & 0x04:
            q += 8
        if flags & 0x10:
            q += 1
        n = 1 << (flags & 3)
        length = self.u(q, n)
        q += n
        name = bytes(self.buf[q:q + length]).decode("utf-8")
        if ltype != 0:
            self.fail(f"link {name!r} is not a hard link (type {ltype})")
        return name, self.addr(self.u(q + length, self.so))

    # ---------------------------------------------------------- datasets --
    def is_dataset(self, addr: int) -> bool:
        return any(t == _LAYOUT for t, _, _, _ in self.messages(addr))

    def dataset_info(self, addr: int) -> dict:
        info = {"filters": []}
        for mtype, mflags, p, size in self.messages(addr):
            if mtype == _DATASPACE:
                info["shape"] = self._dataspace(p)
            elif mtype == _DATATYPE:
                if mflags & 0x02:
                    self.fail("shared (committed) datatype")
                info["dtype"] = self._datatype(p)
            elif mtype == _LAYOUT:
                info["layout"] = self._layout(p)
            elif mtype == _FILTERS:
                info["filters"] = self._filters(p)
        for key in ("shape", "dtype", "layout"):
            if key not in info:
                self.fail(f"dataset without a {key} message")
        return info

    def _dataspace(self, p: int):
        version, rank, flags = self.buf[p], self.buf[p + 1], self.buf[p + 2]
        if version == 1:
            q = p + 8
        elif version == 2:
            if self.buf[p + 3] == 2:
                return None                          # null dataspace
            q = p + 4
        else:
            self.fail(f"dataspace version {version}")
        return tuple(self.u(q + i * self.sl, self.sl) for i in range(rank))

    def _datatype(self, p: int) -> np.dtype:
        cls = self.buf[p] & 0x0F
        bits0 = self.buf[p + 1]
        size = self.u(p + 4, 4)
        if cls == 0:
            kind = "i" if bits0 & 0x08 else "u"
            if size not in (1, 2, 4, 8):
                self.fail(f"{size}-byte integer type")
        elif cls == 1:
            if bits0 & 0x40:
                self.fail("VAX-order float type")
            kind = "f"
            if size not in (2, 4, 8):
                self.fail(f"{size}-byte float type")
        else:
            names = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
                     6: "compound", 7: "reference", 8: "enum (h5py's bool)",
                     9: "variable-length", 10: "array"}
            self.fail(f"{names.get(cls, f'class {cls}')} datatype")
        order = ">" if bits0 & 0x01 else "<"
        return np.dtype(f"{order}{kind}{size}")

    def _layout(self, p: int) -> dict:
        version, cls = self.buf[p], self.buf[p + 1]
        if version not in (3, 4):
            self.fail(f"data layout message version {version}")
        if cls == 0:
            size = self.u(p + 2, 2)
            return {"class": "compact", "data": (p + 4, size)}
        if cls == 1:
            return {"class": "contiguous",
                    "addr": self.u(p + 2, self.so),
                    "size": self.u(p + 2 + self.so, self.sl)}
        if cls == 2:
            if version == 4:
                q = p + 4
                ndims, enc = self.buf[p + 3], self.buf[q]
                index = self.buf[q + 1 + ndims * enc]
                names = {1: "single chunk", 2: "implicit", 3: "fixed array",
                         4: "extensible array", 5: "v2 B-tree"}
                self.fail(f"chunk index '{names.get(index, index)}' (only "
                          "the v1 B-tree index is read)")
            ndims = self.buf[p + 2]
            btree = self.u(p + 3, self.so)
            q = p + 3 + self.so
            dims = tuple(self.u(q + 4 * i, 4) for i in range(ndims))
            return {"class": "chunked", "btree": btree, "chunk": dims[:-1]}
        self.fail(f"layout class {cls}")

    def _filters(self, p: int) -> list[tuple[int, tuple]]:
        version, n = self.buf[p], self.buf[p + 1]
        q = p + (8 if version == 1 else 2)
        out = []
        for _ in range(n):
            fid = self.u(q, 2)
            if version == 1 or fid >= 256:
                name_len = self.u(q + 2, 2)
                q += 4
            else:
                name_len = 0
                q += 2
            nvals = self.u(q + 2, 2)
            q += 4
            q += ((name_len + 7) // 8 * 8) if version == 1 else name_len
            vals = tuple(self.u(q + 4 * i, 4) for i in range(nvals))
            q += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
            if fid not in (_DEFLATE, _SHUFFLE):
                names = {3: "fletcher32", 4: "szip", 5: "nbit",
                         6: "scaleoffset"}
                self.fail(f"filter {names.get(fid, fid)} (only deflate and "
                          "shuffle are read)")
            out.append((fid, vals))
        return out

    def read(self, addr: int) -> np.ndarray:
        info = self.dataset_info(addr)
        shape, dtype, lay = info["shape"], info["dtype"], info["layout"]
        if shape is None:
            return np.zeros((0,), dtype)
        count = math.prod(shape)
        if lay["class"] == "compact":
            p, size = lay["data"]
            raw = bytes(self.buf[p:p + size])
        elif lay["class"] == "contiguous":
            if not self.defined(lay["addr"]) or count == 0:
                return np.zeros(shape, dtype)
            a = self.addr(lay["addr"])
            raw = bytes(self.buf[a:a + count * dtype.itemsize])
        else:
            return self._read_chunked(lay, shape, dtype, info["filters"])
        if len(raw) < count * dtype.itemsize:
            self.fail("dataset storage shorter than its shape")
        arr = np.frombuffer(raw, dtype, count).reshape(shape)
        return arr.astype(dtype.newbyteorder("="))

    def _read_chunked(self, lay, shape, dtype, filters) -> np.ndarray:
        out = np.zeros(shape, dtype.newbyteorder("="))
        if not self.defined(lay["btree"]) or out.size == 0:
            return out
        chunk = lay["chunk"]
        for offset, size, mask, caddr in self._chunks(
                self.addr(lay["btree"]), len(shape)):
            raw = bytes(self.buf[caddr:caddr + size])
            for i in reversed(range(len(filters))):
                if mask & (1 << i):
                    continue
                fid, vals = filters[i]
                if fid == _DEFLATE:
                    raw = zlib.decompress(raw)
                else:
                    es = vals[0] if vals else dtype.itemsize
                    n = len(raw) // es
                    body = np.frombuffer(raw, np.uint8, n * es)
                    raw = body.reshape(es, n).T.tobytes() + raw[n * es:]
            block = np.frombuffer(raw, dtype, math.prod(chunk)).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s))
                        for o, c, s in zip(offset, chunk, shape))
            src = tuple(slice(0, d.stop - d.start) for d in dst)
            out[dst] = block[src]
        return out

    def _chunks(self, node: int, rank: int):
        if self.buf[node:node + 4] != b"TREE" or self.buf[node + 4] != 1:
            self.fail("bad chunk B-tree node")
        level, used = self.buf[node + 5], self.u(node + 6, 2)
        key = 8 + 8 * (rank + 1)
        p = node + 8 + 2 * self.so
        for _ in range(used):
            size, mask = self.u(p, 4), self.u(p + 4, 4)
            offset = tuple(self.u(p + 8 + 8 * i, 8) for i in range(rank))
            child = self.addr(self.u(p + key, self.so))
            p += key + self.so
            if level > 0:
                yield from self._chunks(child, rank)
            else:
                yield offset, size, mask, child


class Dataset:
    """One dataset of an open file, read when indexed."""

    def __init__(self, reader: _Reader, addr: int, name: str):
        self._r, self._addr, self.name = reader, addr, name
        info = reader.dataset_info(addr)
        self.shape = info["shape"] if info["shape"] is not None else (0,)
        self.dtype = info["dtype"].newbyteorder("=")

    def __getitem__(self, key):
        arr = self._r.read(self._addr)
        return arr[key]

    def __array__(self, dtype=None, copy=None):
        arr = self._r.read(self._addr)
        return arr if dtype is None else arr.astype(dtype)


class Group:
    """A group of an open file: its children by name (paths allowed)."""

    def __init__(self, reader: _Reader, addr: int, name: str):
        self._r, self._addr, self.name = reader, addr, name
        self._links = None

    def _children(self) -> dict[str, int]:
        if self._links is None:
            self._links = self._r.links(self._addr)
        return self._links

    def keys(self):
        return sorted(self._children())

    def __len__(self) -> int:
        return len(self._children())

    def __contains__(self, name: str) -> bool:
        try:
            self[name]
        except KeyError:
            return False
        return True

    def __getitem__(self, name: str):
        parts = [p for p in name.split("/") if p]
        if not parts:
            return self
        head, rest = parts[0], "/".join(parts[1:])
        addr = self._children().get(head)
        if addr is None:
            raise KeyError(f"{self._r.path}: no object {name!r} in "
                           f"{self.name!r}")
        path = f"{self.name.rstrip('/')}/{head}"
        if self._r.is_dataset(addr):
            if rest:
                raise KeyError(f"{self._r.path}: {path} is a dataset")
            return Dataset(self._r, addr, path)
        child = Group(self._r, addr, path)
        return child[rest] if rest else child


# ================================================================ writer ==

def _pad8(n: int) -> int:
    return (n + 7) // 8 * 8


def _datatype_message(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind in "iu":
        bits0 = 0x08 if dtype.kind == "i" else 0
        return (bytes([0x10, bits0, 0, 0]) + struct.pack("<I", size)
                + struct.pack("<HH", 0, 8 * size))
    if dtype.kind == "f" and size in (2, 4, 8):
        exp_loc, exp_size, mant, bias = {2: (10, 5, 10, 15),
                                         4: (23, 8, 23, 127),
                                         8: (52, 11, 52, 1023)}[size]
        return (bytes([0x11, 0x20, 8 * size - 1, 0]) + struct.pack("<I", size)
                + struct.pack("<HHBBBBI", 0, 8 * size, exp_loc, exp_size, 0,
                              mant, bias))
    raise HDF5Error(f"cannot write dtype {dtype} (integers and IEEE floats "
                    "only)")


class _Writer:
    """Lays a tree of groups (dicts) and arrays out as one HDF5 file."""

    def __init__(self, tree: dict):
        self.out = bytearray(96)                 # the superblock, last
        sizes = []

        def walk(node):
            sizes.append(len(node))
            for v in node.values():
                if isinstance(v, dict):
                    walk(v)
        walk(tree)
        # One B-tree level of at most 32 symbol nodes holds every group.
        self.internal_k = 16
        self.leaf_k = max(4, math.ceil(max(sizes) / 64))
        self.tree = tree

    def alloc(self, data: bytes) -> int:
        addr = _pad8(len(self.out))
        self.out.extend(b"\0" * (addr - len(self.out)))
        self.out.extend(data)
        return addr

    def header(self, messages: list[tuple[int, bytes]]) -> int:
        body = b"".join(struct.pack("<HHB3x", t, _pad8(len(m)), 0)
                        + m + b"\0" * (_pad8(len(m)) - len(m))
                        for t, m in messages)
        prefix = struct.pack("<BBHII", 1, 0, len(messages), 1, len(body))
        return self.alloc(prefix + b"\0" * 4 + body)

    def dataset(self, arr: np.ndarray) -> int:
        arr = np.asarray(arr)
        dt = arr.dtype.newbyteorder("<") if arr.dtype.byteorder == ">" \
            else arr.dtype
        dtmsg = _datatype_message(dt)
        raw = np.ascontiguousarray(arr, dt).tobytes()
        space = struct.pack("<BBB5x", 1, arr.ndim, 0) + b"".join(
            struct.pack("<Q", d) for d in arr.shape)
        if 0 < len(raw) <= COMPACT_MAX:
            layout = struct.pack("<BBH", 3, 0, len(raw)) + raw
        else:
            addr = self.alloc(raw) if raw else UNDEF
            layout = struct.pack("<BBQQ", 3, 1, addr, len(raw))
        return self.header([(_DATASPACE, space), (_DATATYPE, dtmsg),
                            (_LAYOUT, layout)])

    def group(self, node: dict) -> tuple[int, int, int]:
        """(object header, B-tree, heap) addresses of a group."""
        children = {}
        for name, v in node.items():
            children[name] = (self.group(v)[0] if isinstance(v, dict)
                              else self.dataset(v))
        names = sorted(children, key=lambda s: s.encode("utf-8"))
        heap_data, offsets = bytearray(8), {}
        for name in names:
            offsets[name] = len(heap_data)
            b = name.encode("utf-8") + b"\0"
            heap_data.extend(b + b"\0" * (_pad8(len(b)) - len(b)))
        data_addr = self.alloc(bytes(heap_data))
        heap = self.alloc(b"HEAP" + bytes(4) + struct.pack(
            "<QQQ", len(heap_data), 1, data_addr))
        per = 2 * self.leaf_k
        groups = [names[i:i + per] for i in range(0, len(names), per)]
        snods = []
        for g in groups:
            body = b"SNOD" + struct.pack("<BBH", 1, 0, len(g))
            for name in g:
                body += struct.pack("<QQII16x", offsets[name],
                                    children[name], 0, 0)
            body += bytes(40 * (per - len(g)))
            snods.append(self.alloc(body))
        node_b = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(snods), UNDEF,
                                       UNDEF)
        node_b += struct.pack("<Q", 0)
        for g, s in zip(groups, snods):
            node_b += struct.pack("<QQ", s, offsets[g[-1]])
        k = 2 * self.internal_k
        node_b += bytes(16 * (k - len(snods)))
        btree = self.alloc(node_b)
        obj = self.header([(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap))])
        return obj, btree, heap

    def write(self, path: str) -> None:
        obj, btree, heap = self.group(self.tree)
        eof = len(self.out)
        sb = SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
        sb += struct.pack("<HHI", self.leaf_k, self.internal_k, 0)
        sb += struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
        sb += struct.pack("<QQII", 0, obj, 1, 0) + struct.pack(
            "<QQ", btree, heap)
        assert len(sb) == 96
        self.out[:96] = sb
        with open(path, "wb") as f:
            f.write(self.out)


# ================================================================== File ==

class File(Group):
    """``File(path, "r")`` reads, ``File(path, "w")`` writes at close (or at
    the end of a ``with`` block)."""

    def __init__(self, path, mode: str = "r"):
        self.path, self.mode = os.fspath(path), mode
        if mode == "r":
            reader = _Reader(self.path)
            super().__init__(reader, reader.root, "/")
        elif mode == "w":
            self._tree: dict = {}
            self._r = None
        else:
            raise ValueError(f"{self.path}: mode {mode!r} (only 'r' and 'w')")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def create_dataset(self, name: str, data=None) -> None:
        if self.mode != "w":
            raise HDF5Error(f"{self.path}: not open for writing")
        parts = [p for p in name.split("/") if p]
        node = self._tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise HDF5Error(f"{self.path}: {p!r} is a dataset")
        if parts[-1] in node:
            raise HDF5Error(f"{self.path}: {name!r} exists")
        arr = np.array(data)
        _datatype_message(arr.dtype)             # refuse what cannot be written
        node[parts[-1]] = arr

    def __getitem__(self, name: str):
        if self.mode == "w":
            raise HDF5Error(f"{self.path}: open for writing")
        return super().__getitem__(name)

    def keys(self):
        return sorted(self._tree) if self.mode == "w" else super().keys()

    def close(self) -> None:
        if self.mode == "w":
            if self._tree is not None:
                _Writer(self._tree).write(self.path)
                self._tree = None
        elif self._r is not None:
            self._r.close()
