"""Orbax checkpoints read without orbax: ``read_checkpoint(path)``.

An orbax ``StandardCheckpointer`` directory written with OCDBT holds
``_METADATA`` (JSON: each leaf's tree path) and an OCDBT database
(``interop/ocdbt.py``) of zarr v2 arrays: the leaf at path
``('params', 'conv1a', 'kernel')`` is the array ``params.conv1a.kernel``,
its ``.zarray`` JSON (shape, chunks, dtype, order, compressor, filters)
under key ``params.conv1a.kernel/.zarray`` and each chunk under
``params.conv1a.kernel/<i>.<j>...`` (``0`` for a scalar). The chunks are
zstd frames (``interop/zstd.py``).

The result is the tree that
``orbax.checkpoint.StandardCheckpointer().restore(path)`` gives (as
numpy): mapping keys (orbax's ``key_type`` 2) as dicts, sequence indices
(1: optax's state tuples) as lists, leaves saved as ``None`` (an optax
``EmptyState``; ``value_type "None"``, ``skip_deserialize``) as ``None``,
arrays as numpy arrays; so ``interop/from_flax.py``'s converters take its
parameter trees as they are. A dtype, compressor, filter, key kind, value
type or layout this reader does not know raises ValueError rather than
being guessed at.
"""
from __future__ import annotations

import itertools
import json
import math
from pathlib import Path

import numpy as np

from . import zstd
from .ocdbt import OcdbtStore

_SEQUENCE_KEY, _DICT_KEY = 1, 2     # orbax's key_types
_ARRAY_VALUES = ("jax.Array", "np.ndarray")


def _dtype(spec, where: str) -> np.dtype:
    if not (isinstance(spec, str) and len(spec) >= 3 and spec[0] in "<>|"
            and spec[1] in "fiub" and spec[2:].isdigit()):
        raise ValueError(f"{where}: dtype {spec!r} is not a plain number "
                         "type this reader knows")
    dt = np.dtype(spec)
    if dt.kind not in "fiub" or dt.itemsize not in (1, 2, 4, 8):
        raise ValueError(f"{where}: dtype {spec!r} unknown")
    return dt


def read_array(store: OcdbtStore, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store``, assembled from its
    chunks."""
    where = f"{store.root}/{name}"
    try:
        meta = json.loads(store.read(f"{name}/.zarray"))
    except KeyError:
        raise ValueError(f"{where}: no .zarray") from None
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{where}: zarr format {meta.get('zarr_format')} "
                         "is not 2")
    dtype = _dtype(meta.get("dtype"), where)
    shape = tuple(int(s) for s in meta["shape"])
    chunks = tuple(int(c) for c in meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ValueError(f"{where}: chunks {chunks} do not fit {shape}")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise ValueError(f"{where}: order {order!r} unknown")
    if meta.get("filters"):
        raise ValueError(f"{where}: filters {meta['filters']} unknown")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{where}: compressor {comp} unknown")
    if meta.get("dimension_separator", ".") != ".":
        raise ValueError(f"{where}: dimension separator "
                         f"{meta['dimension_separator']!r} unknown")

    chunk_bytes = math.prod(chunks) * dtype.itemsize
    out = np.empty(shape, dtype)
    one = f"{name}/{'.'.join('0' * len(shape)) or '0'}"
    if (comp is None and order == "C" and chunks == shape
            and one in store and store.size(one) == chunk_bytes):
        store.read_into(one, out.reshape(-1).view(np.uint8))
        return out         # one uncompressed chunk: read in place
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/{'.'.join(map(str, idx)) if idx else '0'}"
        sel = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(idx, chunks, shape))
        if key not in store:       # orbax writes every chunk
            raise ValueError(f"{where}: chunk {key} missing")
        raw = store.read(key)
        if comp is not None:
            raw = zstd.decompress(raw, chunk_bytes)
        if len(raw) != chunk_bytes:
            raise ValueError(f"{where}: chunk {key} holds {len(raw)} bytes, "
                             f"{chunk_bytes} expected")
        block = np.frombuffer(raw, dtype).reshape(chunks, order=order)
        out[sel] = block[tuple(slice(0, t.stop - t.start) for t in sel)]
    return out


def _lists(node):
    """The tree with each node keyed by sequence indices as a list."""
    if isinstance(node, _Seq):
        if set(node) != {str(i) for i in range(len(node))}:
            raise ValueError(f"sequence indices {sorted(node)} are not "
                             f"0 .. {len(node) - 1}")
        return [_lists(node[str(i)]) for i in range(len(node))]
    if isinstance(node, dict):
        return {k: _lists(node[k]) for k in sorted(node)}
    return node


class _Seq(dict):
    """A node keyed by sequence indices, made a list at the end."""


def read_checkpoint(path) -> dict:
    """The tree of an orbax checkpoint directory written with OCDBT and
    zarr v2: nested dicts (and lists) of numpy arrays and ``None``, keyed
    as ``_METADATA`` says."""
    path = Path(path)
    meta_path = path / "_METADATA"
    if not meta_path.is_file():
        raise FileNotFoundError(f"no orbax checkpoint: {meta_path} missing")
    meta = json.loads(meta_path.read_text())
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: zarr v3 arrays are not supported")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{path}: not an OCDBT checkpoint")
    store = OcdbtStore(path)
    tree = None
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        value = entry["value_metadata"]
        where = f"{path}: leaf {[k['key'] for k in keys]}"
        kinds = [k["key_type"] for k in keys]
        if not keys or any(t not in (_SEQUENCE_KEY, _DICT_KEY)
                           for t in kinds):
            raise ValueError(f"{where}: key types {kinds}: only mapping "
                             "keys and sequence indices are supported")
        names = [str(k["key"]) for k in keys]
        if value["value_type"] == "None" and value.get("skip_deserialize"):
            arr = None
        elif value["value_type"] in _ARRAY_VALUES and \
                not value.get("skip_deserialize"):
            arr = read_array(store, ".".join(names))
            if list(arr.shape) != list(value.get("write_shape", arr.shape)):
                raise ValueError(f"{where}: shape {arr.shape} differs from "
                                 f"the metadata's {value['write_shape']}")
        else:
            raise ValueError(f"{where}: value type {value['value_type']} "
                             "unknown")
        if tree is None:
            tree = _Seq() if kinds[0] == _SEQUENCE_KEY else {}
        node = tree
        for k, kind in zip([None, *names[:-1]], kinds):
            if k is not None:
                node = node.setdefault(k, _Seq() if kind == _SEQUENCE_KEY
                                       else {})
            if isinstance(node, _Seq) != (kind == _SEQUENCE_KEY):
                raise ValueError(f"{where}: a node keyed both by mapping "
                                 "keys and by sequence indices")
        if names[-1] in node:
            raise ValueError(f"{where}: given twice")
        node[names[-1]] = arr
    return _lists({} if tree is None else tree)
