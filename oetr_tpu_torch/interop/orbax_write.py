"""Orbax checkpoints written without orbax: ``write_checkpoint(path, tree)``.

The directory is what ``orbax.checkpoint.StandardCheckpointer().save``
writes with OCDBT and zarr v2 (``interop/orbax_read.py`` reads both):
``_METADATA`` (each leaf's tree path with its key kinds, 2 a mapping key, 1
a sequence index; arrays as ``jax.Array`` with their shapes, ``None`` as a
skipped ``"None"`` leaf, as orbax writes a flax or optax tree),
``_CHECKPOINT_METADATA``, and an OCDBT database (``interop/ocdbt.py``)
holding each array as one zarr v2 chunk, uncompressed, C order, under the
leaf's path joined by dots. ``StandardCheckpointer().restore(path,
target)`` restores it bit for bit, and JAX's ``load_checkpoint`` reads it
as a state JAX wrote.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from collections.abc import Mapping
from pathlib import Path

import numpy as np

from .ocdbt import write_store

_SEQUENCE_KEY, _DICT_KEY = 1, 2
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")


def _flatten(tree, path=()):
    """(keys, leaf) pairs in JAX's order (mapping keys sorted, sequences in
    index order); each key a (name, orbax key type) pair."""
    if isinstance(tree, Mapping):
        for k in sorted(tree, key=str):
            yield from _flatten(tree[k], path + ((str(k), _DICT_KEY),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + ((str(i), _SEQUENCE_KEY),))
    else:
        yield path, tree


def _array(leaf, where: str) -> np.ndarray:
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "fiub" or arr.dtype.itemsize not in (1, 2, 4, 8):
        raise ValueError(f"{where}: dtype {arr.dtype} is not a plain number "
                         "type")
    if arr.size == 0:
        raise ValueError(f"{where}: an empty array has no zarr chunk")
    return np.require(arr, arr.dtype.newbyteorder("<"), "C")


def _zarray(arr: np.ndarray) -> bytes:
    return json.dumps({
        "chunks": list(arr.shape), "compressor": None,
        "dimension_separator": ".", "dtype": arr.dtype.str,
        "fill_value": None, "filters": None, "order": "C",
        "shape": list(arr.shape), "zarr_format": 2},
        sort_keys=True, separators=(",", ":")).encode()


def write_checkpoint(path, tree) -> None:
    """Write ``tree`` (nested mappings and sequences of numpy arrays, numpy
    or Python scalars and ``None``) as an orbax checkpoint directory at
    ``path``. It is written under ``{path}.tmp`` (which no
    ``latest_checkpoint_step`` takes for a step) and renamed into place
    at the end, replacing one there."""
    path = Path(path)
    entries, items = {}, []
    for keys, leaf in _flatten(tree):
        if not keys:
            raise ValueError("the tree's root must be a mapping or sequence")
        names = tuple(k for k, _ in keys)
        if any("." in n or "/" in n for n in names):
            raise ValueError(f"tree path {names}: a key holds '.' or '/'")
        meta = [{"key": k, "key_type": t} for k, t in keys]
        if leaf is None:
            value = {"value_type": "None", "skip_deserialize": True}
        else:
            name = ".".join(names)
            arr = _array(leaf, f"tree path {names}")
            items.append((f"{name}/.zarray", _zarray(arr)))
            items.append((f"{name}/{'.'.join('0' * arr.ndim) or '0'}",
                          arr.reshape(-1).view(np.uint8)))
            value = {"value_type": "jax.Array", "skip_deserialize": False,
                     "write_shape": list(arr.shape)}
        entries[str(names)] = {"key_metadata": meta, "value_metadata": value}

    tmp = Path(f"{path}.tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    t0 = time.time_ns()
    write_store(tmp, items)
    (tmp / "_METADATA").write_text(json.dumps({
        "tree_metadata": entries, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True,
        "custom_metadata": None}))
    (tmp / "_CHECKPOINT_METADATA").write_text(json.dumps({
        "item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(),
        "custom_metadata": {}}))
    if path.exists():
        old = Path(f"{path}.old")
        if old.exists():
            shutil.rmtree(old)
        os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old)
    else:
        os.rename(tmp, path)
