"""flax param tree -> the port's state_dict.

The port names its submodules after flax's scopes, so a leaf's key is its
flax path joined by dots, with the leaf renamed and its layout changed:
conv ``kernel`` HWIO -> ``weight`` OIHW, Dense ``kernel`` [in, out] ->
``weight`` [out, in], LayerNorm/GroupNorm ``scale`` -> ``weight``,
``bias`` and ``query_embed1/2`` as they are. The fused kernels' modules use
the plain branches' names, so one map serves both switches.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ..config import OETRConfig
from ..models.oetr import build_oetr


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, val


def _convert_leaf(path: tuple[str, ...], arr: np.ndarray):
    leaf = path[-1]
    if leaf == "kernel":
        if arr.ndim == 4:
            return ".".join(path[:-1] + ("weight",)), arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:
            return ".".join(path[:-1] + ("weight",)), arr.T
    elif leaf == "scale":
        return ".".join(path[:-1] + ("weight",)), arr
    elif leaf == "bias" or path in (("query_embed1",), ("query_embed2",)):
        return ".".join(path), arr
    raise KeyError(f"flax leaf {'/'.join(path)} {arr.shape}: no rule maps it "
                   "to a port parameter")


def convert_flax_params(params: Mapping, cfg: OETRConfig) -> dict:
    """Map a flax OETR param tree (nested dicts of numpy arrays, with or
    without the top-level ``"params"`` key) to a state_dict of the port's
    ``OETR(cfg)``: float32 CPU tensors.

    Raises KeyError on a leaf that maps to no port parameter and on a port
    parameter that no leaf sets, ValueError on a shape mismatch.
    """
    tree = params["params"] if "params" in params else params
    expected = {name: tuple(p.shape) for name, p in
                build_oetr(cfg, device="meta").named_parameters()}
    state = {}
    for path, leaf in _flatten(tree):
        key, arr = _convert_leaf(path, np.asarray(leaf))
        if key not in expected:
            raise KeyError(f"flax leaf {'/'.join(path)} maps to {key}, which "
                           "the port's model does not have")
        if arr.shape != expected[key]:
            raise ValueError(f"{key}: flax gives {arr.shape}, the port "
                             f"expects {expected[key]}")
        state[key] = torch.tensor(np.ascontiguousarray(arr),
                                  dtype=torch.float32)
    missing = sorted(set(expected) - set(state))
    if missing:
        raise KeyError(f"port parameters left unset: {missing}")
    return state
