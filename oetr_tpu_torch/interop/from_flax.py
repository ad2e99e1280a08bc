"""flax param tree -> the port's state_dict.

The port names its submodules after flax's scopes, so a leaf's key is its
flax path joined by dots, with the leaf renamed and its layout changed:
conv ``kernel`` HWIO -> ``weight`` OIHW, Dense ``kernel`` [in, out] ->
``weight`` [out, in], LayerNorm/GroupNorm ``scale`` -> ``weight``,
``bias``, ``query_embed1/2`` and SuperGlue's scalar ``bin_score`` as they
are. The fused kernels' modules use the plain branches' names, so one map
serves both switches. Every leaf is used once and every parameter set.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ..config import OETRConfig
from ..models.loftr import build_loftr
from ..models.oetr import build_oetr
from ..models.superglue import build_superglue
from ..models.superpoint import build_superpoint

_AS_IS = {("query_embed1",), ("query_embed2",), ("bin_score",)}


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
    elif leaf == "bias" or path in _AS_IS:
        return ".".join(path), arr
    raise KeyError(f"flax leaf {'/'.join(path)} {arr.shape}: no rule maps it "
                   "to a port parameter")


def _state_dict(tree: Mapping, model) -> dict:
    """The strict state_dict of ``model`` (built on the meta device) from a
    flax tree: float32 CPU tensors."""
    expected = {name: tuple(p.shape) for name, p in model.named_parameters()}
    state = {}
    for path, leaf in _flatten(tree):
        key, arr = _convert_leaf(path, np.asarray(leaf))
        if key not in expected:
            raise KeyError(f"flax leaf {'/'.join(path)} maps to {key}, which "
                           "the port's model does not have")
        if arr.shape != expected[key]:
            raise ValueError(f"{key}: flax gives {arr.shape}, the port "
                             f"expects {expected[key]}")
        # (ascontiguousarray makes a 0-d leaf 1-d: reshape it back)
        state[key] = torch.tensor(np.ascontiguousarray(arr).reshape(arr.shape),
                                  dtype=torch.float32)
    missing = sorted(set(expected) - set(state))
    if missing:
        raise KeyError(f"port parameters left unset: {missing}")
    return state


def _unwrap(params: Mapping) -> Mapping:
    return params["params"] if "params" in params else params


def convert_flax_params(params: Mapping, cfg: OETRConfig) -> dict:
    """Map a flax OETR param tree (nested dicts of numpy arrays, with or
    without the top-level ``"params"`` key) to a state_dict of the port's
    ``OETR(cfg)``: float32 CPU tensors.

    Raises KeyError on a leaf that maps to no port parameter and on a port
    parameter that no leaf sets, ValueError on a shape mismatch.
    """
    return _state_dict(_unwrap(params), build_oetr(cfg, device="meta"))


def convert_superpoint_params(params: Mapping, **kwargs) -> dict:
    """A flax SuperPoint tree -> the state_dict of the port's
    ``SuperPoint(**kwargs)``. The tree may be the whole extractor's (its
    layers under ``net``) or the bare ``SuperPointNet``'s. Raises as
    ``convert_flax_params`` does."""
    tree = _unwrap(params)
    if "net" in tree:
        tree = tree["net"]
    model = build_superpoint(device="meta", **kwargs)
    return {f"net.{k}": v for k, v in _state_dict(tree, model.net).items()}


def convert_superglue_params(params: Mapping, **kwargs) -> dict:
    """A flax SuperGlue tree -> the state_dict of the port's
    ``SuperGlue(**kwargs)``, ``bin_score`` included. Raises as
    ``convert_flax_params`` does."""
    return _state_dict(_unwrap(params),
                       build_superglue(device="meta", **kwargs))


def convert_loftr_params(params: Mapping, **kwargs) -> dict:
    """A flax LoFTR tree -> the state_dict of the port's
    ``LoFTR(**kwargs)`` (``backbone``, ``coarse``, ``fine`` and
    ``fine_proj``). Raises as ``convert_flax_params`` does."""
    return _state_dict(_unwrap(params), build_loftr(device="meta", **kwargs))
