"""flax param tree -> the port's state_dict.

The port names its submodules after flax's scopes, so a leaf's key is its
flax path joined by dots, with the leaf renamed and its layout changed:
conv ``kernel`` HWIO -> ``weight`` OIHW, Dense ``kernel`` [in, out] ->
``weight`` [out, in], LayerNorm/GroupNorm/FrozenBatchNorm ``scale`` ->
``weight``, ``bias``, FrozenBatchNorm's ``mean`` and ``var``,
``query_embed1/2`` and SuperGlue's scalar ``bin_score`` as they are. The fused kernels' modules use the plain branches' names, so one map
serves both switches. Every leaf is used once and every parameter set.

``to_flax(state, model)`` is the inverse: the port's state_dict (or any
tree of tensors keyed by its parameter names, e.g. Adam's moments) -> the
flax tree, each leaf's kind read from the module that owns it (``Conv``,
``Dense``, a norm), so ``to_flax(convert_flax_params(p, cfg),
build_oetr(cfg, device="meta")) == p`` bit for bit.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ..config import OETRConfig
from ..models.aslfeat import build_aslfeat
from ..models.cotr import build_cotr
from ..models.d2net import build_d2net
from ..models.disk import build_disk
from ..models.fcos import build_fcos_head
from ..models.layers import Conv, Dense, GroupNorm, LayerNorm
from ..models.loftr import build_loftr
from ..models.oetr import PatchEmbed, build_oetr
from ..models.r2d2 import build_r2d2
from ..models.resnet import FrozenBatchNorm, FusedGNPool
from ..models.sift_based import build_contextdesc, build_contextdesc_augmenter
from ..models.superglue import build_superglue
from ..models.superpoint import build_superpoint, build_superpoint_net
from ..models.transformer import ChannelAttention, SpatialAttention

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
    elif leaf in ("bias", "mean", "var") or path in _AS_IS:
        # (mean and var: a FrozenBatchNorm's statistics)
        return ".".join(path), arr
    raise KeyError(f"flax leaf {'/'.join(path)} {arr.shape}: no rule maps it "
                   "to a port parameter")


def _float32_cpu(arr) -> torch.Tensor:
    """A contiguous float32 CPU copy (torch's copy: threaded)."""
    if not isinstance(arr, torch.Tensor):
        arr = np.asarray(arr)
        arr = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    return arr.detach().to(device="cpu", dtype=torch.float32, copy=True,
                           memory_format=torch.contiguous_format)


def checked_state(items, model) -> dict:
    """The strict state_dict of ``model`` (built on the meta device) from
    ``items``, (port key, array or tensor, where it came from) triples:
    float32 CPU tensors. Every parameter must be set exactly once: raises
    KeyError on a key the model lacks, on a key set twice and on a
    parameter left unset, ValueError on a shape mismatch."""
    expected = {name: tuple(p.shape) for name, p in model.named_parameters()}
    state = {}
    for key, arr, origin in items:
        if key not in expected:
            raise KeyError(f"{origin} maps to {key}, which the port's model "
                           "does not have")
        if key in state:
            raise KeyError(f"{origin} maps to {key}, which is set already")
        if tuple(arr.shape) != expected[key]:
            raise ValueError(f"{key}: {origin} gives {tuple(arr.shape)}, the "
                             f"port expects {expected[key]}")
        state[key] = _float32_cpu(arr)
    missing = sorted(set(expected) - set(state))
    if missing:
        raise KeyError(f"port parameters left unset: {missing}")
    return state


def _state_dict(tree: Mapping, model) -> dict:
    """The strict state_dict of ``model`` (built on the meta device) from a
    flax tree: float32 CPU tensors."""
    return checked_state(
        ((*_convert_leaf(path, np.asarray(leaf)),
          f"flax leaf {'/'.join(path)}") for path, leaf in _flatten(tree)),
        model)


def _unwrap(params: Mapping) -> Mapping:
    return params["params"] if "params" in params else params


def flax_state_dict(tree: Mapping, model) -> dict:
    """The strict state_dict of ``model`` (any port module; the meta device
    will do) from its flax tree, with or without the ``"params"`` key:
    float32 CPU tensors. Raises as ``convert_flax_params`` does."""
    return _state_dict(_unwrap(tree), model)


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


def convert_superpoint_net_params(params: Mapping, **kwargs) -> dict:
    """A flax SuperPoint tree (the bare ``SuperPointNet``'s, or the
    extractor's with its layers under ``net``) -> the state_dict of the
    port's raw ``SuperPointNet(**kwargs)``, the network the trainers
    train. Raises as ``convert_flax_params`` does."""
    tree = _unwrap(params)
    if "net" in tree:
        tree = tree["net"]
    return _state_dict(tree, build_superpoint_net(device="meta", **kwargs))


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


def _converter(builder, model_name: str):
    def convert(params: Mapping, **kwargs) -> dict:
        return _state_dict(_unwrap(params), builder(device="meta", **kwargs))

    convert.__name__ = f"convert_{model_name.lower()}_params"
    convert.__doc__ = (f"A flax {model_name} tree -> the state_dict of the "
                       f"port's ``{model_name}(**kwargs)``. Raises as "
                       "``convert_flax_params`` does.")
    return convert


# The extractors' ``in_channels`` must be the channels the flax tree was
# initialised on (1 on the pipeline's path, which feeds grayscale crops).
convert_d2net_params = _converter(build_d2net, "D2Net")
convert_r2d2_params = _converter(build_r2d2, "R2D2")
convert_disk_params = _converter(build_disk, "DISK")
convert_aslfeat_params = _converter(build_aslfeat, "ASLFeat")
convert_cotr_params = _converter(build_cotr, "COTR")
convert_contextdesc_params = _converter(build_contextdesc, "ContextDesc")
convert_contextdesc_augmenter_params = _converter(
    build_contextdesc_augmenter, "ContextDescAugmenter")
# ``in_channels`` must be the channels the flax tree was initialised on.
convert_fcos_params = _converter(build_fcos_head, "FCOSHead")


def _module_converter(cls):
    def convert(params: Mapping, **kwargs) -> dict:
        with torch.device("meta"):
            model = cls(**kwargs)
        return _state_dict(_unwrap(params), model)

    convert.__name__ = f"convert_{cls.__name__.lower()}_params"
    convert.__doc__ = (f"A flax {cls.__name__} tree -> the state_dict of the "
                       f"port's ``{cls.__name__}(**kwargs)`` (its input "
                       "widths must be the tree's). Raises as "
                       "``convert_flax_params`` does.")
    return convert


# OETR's component-parity modules, which no model of the port builds.
convert_patchembed_params = _module_converter(PatchEmbed)
convert_channelattention_params = _module_converter(ChannelAttention)
convert_spatialattention_params = _module_converter(SpatialAttention)


# ------------------------------------------------------- port -> flax --

_NORMS = (LayerNorm, GroupNorm, FrozenBatchNorm, FusedGNPool)


def _flax_leaf(module, name: str, leaf: str, arr: torch.Tensor):
    """(flax leaf name, tensor view) of parameter ``leaf`` of ``module``."""
    if leaf == "weight" and isinstance(module, Conv) and arr.ndim == 4:
        return "kernel", arr.permute(2, 3, 1, 0)
    if leaf == "weight" and isinstance(module, Dense) and arr.ndim == 2:
        return "kernel", arr.t()
    if leaf == "weight" and isinstance(module, _NORMS):
        return "scale", arr
    if leaf == "bias" or (leaf in ("mean", "var")
                          and isinstance(module, FrozenBatchNorm)) \
            or (leaf,) in _AS_IS and "." not in name:
        return leaf, arr
    raise KeyError(f"port parameter {name} {tuple(arr.shape)} of "
                   f"{type(module).__name__}: no rule maps it to a flax leaf")


def to_flax(state, model, wrap: bool = True) -> dict:
    """The flax tree of ``state`` ({port parameter name: tensor or array})
    for ``model`` (any port module; the meta device will do): float32
    numpy leaves under ``{"params": ...}`` (the bare tree with ``wrap``
    False). Every parameter of ``model`` must be in ``state`` exactly
    once: raises KeyError on a name the model lacks or a parameter left
    out, ValueError on a shape mismatch."""
    owners = {}
    for mname, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            name = f"{mname}.{leaf}" if mname else leaf
            owners[name] = (module, leaf, tuple(p.shape))
    tree: dict = {}
    for name, t in state.items():
        if name not in owners:
            raise KeyError(f"{name} is not a parameter of the port's "
                           f"{type(model).__name__}")
        module, leaf, shape = owners[name]
        if hasattr(t, "full_tensor"):           # a DTensor: the whole one
            t = t.full_tensor()
        t = t if isinstance(t, torch.Tensor) else torch.from_numpy(
            np.array(t, np.float32))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {tuple(t.shape)} given, the port's "
                             f"model has {shape}")
        key, view = _flax_leaf(module, name, leaf, t.detach())
        node = tree
        for part in name.split(".")[:-1]:
            node = node.setdefault(part, {})
        node[key] = _float32_cpu(view).numpy()
    missing = sorted(set(owners) - set(state))
    if missing:
        raise KeyError(f"port parameters missing from the state: {missing}")
    return {"params": tree} if wrap else tree
