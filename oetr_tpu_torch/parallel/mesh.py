"""Device meshes, placements and the model's parallel layout (port of
``oetr_tpu/parallel/mesh.py``).

A mesh is a ``DeviceMesh`` over the ranks of the process group with named
axes. JAX's shardings become placements (``Shard(0)``, ``Replicate()``),
and XLA's inserted collectives become torch's parallel wrappers:
``shard_model`` splits the transformer's projections Megatron-style over
a 'model' axis (``parallelize_module`` with column and row styles), shards
every parameter over an 'fsdp' axis (FSDP2's ``fully_shard``), and
replicates over 'data' (DDP when nothing else applies).
"""
from __future__ import annotations

import math
import re
from typing import Mapping, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from .multihost import backend_for, rank_device


def _ensure_group(device_type: str) -> None:
    """One process with no group: a group of one over an in-memory store
    (JAX's mesh needs no runtime in one process; torch's does)."""
    if dist.is_initialized():
        return
    backend = backend_for(device_type)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = torch.device("cuda",
                                           torch.cuda.current_device())
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, **kwargs)


def make_mesh(axis_sizes: Mapping[str, int] | None = None,
              device_type: str | None = None):
    """A mesh over the group's ranks; by default every rank on one 'data'
    axis. ``axis_sizes`` maps axis name -> size in order, e.g.
    ``{"data": 2, "model": 2}``; -1 fills with the ranks left. A mesh
    smaller than the group takes its first ranks. ``device_type`` 'cuda'
    (the default) or 'cpu'."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    device_type = device_type or "cuda"
    _ensure_group(device_type)
    world = dist.get_world_size()
    if not axis_sizes:
        axis_sizes = {"data": world}
    names = list(axis_sizes)
    sizes = [int(axis_sizes[n]) for n in names]
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = world // known
    total = math.prod(sizes)
    if total > world or total < 1:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, have {world}")
    if total == world:
        return init_device_mesh(device_type, tuple(sizes),
                                mesh_dim_names=tuple(names))
    return DeviceMesh(device_type, torch.arange(total).reshape(sizes),
                      mesh_dim_names=tuple(names))


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh (a mapping passes through)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def data_sharding(mesh, axis: str = "data") -> tuple:
    """Placements of a [B, ...] tensor split on ``axis``: ``Shard(0)`` on
    that mesh dimension, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(0) if n == axis else Replicate()
                 for n in mesh.mesh_dim_names)


def replicated(mesh) -> tuple:
    """Placements of a tensor every rank holds whole."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def shard_batch(batch: Mapping, mesh, axis: str = "data") -> dict:
    """This rank's rows of a global batch: the leading dimension split in
    equal blocks over ``axis`` (it must divide), the block of this rank's
    coordinate on that axis, as tensors on the mesh's device."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    idx = mesh.get_local_rank(axis)
    dev = rank_device(mesh.device_type)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if t.shape[0] % n:
            raise ValueError(f"{k}: {t.shape[0]} rows do not split over "
                             f"{axis}={n}")
        rows = t.shape[0] // n
        out[k] = t[idx * rows:(idx + 1) * rows].to(dev)
    return out


# ---------------------------------------------------------------------------
# Tensor-parallel / FSDP partition rules
# ---------------------------------------------------------------------------
#
# JAX's rules on flax paths ("transformer/enc_self_0/q_proj/kernel", kernel
# [in, out]) rewritten on the port's parameter names, which are the flax
# paths joined by dots with "kernel" as "weight" [out, in]
# (interop/from_flax.py). A spec names one mesh axis (or None) per
# dimension of the torch tensor: a column split of a kernel, P(None,
# "model"), is ("model", None) on the weight.

#: (regex on the parameter name, spec) - the first match wins.
OETR_PARTITION_RULES: list[tuple[str, tuple]] = [
    # Attention in/out projections (encoder + decoder).
    (r"[qkv]_proj\.weight$", ("model", None)),
    (r"[qkv]_proj\.bias$", ("model",)),
    (r"merge\.weight$", (None, "model")),
    # Transformer MLPs: Dense_0 = fc1 (column), Dense_1 = fc2 (row).
    (r"Dense_0\.weight$", ("model", None)),
    (r"Dense_1\.weight$", (None, "model")),
]


def _spec_fits(shape: tuple[int, ...], spec: tuple,
               sizes: Mapping[str, int]) -> bool:
    if len(spec) > len(shape):
        return False
    for dim, names in zip(shape, spec):
        if names is None:
            continue
        names = (names,) if isinstance(names, str) else names
        if dim % math.prod(sizes[n] for n in names) != 0:
            return False
    return True


def _fsdp_spec(shape: tuple[int, ...], axis: str, sizes: Mapping[str, int],
               min_size: int = 2) -> tuple:
    """Shard the largest divisible dimension over ``axis`` (ZeRO-3)."""
    size = sizes[axis]
    best = None
    for i, dim in enumerate(shape):
        if dim >= min_size and dim % size == 0:
            if best is None or dim > shape[best]:
                best = i
    if best is None:
        return ()
    return tuple(axis if i == best else None for i in range(len(shape)))


def param_shardings(params, mesh, rules: Sequence | None = None,
                    fsdp_axis: str | None = None) -> dict[str, tuple]:
    """{parameter name: spec} for a module (or a {name: tensor} mapping):
    JAX's ``param_shardings``. Each name is matched against ``rules`` (the
    first match wins; a rule naming an axis the mesh lacks, or one that does
    not divide the dimension, falls through); what no rule takes is
    sharded over ``fsdp_axis`` on its largest divisible dimension when that
    axis is given, else replicated (the empty spec). ``mesh`` is a
    DeviceMesh or a mapping {axis: size}."""
    sizes = mesh_shape(mesh)
    rules = list(OETR_PARTITION_RULES if rules is None else rules)
    named = (params.named_parameters() if isinstance(params, nn.Module)
             else params.items())
    out = {}
    for name, p in named:
        shape = tuple(p.shape)
        spec = None
        for pat, rule_spec in rules:
            if re.search(pat, name):
                axes = [a for ax in rule_spec if ax is not None
                        for a in ((ax,) if isinstance(ax, str) else ax)]
                if all(a in sizes for a in axes) and \
                        _spec_fits(shape, rule_spec, sizes):
                    spec = tuple(rule_spec)
                break
        if spec is None:
            spec = (_fsdp_spec(shape, fsdp_axis, sizes)
                    if fsdp_axis is not None and fsdp_axis in sizes and shape
                    else ())
        out[name] = spec
    return out


def _tp_axis(spec: tuple) -> str | None:
    names = [n for n in spec if n is not None]
    return names[0] if names else None


def _tp_plan(model: nn.Module, specs: dict[str, tuple],
             fsdp_axis: str | None):
    """{module name: 'colwise' | 'rowwise'} from the weights' specs (those
    over another axis than ``fsdp_axis``), and the axis they split; checks that the splits pair up as Megatron's do
    (q, k, v by column with merge by row; Dense_0 by column with Dense_1
    by row), and refuses an encoder layer on K2."""
    plan, axis = {}, None
    for name, spec in specs.items():
        if not name.endswith(".weight") or _tp_axis(spec) in (None,
                                                              fsdp_axis):
            continue
        if axis is not None and _tp_axis(spec) != axis:
            raise ValueError("tensor parallelism over one axis only, got "
                             f"{axis!r} and {_tp_axis(spec)!r}")
        axis = _tp_axis(spec)
        if len(spec) != 2:
            raise ValueError(f"{name}: only Dense weights split, got {spec}")
        plan[name[:-len(".weight")]] = ("colwise" if spec[0] is not None
                                        else "rowwise")
    for parent_name, parent in model.named_modules():
        pre = f"{parent_name}." if parent_name else ""
        has = {c: plan.get(pre + c) for c in ("q_proj", "k_proj", "v_proj",
                                              "merge", "Dense_0", "Dense_1")}
        attn = [has[c] for c in ("q_proj", "k_proj", "v_proj", "merge")]
        if any(attn) and attn != ["colwise"] * 3 + ["rowwise"]:
            raise ValueError(f"{parent_name}: q/k/v must split by column "
                             f"and merge by row together, got {attn}")
        mlp = [has["Dense_0"], has["Dense_1"]]
        if any(mlp) and mlp != ["colwise", "rowwise"]:
            raise ValueError(f"{parent_name}: Dense_0 must split by column "
                             f"and Dense_1 by row together, got {mlp}")
        if any(attn) and getattr(parent, "attention", "") == "linear:cuda" \
                and hasattr(parent, "pre_norm_q"):
            raise ValueError(
                f"{parent_name}: attention 'linear:cuda' runs the encoder "
                "sublayer as one kernel (K2) on the whole q/k/v weights, "
                "which tensor parallelism splits by column; build the "
                "model with attention='linear' for a 'model' axis")
    return plan, axis


def shard_model(model: nn.Module, mesh, rules: Sequence | None = None,
                fsdp_axis: str | None = None, data_axis: str = "data"
                ) -> tuple[nn.Module, dict[str, tuple]]:
    """Lay ``model`` out on ``mesh`` in place: (the module a step calls,
    the specs of ``param_shardings``).

    Where a rule splits a Dense weight over an axis of the mesh, that Dense
    runs column- or row-parallel over it (``parallelize_module``; each
    attention block then holds its share of the heads). With
    ``fsdp_axis`` every parameter is sharded over it by FSDP2
    (``fully_shard``, on the dimension JAX's rule picks where one divides),
    replicated over ``data_axis`` (HSDP). With neither, the model runs
    under DDP over ``data_axis``. Parameters become new objects under
    tensor parallelism and FSDP: build the optimizer after this call.
    """
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel,
                                                   parallelize_module)

    names = tuple(mesh.mesh_dim_names)
    specs = param_shardings(model, mesh, rules, fsdp_axis)
    plan, tp_axis = _tp_plan(model, specs, fsdp_axis)
    if plan:
        tp = mesh.size(names.index(tp_axis))
        for parent_name, parent in model.named_modules():
            pre = f"{parent_name}." if parent_name else ""
            if plan.get(pre + "q_proj"):
                if parent.nhead % tp:
                    raise ValueError(f"{parent_name}: {parent.nhead} heads "
                                     f"do not split over {tp_axis}={tp}")
                parent.nhead //= tp
                parent.d_model //= tp
        styles = {"colwise": ColwiseParallel, "rowwise": RowwiseParallel}
        parallelize_module(model, mesh[tp_axis],
                           {k: styles[v]() for k, v in plan.items()})
    if fsdp_axis is not None and fsdp_axis in names:
        dims = {}
        for name, p in model.named_parameters():
            # FSDP2 shards contiguous storage (conv weights are kept
            # channels_last); its all-gathered weights are contiguous too.
            p.data = p.data.contiguous()
            spec = specs[name]
            dims[id(p)] = (spec.index(fsdp_axis) if fsdp_axis in spec
                           else 0)
        dp_mesh = (mesh[data_axis, fsdp_axis] if data_axis in names
                   else mesh[fsdp_axis])
        fully_shard(model, mesh=dp_mesh,
                    shard_placement_fn=lambda p: Shard(dims.get(id(p), 0)))
        _forget_rounded_each_forward(model)
        return model, specs
    if plan:
        # DDP takes no DTensor: FSDP2 over 'data' carries the data
        # parallelism of a tensor-parallel model.
        if data_axis in names:
            for p in model.parameters():
                p.data = p.data.contiguous()
            fully_shard(model, mesh=mesh[data_axis])
            _forget_rounded_each_forward(model)
        return model, specs
    return _data_parallel(model, mesh[data_axis].get_group()
                         if data_axis in names else None), specs


def _forget_rounded_each_forward(model: nn.Module) -> None:
    """K2's cache of bf16 weights is keyed on (id, version, address); FSDP2
    gathers each forward's weights into the same parameters without a
    version bump, so the cache is dropped before every forward."""
    from ..ops.linear_encoder import forget_rounded_weights
    model.register_forward_pre_hook(lambda *_: forget_rounded_weights())


def _data_parallel(model: nn.Module, group=None) -> nn.Module:
    """``model`` under DDP over ``group`` (the default group when None), on
    the rank's card or the CPU as its parameters lie. Every parameter need
    not take part in every step (the forward's options), as in JAX."""
    from torch.nn.parallel import DistributedDataParallel as DDP
    dev = next(model.parameters()).device
    return DDP(model, device_ids=[dev] if dev.type == "cuda" else None,
               process_group=group, broadcast_buffers=False,
               find_unused_parameters=True)
