"""Reference OETR ``state_dict`` -> the port's state_dict (port of
``oetr_tpu/interop/torch_convert.py``).

The reference's released checkpoints hold a torch ``state_dict`` of its
OETR (a torchvision BatchNorm ResNet backbone). The port is built with
``BackboneConfig(norm='bn')`` (frozen BatchNorm: the running statistics
are parameters) and names its modules after the flax model's scopes, so
the layouts are torch's already: the conversion renames and never
transposes. The name map (reference -> port) is the JAX converter's:

  backbone.encoder.conv1 / bn1        -> backbone.Conv_0, FrozenBatchNorm_0
  backbone.encoder.layerL.b.convC/bnC -> backbone.<Block>_n.Conv_{C-1} /
                                         FrozenBatchNorm_{C-1}, n = blocks
                                         before layerL + b
    downsample.0 / downsample.1       ->   Conv_k / FrozenBatchNorm_k, k =
                                           the block's conv count
  BatchNorm weight/bias/running_mean/running_var -> weight/bias/mean/var
  input_proj(2), patchmerging.norm / reductions.i
                                      -> input_proj(2),
                                         patchmerging.LayerNorm_0 / reduction_i
  query_embedK.weight                 -> query_embedK
  transformer.encoder.{2i} | {2i+1}   -> transformer.enc_self_i | enc_cross_i
    mlp.0 / mlp.2                     ->   Dense_0 / Dense_1
  transformer.decoder.layers.j        -> transformer.dec_j
    self_attn | multihead_attn        ->   self_attn | cross_attn
  heatmap_conv.0 / 1 / 3              -> hm_conv1 / hm_gn / hm_conv2
  tlbr_reg.0 / tlbr_reg.2             -> tlbr_fc1 / tlbr_fc2

Keys the reference holds and the port does not read, as JAX's converter:
the ``backbone.layer0..4.*`` aliases of ``backbone.encoder.*``, the
classifier ``backbone.encoder.fc``, BatchNorm's ``num_batches_tracked``
and the projections a reference decoder layer declares and never calls
(``q_proj``, ``k_proj``, ``v_proj``, ``merge`` on the layer itself).
"""
from __future__ import annotations

from collections.abc import Mapping

import torch

from ..config import BackboneConfig, OETRConfig
from ..models.oetr import build_oetr
from ..models.resnet import RESNET_SPECS, STAGE_COUNT
from .from_flax import checked_state


class MissingReferenceKey(KeyError):
    """A key the conversion needs is not in the reference state_dict."""


def _name_pairs(cfg: OETRConfig, optional) -> list[tuple[str, str]]:
    """(port key, reference key) for every parameter of the port's
    ``OETR(cfg)``; ``optional(port_key, ref_key)`` says whether a block's
    downsample branch and each patch-merging reduction are there (JAX's
    converter asks the reference state_dict)."""
    pairs: list[tuple[str, str]] = []

    def bn(port: str, ref: str):
        for leaf, ref_leaf in (("weight", "weight"), ("bias", "bias"),
                               ("mean", "running_mean"),
                               ("var", "running_var")):
            pairs.append((f"{port}.{leaf}", f"{ref}.{ref_leaf}"))

    def affine(port: str, ref: str, bias: bool = True):
        pairs.append((f"{port}.weight", f"{ref}.weight"))
        if bias:
            pairs.append((f"{port}.bias", f"{ref}.bias"))

    enc = "backbone.encoder"
    affine("backbone.Conv_0", f"{enc}.conv1", bias=False)
    bn("backbone.FrozenBatchNorm_0", f"{enc}.bn1")
    kind, stages = RESNET_SPECS[cfg.backbone.depth]
    block = "BasicBlock" if kind == "basic" else "Bottleneck"
    n_convs = 2 if kind == "basic" else 3
    n = 0
    for stage in range(STAGE_COUNT[cfg.backbone.stop_layer]):
        for b in range(stages[stage]):
            ref, port = f"{enc}.layer{stage + 1}.{b}", f"backbone.{block}_{n}"
            for c in range(n_convs):
                affine(f"{port}.Conv_{c}", f"{ref}.conv{c + 1}", bias=False)
                bn(f"{port}.FrozenBatchNorm_{c}", f"{ref}.bn{c + 1}")
            if optional(f"{port}.Conv_{n_convs}.weight",
                        f"{ref}.downsample.0.weight"):
                affine(f"{port}.Conv_{n_convs}", f"{ref}.downsample.0",
                       bias=False)
                bn(f"{port}.FrozenBatchNorm_{n_convs}", f"{ref}.downsample.1")
            n += 1

    affine("input_proj", "input_proj")
    affine("input_proj2", "input_proj2")
    affine("patchmerging.LayerNorm_0", "patchmerging.norm")
    i = 0
    while optional(f"patchmerging.reduction_{i}.weight",
                   f"patchmerging.reductions.{i}.weight"):
        affine(f"patchmerging.reduction_{i}", f"patchmerging.reductions.{i}")
        i += 1
    pairs += [("query_embed1", "query_embed1.weight"),
              ("query_embed2", "query_embed2.weight")]
    affine("hm_conv1", "heatmap_conv.0")
    affine("hm_gn", "heatmap_conv.1")
    affine("hm_conv2", "heatmap_conv.3")
    affine("tlbr_fc1", "tlbr_reg.0", bias=False)
    affine("tlbr_fc2", "tlbr_reg.2")

    def encoder_layer(port: str, ref: str):
        for p in ("q_proj", "k_proj", "v_proj", "merge"):
            affine(f"{port}.{p}", f"{ref}.{p}", bias=False)
        affine(f"{port}.Dense_0", f"{ref}.mlp.0", bias=False)
        affine(f"{port}.Dense_1", f"{ref}.mlp.2", bias=False)
        for norm in ("pre_norm_q", "pre_norm_kv", "norm2"):
            affine(f"{port}.{norm}", f"{ref}.{norm}")

    for li in range(cfg.neck.num_layers):
        encoder_layer(f"transformer.enc_self_{li}",
                      f"transformer.encoder.{2 * li}")
        encoder_layer(f"transformer.enc_cross_{li}",
                      f"transformer.encoder.{2 * li + 1}")

    def attention(port: str, ref: str):
        for p in ("q_proj", "k_proj", "v_proj"):
            affine(f"{port}.{p}", f"{ref}.{p}")
        affine(f"{port}.merge", f"{ref}.merge", bias=False)

    for lj in range(cfg.neck.num_decoder_layers):
        ref, port = f"transformer.decoder.layers.{lj}", f"transformer.dec_{lj}"
        attention(f"{port}.self_attn", f"{ref}.self_attn")
        attention(f"{port}.cross_attn", f"{ref}.multihead_attn")
        affine(f"{port}.Dense_0", f"{ref}.mlp.0", bias=False)
        affine(f"{port}.Dense_1", f"{ref}.mlp.2", bias=False)
        for norm in ("norm1", "norm2", "norm3"):
            affine(f"{port}.{norm}", f"{ref}.{norm}")
    return pairs


def reference_name_map(state_dict: Mapping, cfg: OETRConfig
                       ) -> list[tuple[str, str]]:
    """(port key, reference key) for every parameter of the port's
    ``OETR(cfg)``, the blocks' downsample branches and the patch-merging
    reductions where ``state_dict`` has them, as in JAX. Raises
    MissingReferenceKey on any other key the map needs."""
    pairs = _name_pairs(cfg, lambda port, ref: ref in state_dict)
    for _, ref in pairs:
        if ref not in state_dict:
            raise MissingReferenceKey(
                f"reference state_dict missing {ref!r}")
    return pairs


def _bn_config(cfg: OETRConfig | None) -> OETRConfig:
    cfg = cfg or OETRConfig(backbone=BackboneConfig(norm="bn"))
    if cfg.backbone.norm != "bn" or cfg.backbone.stem_s2d:
        raise ValueError("a reference checkpoint loads into a frozen "
                         "BatchNorm backbone with the 7x7 stem: "
                         "BackboneConfig(norm='bn', stem_s2d=False)")
    return cfg


def convert_oetr_state_dict(state_dict: Mapping,
                            cfg: OETRConfig | None = None) -> dict:
    """A reference OETR ``state_dict`` -> the state_dict of the port's
    ``OETR(cfg)`` (``cfg`` with ``norm='bn'``; by default the flagship's
    widths): float32 CPU tensors, every parameter set exactly once.

    Raises MissingReferenceKey (a KeyError) on a key the map needs, KeyError
    or ValueError where the reference and ``cfg`` disagree on the layers or
    their shapes (``from_flax.checked_state``).
    """
    cfg = _bn_config(cfg)
    pairs = reference_name_map(state_dict, cfg)
    return checked_state(((port, state_dict[ref], f"reference key {ref}")
                          for port, ref in pairs),
                         build_oetr(cfg, device="meta"))


def skipped_keys(state_dict: Mapping, cfg: OETRConfig | None = None
                 ) -> list[str]:
    """The keys of ``state_dict`` that the conversion does not read."""
    used = {ref for _, ref in reference_name_map(state_dict, _bn_config(cfg))}
    return sorted(set(state_dict) - used)


def load_reference_checkpoint(path: str, cfg: OETRConfig | None = None
                              ) -> dict:
    """Read a reference checkpoint file with ``torch.load`` (tensors only,
    ``weights_only=True``; onto the CPU) and convert it: a ``"state_dict"``
    wrapper is unwrapped and DataParallel's ``module.`` prefix stripped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    return convert_oetr_state_dict(sd, cfg)


def reference_state_dict(state: Mapping, cfg: OETRConfig | None = None
                         ) -> dict:
    """The inverse of ``convert_oetr_state_dict``: the state_dict of the
    port's ``OETR(cfg)`` (``norm='bn'``) under the reference's key names,
    the same tensors (the keys the conversion reads, no aliases or unused
    keys)."""
    pairs = _name_pairs(_bn_config(cfg), lambda port, ref: port in state)
    return {ref: state[port] for port, ref in pairs}
