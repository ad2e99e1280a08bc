"""Configuration dataclasses of the port.

Own copies of the fields of ``oetr_tpu/config.py`` that the ported OETR
forward and trainer read: the port imports nothing of the JAX package. The
fields carry the JAX names and defaults. The attention kinds differ in
their kernel suffixes (see ``NeckConfig``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class BackboneConfig:
    depth: int = 50                 # resnet 18/34/50/101/152
    stop_layer: str = "layer3"      # 'layer3' (stride 16) | 'layer4' (stride 32)
    last_layer: int = 1024          # channels at stop_layer
    norm: str = "gn"                # 'gn' | 'ln' | 'bn' (frozen statistics:
                                    # the reference's torchvision checkpoints)
    stem_s2d: bool = False          # space-to-depth stem: 2x2 pixel blocks
                                    # folded into channels, the 7x7/s2 conv as
                                    # the equivalent 4x4/s1 (resnet.py)
    fused_stem: bool = False        # GN+ReLU+max-pool stem as one CUDA kernel
                                    # (taken with norm 'gn' only, as in JAX)
    norm_input: bool = True         # (x - 0.45) / 0.225


@dataclass(frozen=True)
class NeckConfig:
    d_model: int = 256
    attention: str = "linear"
    # 'linear' | 'full': plain torch ops.
    # 'linear:cuda' (JAX 'linear:pallas'): the encoder sublayer runs as one
    #   CUDA kernel (K2), and other linear attention of 8 or more tokens as
    #   the bare kernel (K1).
    # 'full:cuda' (JAX 'full:pallas'): whole-row softmax kernel (K5).
    # 'full:flash' (the same in JAX): streaming softmax kernel (K6).
    # 'full:ring' (the same in JAX): ring attention over the group of
    #   parallel.ring_context (sequence parallelism).
    max_shape: tuple[int, int] = (100, 100)  # positional-encoding grid cap
    patch_sizes: tuple[int, ...] = (4, 8, 16)
    nhead: int = 8
    num_layers: int = 4             # encoder (self + cross) pairs
    num_decoder_layers: int = 2
    legacy_pos_enc: bool = True     # keep the reference's div_term quirk


@dataclass(frozen=True)
class LossConfig:
    oiou: bool = False
    cycle_overlap: bool = False
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0


@dataclass(frozen=True)
class OETRConfig:
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    neck: NeckConfig = field(default_factory=NeckConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    dtype: str = "float32"          # compute dtype: 'float32' | 'bfloat16'

    @property
    def d_model(self) -> int:
        return self.neck.d_model


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8             # pairs a step
    image_size: tuple[int, int] = (640, 640)
    epochs: int = 35
    lr: float = 1e-4
    weight_decay: float = 1e-2
    lr_milestones: tuple[int, ...] = (15, 30)   # epochs (MultiStepLR)
    lr_gamma: float = 0.1
    pairs_per_epoch: int = 128_000
    seed: int = 42
    checkpoint_dir: str = "checkpoints"
    data_axis: str = "data"         # the mesh axis the batch is split over


def replace(cfg, **kwargs):
    """Functional config update: ``replace(cfg, dtype='bfloat16')``."""
    return dataclasses.replace(cfg, **kwargs)


def oetr_r50_config() -> OETRConfig:
    """ResNet50 cut at layer3, 1024 channels, d_model 256 (the flagship)."""
    return OETRConfig()


def oetr_fc_r50_config() -> OETRConfig:
    """ResNet50 cut at layer4, 2048 channels, d_model 512 (8 heads of 64)."""
    return OETRConfig(
        backbone=BackboneConfig(stop_layer="layer4", last_layer=2048),
        neck=NeckConfig(d_model=512),
    )


def oetr_r50_kernels_config(dtype: str = "bfloat16",
                            attention: str = "linear:cuda") -> OETRConfig:
    """The flagship with its CUDA kernels switched on: the fused stem and
    the encoder's attention kernels, ``attention`` = 'linear:cuda' (K2),
    'full:cuda' (K5) or 'full:flash' (K6)."""
    base = oetr_r50_config()
    return OETRConfig(
        backbone=replace(base.backbone, fused_stem=True),
        neck=replace(base.neck, attention=attention), dtype=dtype)
