"""Model registry: named extractor, matcher and overlap configurations
(port of ``oetr_tpu/models/registry.py``), with the same names, kinds,
defaults and notes.

``build(name, device="cuda", generator=None, **overrides)`` returns the
module on ``device`` with weights drawn from ``generator`` (a CPU
generator; seed 0 when None), as the port's ``build_*`` functions do, or
for a functional entry (``NN``, ``disk``, ``icp``, ``landmark``,
``contextdesc``) the function with its defaults bound. Overrides reach the
module's constructor: ``build("oetr", cfg=oetr_r50_kernels_config())``
gives the flagship with K2 and K3 on, and ``build("superglue_outdoor",
cuda_sinkhorn=True)`` SuperGlue with K4.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch


@dataclass(frozen=True)
class ModelEntry:
    kind: str                      # 'extractor' | 'matcher' | 'overlap'
    factory: Callable[..., Any]    # factory(device, generator, **kwargs)
    defaults: dict = field(default_factory=dict)
    note: str = ""


_REGISTRY: dict[str, ModelEntry] = {}


def register(name: str, entry: ModelEntry) -> None:
    if name in _REGISTRY:
        raise ValueError(f"duplicate registry entry {name!r}")
    _REGISTRY[name] = entry


def get(name: str) -> ModelEntry:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model conf {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def check_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device where no card is
    available raises (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA card available "
                           "(pass device='cpu' to run on the CPU)")
    return dev


def build(name: str, device="cuda", generator: torch.Generator | None = None,
          **overrides):
    """The module (or function) of a named conf, its defaults updated by
    ``overrides``."""
    e = get(name)
    check_device(device)
    kwargs = dict(e.defaults)
    kwargs.update(overrides)
    return e.factory(device, generator, **kwargs)


def names(kind: str | None = None) -> list[str]:
    return sorted(n for n, e in _REGISTRY.items()
                  if kind is None or e.kind == kind)


def _function(fn):
    """A factory of a functional entry: ``fn`` with the conf's keyword
    arguments bound (it runs where its inputs lie)."""
    return lambda device, generator, **kw: (lambda *a: fn(*a, **kw))


def _populate() -> None:
    from .aslfeat import build_aslfeat
    from .cotr import build_cotr
    from .d2net import build_d2net
    from .disk import build_disk
    from .icp import icp_match
    from .loftr import build_loftr
    from .matchers import disk_brute_match, nearest_neighbor_match
    from .oetr import build_oetr
    from .r2d2 import build_r2d2
    from .sift_based import contextdesc_extract, landmark_extract
    from .superglue import build_superglue
    from .superpoint import build_superpoint

    def module(builder):
        return lambda device, generator, **kw: builder(
            device=device, generator=generator, **kw)

    # Extractors.
    register("superpoint_aachen", ModelEntry(
        "extractor", module(build_superpoint),
        dict(nms_radius=3, max_keypoints=2048, keypoint_threshold=0.005),
        "feats-superpoint-n2048-r1024"))
    register("superpoint_inloc", ModelEntry(
        "extractor", module(build_superpoint),
        dict(nms_radius=4, max_keypoints=4096),
        "feats-superpoint-n4096-r1600"))
    register("d2net-ss", ModelEntry(
        "extractor", module(build_d2net), dict(max_keypoints=2048),
        "feats-d2net-ss"))
    register("r2d2-desc", ModelEntry(
        "extractor", module(build_r2d2),
        dict(reliability_thr=0.7, repeatability_thr=0.7, max_keypoints=5000),
        "feats-r2d2-desc"))
    register("disk-desc", ModelEntry(
        "extractor", module(build_disk), dict(max_keypoints=2048),
        "feats-disk-desc"))
    register("aslfeat-desc", ModelEntry(
        "extractor", module(build_aslfeat), dict(max_keypoints=2048),
        "feats-aslfeat-desc"))
    # Host-side SIFT-family extractors: functions of a uint8 image.
    register("landmark", ModelEntry(
        "extractor", _function(landmark_extract), dict(topk=2048),
        "feats-landmark-sift"))
    register("contextdesc", ModelEntry(
        "extractor", _function(contextdesc_extract), dict(topk=2048),
        "feats-contextdesc"))

    # Matchers.
    register("superglue_outdoor", ModelEntry(
        "matcher", module(build_superglue),
        dict(sinkhorn_iterations=30, match_threshold=0.2),
        "matches-superglue-outdoor"))
    register("superglue_indoor", ModelEntry(
        "matcher", module(build_superglue),
        dict(sinkhorn_iterations=20),
        "matches-superglue-indoor"))
    register("superglue_disk", ModelEntry(
        "matcher", module(build_superglue),
        dict(descriptor_dim=128, keypoint_encoder_layers=(32, 64, 128),
             sinkhorn_iterations=30, match_threshold=0.2),
        "matches-superglue-disk"))
    register("loftr", ModelEntry(
        "matcher", module(build_loftr), {}, "matches-loftr"))
    # 'NN' and 'disk' are functions of the matcher's data dict.
    register("NN", ModelEntry(
        "matcher", lambda device, generator, **kw: (
            lambda data: nearest_neighbor_match(
                data["descriptors0"], data["descriptors1"],
                data.get("valid0"), data.get("valid1"), **kw)),
        dict(distance_threshold=0.7, do_mutual_check=True),
        "matches-NN-mutual-dist.7"))
    register("cotr", ModelEntry(
        "matcher", module(build_cotr), {}, "matches-cotr"))
    register("disk", ModelEntry(
        "matcher", lambda device, generator, **kw: (
            lambda data: disk_brute_match(
                data["descriptors0"], data["descriptors1"],
                data.get("valid0"), data.get("valid1"), **kw)),
        dict(rt=0.1), "matches-disk-brute-force"))
    # Contour ICP: a function of two uint8 images (host).
    register("icp", ModelEntry(
        "matcher", _function(icp_match), {}, "matches-icp"))

    # Overlap estimators.
    register("oetr", ModelEntry(
        "overlap", module(build_oetr), {}, "overlap-oetr"))


_populate()
