"""Public matching API (port of ``oetr_tpu/pipelines/api.py``).

``build_model(extractor, matcher, overlaper=...)`` assembles a pipeline
from registry names, ``get_matches(model, path0, path1)`` matches one
image pair by path (numpy out, in original pixels) and ``get_pose``
fits a homography or a similarity to the matches. The batched pipelines
(``pipelines/matching.py``) do the work; this is the single-pair layer.
The networks run on ``device`` ("cuda" unless the caller asks for the
CPU); reading images needs cv2 (``data/images.py::read_image``).

``build_model`` assembles what JAX's assembles: a learned extractor with
SuperGlue, ``NN`` or ``disk``, and ``loftr`` (dense). JAX's cannot run the
host SIFT extractors (``landmark``, ``contextdesc``: functions of a uint8
image, not modules of the data dict), ``icp`` (a function of two images)
or ``cotr`` (a module of a composite and queries) in a pipeline; the port
refuses them with a ValueError that names the function to call instead.
``build_shipped_model`` assembles the pipelines of the repo's committed
trained checkpoints, read without orbax (``interop/orbax_read.py``).
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from ..config import oetr_r50_kernels_config
from ..data.images import batch_pairs, prepare_image, read_image
from ..geometry.homography import ransac_homography
from ..interop.from_flax import (convert_flax_params, convert_loftr_params,
                                 convert_superglue_params,
                                 convert_superpoint_params)
from ..interop.orbax_read import read_checkpoint
from ..models import registry
from ..models.loftr import build_loftr
from ..models.oetr import build_oetr
from ..models.superglue import build_superglue
from ..models.superpoint import build_superpoint
from .matching import DensePipeline, PipelineConfig, SparsePipeline
from .runner import pair_result, run_batch

NOT_A_PIPELINE = {
    "landmark": "landmark_extract (host SIFT keypoints of a uint8 image)",
    "contextdesc": "contextdesc_extract (host SIFT and a ContextDesc)",
    "icp": "icp_match (contour ICP of two uint8 images)",
    "cotr": "cotr_match (COTR on a composite and query points)",
}


def _component(name: str, device, seed: int, state: dict | None, **kw):
    """Registry module ``name`` with seeded weights, or ``state`` loaded."""
    module = registry.build(name, device=device,
                            generator=torch.Generator().manual_seed(seed),
                            **kw)
    if state:
        module.load_state_dict(state)
    return module


def build_model(extractor: str = "superpoint_aachen",
                matcher: str = "superglue_outdoor",
                overlaper: str | None = None, rng_seed: int = 0,
                cfg: PipelineConfig | None = None,
                params: dict | None = None, device="cuda"):
    """Assemble a pipeline from registry names: (pipeline, conf dict).

    ``params`` may carry state dicts per component ({'extractor': ...,
    'matcher': ..., 'oetr': ...}); without them the weights are drawn
    from a generator seeded ``rng_seed``. Raises RuntimeError for a CUDA
    device where there is no card, ValueError for a name that is not a
    pipeline component.
    """
    cfg = cfg or PipelineConfig()
    params = params or {}
    registry.check_device(device)
    for name in (extractor, matcher):
        if name in NOT_A_PIPELINE and not (name == extractor
                                           and matcher == "loftr"):
            raise ValueError(f"{name!r} is not a pipeline component: call "
                             f"{NOT_A_PIPELINE[name]}")
    conf = {"matcher": matcher, "extractor": extractor,
            "overlaper": overlaper, "config": cfg, "device": device}

    oetr = None
    if overlaper is not None:
        oetr = _component(overlaper, device, rng_seed, params.get("oetr"))

    if matcher == "loftr":
        loftr = _component("loftr", device, rng_seed, params.get("matcher"))
        return DensePipeline(loftr, oetr, cfg), dict(conf, extractor=None)

    ex = _component(extractor, device, rng_seed, params.get("extractor"))
    if matcher.startswith("superglue"):
        match_fn = _component(matcher, device, rng_seed,
                              params.get("matcher"))
    else:                                    # 'NN', 'disk': functions
        match_fn = registry.build(matcher, device=device)
    return SparsePipeline(ex, match_fn, oetr, cfg), conf


SHIPPED_CKPTS = {"oetr": ".ckpt_oetr_r5/params",
                 "superpoint": ".ckpt_matching_r5/superpoint",
                 "superglue": ".ckpt_matching_r5/superglue",
                 "loftr": ".ckpt_loftr_r5/loftr"}
# The shipped training configs (JAX's build_shipped_model pins them).
SHIPPED_SP = dict(max_keypoints=2048, keypoint_threshold=0.0,
                  descriptor_dim=128)
SHIPPED_SG = dict(descriptor_dim=128)
SHIPPED_LOFTR = dict(d_coarse=192, d_fine=96, coarse_layers=4,
                     max_matches=1024)


def shipped_tree(name: str, ckpt_root=None) -> dict:
    """The flax tree of shipped checkpoint ``name`` (a key of
    ``SHIPPED_CKPTS``) under ``ckpt_root`` (default: the repo root this
    package sits in), read by ``interop.orbax_read.read_checkpoint``.
    Raises FileNotFoundError where the directory is absent."""
    root = Path(ckpt_root) if ckpt_root else Path(__file__).resolve(
    ).parents[2]
    path = os.path.abspath(root / SHIPPED_CKPTS[name])
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"shipped checkpoint missing: {path} (train it via the "
            "scripts/ demos or pass explicit params to build_model)")
    return read_checkpoint(path)


def build_shipped_model(matcher: str = "superglue",
                        with_overlap: bool = False, ckpt_root=None,
                        cfg: PipelineConfig | None = None, device="cuda"):
    """A pipeline of the repo's committed trained checkpoints: (pipeline,
    conf dict), as ``build_model`` returns.

    ``"superglue"``: SuperPoint (descriptor 128, 2048 keypoints, threshold
    0) from ``.ckpt_matching_r5/superpoint`` and SuperGlue (descriptor 128,
    K4 on) from ``.ckpt_matching_r5/superglue``; ``"loftr"``: LoFTR (d 192
    coarse, 96 fine, 4 coarse layers, 1024 matches) from
    ``.ckpt_loftr_r5/loftr``; ``with_overlap`` adds the flagship OETR from
    ``.ckpt_oetr_r5/params`` with K2 and K3 on, in float32. The stores are
    read with the port's own OCDBT, zarr and zstd code. Raises
    FileNotFoundError where a store is absent, ValueError for another
    matcher, RuntimeError for a CUDA device where there is no card.
    """
    if matcher not in ("superglue", "loftr"):
        raise ValueError(f"no shipped weights for matcher {matcher!r}")
    cfg = cfg or PipelineConfig(box_source="heatmap")
    registry.check_device(device)
    overlaper = "oetr" if with_overlap else None
    conf = {"matcher": matcher, "extractor": None, "overlaper": overlaper,
            "config": cfg, "device": device}

    def load(module, state):
        module.load_state_dict(state)
        return module

    oetr = None
    if with_overlap:
        ocfg = oetr_r50_kernels_config(dtype="float32")
        oetr = load(build_oetr(ocfg, device=device),
                    convert_flax_params(shipped_tree("oetr", ckpt_root),
                                        ocfg))
    if matcher == "loftr":
        loftr = load(build_loftr(device=device, **SHIPPED_LOFTR),
                     convert_loftr_params(shipped_tree("loftr", ckpt_root),
                                          **SHIPPED_LOFTR))
        return DensePipeline(loftr, oetr, cfg), conf

    sp = load(build_superpoint(device=device, **SHIPPED_SP),
              convert_superpoint_params(
                  shipped_tree("superpoint", ckpt_root), **SHIPPED_SP))
    sg = load(build_superglue(device=device, cuda_sinkhorn=True,
                              **SHIPPED_SG),
              convert_superglue_params(shipped_tree("superglue", ckpt_root),
                                       **SHIPPED_SG))
    return SparsePipeline(sp, sg, oetr, cfg), dict(conf,
                                                   extractor="superpoint")


def get_matches(model, name0: str, name1: str, with_overlap: bool = True,
                resize_max: int | None = 1024) -> dict:
    """Match one image pair by path. Returns kpts0, kpts1, matches [2, M]
    and confidence (numpy, original image pixels); the sparse pipeline adds
    all_valid0 and all_valid1."""
    return _match_images(model, read_image(name0), read_image(name1),
                         with_overlap, resize_max)


def _match_images(model, image0: np.ndarray, image1: np.ndarray,
                  with_overlap: bool = True,
                  resize_max: int | None = 1024) -> dict:
    """``get_matches`` after the decode: RGB float32 [H, W, 3] images in
    [0, 1] -> prepare -> batch -> pipeline -> original frames."""
    pipeline, conf = model
    cfg = conf["config"]
    p0 = prepare_image(image0, cfg.canvas_hw, cfg.oetr_hw, resize_max)
    p1 = prepare_image(image1, cfg.canvas_hw, cfg.oetr_hw, resize_max)
    batch = batch_pairs([p0], [p1])
    out = run_batch(pipeline, batch, with_overlap)
    k0, k1, m, conf_v, valid0, valid1 = pair_result(
        out, 0, batch["scale_to_orig0"][0], batch["scale_to_orig1"][0])
    res = {"kpts0": k0, "kpts1": k1, "matches": m, "confidence": conf_v}
    if valid0 is not None:
        res.update(all_valid0=valid0, all_valid1=valid1)
    return res


def get_pose(matches_dict: dict, model: str = "homography",
             threshold_px: float = 3.0, rng_seed: int = 0,
             device="cuda") -> dict:
    """A planar model of the matches: ``ransac_homography`` ('homography'
    or 'similarity') on the matched points, padded to a power of two
    (>= 8), on ``device`` with its draws from a generator seeded
    ``rng_seed`` (through ``geometry/draws.py``). Returns H [3, 3],
    inliers [M] and ok."""
    dev = registry.check_device(device)
    k0, k1, m = (matches_dict[k] for k in ("kpts0", "kpts1", "matches"))
    p0, p1 = k0[m[0]], k1[m[1]]
    n = len(p0)
    pad = max(8, int(2 ** np.ceil(np.log2(max(n, 8)))))
    p0p = np.zeros((pad, 2), np.float32)
    p1p = np.zeros((pad, 2), np.float32)
    p0p[:n], p1p[:n] = p0, p1
    valid = np.arange(pad) < n
    t = lambda a: torch.from_numpy(a).to(dev)
    res = ransac_homography(t(p0p), t(p1p), t(valid), threshold_px,
                            torch.Generator(device=dev).manual_seed(rng_seed),
                            model=model)
    return {"H": res["H"].cpu().numpy(),
            "inliers": res["inliers"].cpu().numpy()[:n],
            "ok": bool(res["ok"])}
