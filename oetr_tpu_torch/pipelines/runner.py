"""Benchmark matching runner (port of ``oetr_tpu/pipelines/runner.py``).

Runs a pipeline over an evaluation pair list in batches and writes
per-scene h5 results in the reference's layout (keypoints, matches,
optional inparams) through ``utils/h5io.py``, so the evaluation harnesses
(``evalx``) score them. Keypoints are un-warped to the original image
frame, so ``inparams`` (sx, sy, tx, ty, rx, ry: resize scale, crop origin,
crop -> canvas ratio) are written only on request, for cross-checks. The
batches go to the device of the pipeline's weights.
"""
from __future__ import annotations

import os
from collections import defaultdict

import numpy as np
import torch

from ..data.images import batch_pairs, prepare_image, read_image
from ..data.pairs import load_eval_pairs
from ..utils.h5io import pair_key, save_scene_results, stem

INPUT_KEYS = ("image0", "image1", "full_hw0", "full_hw1", "oetr_img0",
              "oetr_img1", "scales0", "scales1")


def pipeline_device(pipeline) -> torch.device:
    """The device of a pipeline's weights (its extractor's or LoFTR's)."""
    module = getattr(pipeline, "extractor", None) or pipeline.loftr
    return next(module.parameters()).device


def run_batch(pipeline, batch: dict, with_overlap: bool = True) -> dict:
    """The pipeline on a batch of ``batch_pairs`` arrays, moved to the
    pipeline's device."""
    dev = pipeline_device(pipeline)
    args = [torch.from_numpy(np.ascontiguousarray(batch[k])).to(dev)
            for k in INPUT_KEYS]
    return pipeline(*args, with_overlap=with_overlap)


def pair_result(out: dict, i: int, s0, s1):
    """Pair i of a pipeline output in the original frames: (kpts0, kpts1,
    matches [2, M], confidence [M], valid0, valid1); for the dense
    pipeline the matched points themselves, matched index to index."""
    g = lambda key: out[key][i].cpu().numpy()
    if "mkpts0" in out:
        v = g("valid")
        k0, k1 = g("mkpts0")[v] * s0, g("mkpts1")[v] * s1
        m = np.stack([np.arange(len(k0)), np.arange(len(k0))])
        return k0, k1, m, g("conf")[v], None, None
    k0, k1 = g("keypoints0") * s0, g("keypoints1") * s1
    matches0, valid0 = g("matches0"), g("valid0")
    sel = (matches0 > -1) & valid0
    idx0 = np.nonzero(sel)[0]
    conf = (g("matching_scores0")[sel]
            if out.get("matching_scores0") is not None
            else np.ones(len(idx0)))
    return (k0, k1, np.stack([idx0, matches0[sel]]), conf, valid0,
            g("valid1"))


def _scene_of(name: str) -> str:
    parts = name.split("/")
    if len(parts) > 2:
        return parts[1]          # dataset/scene/.../img (MegaDepth, IMC)
    if len(parts) == 2:
        return parts[0]          # seq/img (HPatches)
    return "."


def _native_batch(paths0, paths1, cfg, resize_max):
    """The batch through the C++ data service (threaded JPEG decode and
    resize): the arrays of the Python path."""
    from ..data.native import prepare_batch_native

    out = {}
    for side, paths in (("0", paths0), ("1", paths1)):
        b = prepare_batch_native(paths, cfg.canvas_hw, cfg.oetr_hw,
                                 resize_max)
        out["image" + side] = b["canvas"]
        out["full_hw" + side] = b["valid_hw"]
        out["oetr_img" + side] = b["oetr_image"]
        out["scales" + side] = b["oetr_scale"]
        out["scale_to_orig" + side] = b["scale_to_orig"]
    return out


def run_benchmark(pipeline, pairs_file: str, dataset_path: str,
                  results_dir: str, batch_size: int = 8,
                  with_overlap: bool = True, resize_max: int | None = 1024,
                  pairwise: bool = True, write_inparams: bool = False,
                  use_native: bool = False) -> dict:
    """Match every pair, write per-scene h5, return simple run stats.

    ``use_native=True`` reads images through the C++ data service, and
    through Python where the library cannot be built (as the JAX runner
    does; host input only).
    """
    cfg = pipeline.cfg
    pairs = load_eval_pairs(pairs_file)
    by_scene_kpts: dict[str, dict] = defaultdict(dict)
    by_scene_matches: dict[str, dict] = defaultdict(dict)
    by_scene_inparams: dict[str, dict] = defaultdict(dict)
    n_matches_total = 0

    if use_native:
        from ..data.native import native_available
        use_native = native_available()

    for start in range(0, len(pairs), batch_size):
        chunk = pairs[start:start + batch_size]
        if use_native:
            batch = _native_batch(
                [os.path.join(dataset_path, p.name0) for p in chunk],
                [os.path.join(dataset_path, p.name1) for p in chunk],
                cfg, resize_max)
        else:
            prep = lambda name: prepare_image(
                read_image(os.path.join(dataset_path, name)),
                cfg.canvas_hw, cfg.oetr_hw, resize_max)
            batch = batch_pairs([prep(p.name0) for p in chunk],
                                [prep(p.name1) for p in chunk])
        out = run_batch(pipeline, batch, with_overlap)

        for i, p in enumerate(chunk):
            scene = _scene_of(p.name0)
            s0 = batch["scale_to_orig0"][i]
            s1 = batch["scale_to_orig1"][i]
            k0, k1, m, _, _, _ = pair_result(out, i, s0, s1)
            n_matches_total += m.shape[1]
            key01 = pair_key(p.name0, p.name1)
            key10 = pair_key(p.name1, p.name0)
            if pairwise:
                by_scene_kpts[scene][key01] = k0
                by_scene_kpts[scene][key10] = k1
            else:
                by_scene_kpts[scene].setdefault(stem(p.name0), k0)
                by_scene_kpts[scene].setdefault(stem(p.name1), k1)
            by_scene_matches[scene][key01] = m
            if write_inparams:
                bbox0 = out["bbox0"][i].cpu().numpy()
                bbox1 = out["bbox1"][i].cpu().numpy()
                r0 = float(out["ratio0"][i])
                r1 = float(out["ratio1"][i])
                by_scene_inparams[scene][key01] = np.array(
                    [s0[0], s0[1], bbox0[0], bbox0[1], r0, r0], np.float64)
                by_scene_inparams[scene][key10] = np.array(
                    [s1[0], s1[1], bbox1[0], bbox1[1], r1, r1], np.float64)

    for scene in by_scene_matches:
        save_scene_results(results_dir, scene, by_scene_kpts[scene],
                           by_scene_matches[scene],
                           inparams=(by_scene_inparams[scene]
                                     if write_inparams else None))
    return {
        "num_pairs": len(pairs),
        "num_scenes": len(by_scene_matches),
        "matches_per_pair": n_matches_total / max(len(pairs), 1),
    }
