"""Offline MegaDepth pair-list generation on the host (port of
``oetr_tpu/data/preprocess.py``, on the port's ``data/gt.py``).

Parity with the reference's src/utils/megadepth_preprocess.py:60-270:
walk scene_info npz files (overlap matrix, scale-ratio matrix, paths,
intrinsics, poses), filter pairs by overlap in [0.1, 0.7] and scale
ratio, compute full-image co-visible boxes via the depth warp, keep
pairs whose box scale difference exceeds a threshold, and emit the
10-field training pairs txt (``data/pairs.py`` format). Parallelised with
a process pool like the reference's Pool(6). The depth maps are h5
files, read with the port's own HDF5 subset (``utils/hdf5.py``).
"""
from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from ..utils import hdf5
from .gt import overlap_bbox_np


def scale_diff(bbox0, bbox1) -> float:
    """Max width/height ratio between covisible boxes
    (ref: megadepth_preprocess.py:70-92)."""
    w_diff = max((bbox0[2] - bbox0[0]) / max(bbox1[2] - bbox1[0], 1e-9),
                 (bbox1[2] - bbox1[0]) / max(bbox0[2] - bbox0[0], 1e-9))
    h_diff = max((bbox0[3] - bbox0[1]) / max(bbox1[3] - bbox1[1], 1e-9),
                 (bbox1[3] - bbox1[1]) / max(bbox0[3] - bbox0[1], 1e-9))
    return float(max(w_diff, h_diff))


def _fmt(a) -> str:
    return ",".join(str(float(x)) for x in np.asarray(a).reshape(-1))


def pair_line(image0, depth0, K0, pose0, bbox0, image1, depth1, K1, pose1,
              bbox1) -> str:
    """One 10-field training-pairs line (megadepth_pairs.py:71-97 format)."""
    return " ".join([image0, depth0, _fmt(K0), _fmt(pose0), _fmt(bbox0),
                     image1, depth1, _fmt(K1), _fmt(pose1), _fmt(bbox1)])


def process_scene(scene: str, datasets: str, pairs_per_scene: int = 3000,
                  min_overlap_ratio: float = 0.1,
                  max_overlap_ratio: float = 0.7,
                  max_scale_ratio: float = 100.0,
                  min_box_scale_diff: float = 2.0,
                  seed: int | None = None) -> str:
    """Generate pair lines for one scene (ref: process_scene,
    megadepth_preprocess.py:112-224)."""
    out_lines = []
    scene_info_path = os.path.join(datasets, "scene_info", f"{scene}.0.npz")
    if not os.path.exists(scene_info_path):
        return ""
    info = np.load(scene_info_path, allow_pickle=True)
    overlap = info["overlap_matrix"]
    scale_ratio = info["scale_ratio_matrix"]
    valid = ((overlap >= min_overlap_ratio)
             & (overlap <= max_overlap_ratio)
             & (scale_ratio <= max_scale_ratio))
    image_paths = info["image_paths"]
    depth_paths = info["depth_paths"]
    intrinsics = info["intrinsics"]
    poses = info["poses"]

    pairs = np.vstack(np.where(valid))
    ids = np.arange(pairs.shape[1])
    rng = np.random.default_rng(seed)
    rng.shuffle(ids)

    n_kept = 0
    seen: set[str] = set()
    for pair_idx in ids:
        if n_kept >= pairs_per_scene:
            break
        i0 = int(pairs[0, pair_idx])
        i1 = int(pairs[1, pair_idx])
        key = f"{image_paths[i0]}-{image_paths[i1]}"
        rkey = f"{image_paths[i1]}-{image_paths[i0]}"
        if key in seen or rkey in seen:
            continue
        seen.add(key)
        with hdf5.File(os.path.join(datasets, depth_paths[i0]), "r") as f:
            depth0 = np.array(f["/depth"])
        with hdf5.File(os.path.join(datasets, depth_paths[i1]), "r") as f:
            depth1 = np.array(f["/depth"])
        zeros = np.zeros(2)
        ones = np.ones(2)
        bbox0, _, bbox1, _, ok = overlap_bbox_np(
            intrinsics[i0], depth0, poses[i0], zeros, ones,
            intrinsics[i1], depth1, poses[i1], zeros, ones)
        if not ok:
            continue
        if (bbox0[2] - bbox0[0] < 1 or bbox0[3] - bbox0[1] < 1
                or bbox1[2] - bbox1[0] < 1 or bbox1[3] - bbox1[1] < 1):
            continue
        # Keep only significant-scale-difference pairs (the reference's
        # "scale_diff > 2" filter, :199-220).
        if scale_diff(bbox0, bbox1) <= min_box_scale_diff:
            continue
        out_lines.append(pair_line(
            image_paths[i0], depth_paths[i0], intrinsics[i0], poses[i0],
            bbox0, image_paths[i1], depth_paths[i1], intrinsics[i1],
            poses[i1], bbox1))
        n_kept += 1
    return "\n".join(out_lines) + ("\n" if out_lines else "")


def generate_pairs(scenes: list[str], datasets: str, output_path: str,
                   workers: int = 6, **kwargs) -> int:
    """Multi-process scene sweep (ref: Pool(6), :263-269), in spawned
    workers (a forked copy of a process with torch's threads is unsafe).

    Returns total pair count written.
    """
    total = 0
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool, \
            open(output_path, "a+") as out:
        for chunk in pool.map(
                _process_scene_star,
                [(s, datasets, kwargs) for s in scenes]):
            if chunk:
                out.write(chunk)
                total += chunk.count("\n")
    return total


def _process_scene_star(args):
    scene, datasets, kwargs = args
    return process_scene(scene, datasets, **kwargs)
