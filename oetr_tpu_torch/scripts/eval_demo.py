"""End-to-end harness proof on the port (``scripts/eval_demo.py``): SIFT ->
NN -> RANSAC -> pose AUC.

Runs the evaluation chain on synthetic scenes with known geometry: cv2's
SIFT keypoints (host), the mutual NN matcher with the ratio test and the
LO-RANSAC pose estimator (on ``--device``), scored by ``validation_error``
and ``pose_auc`` @5/10/20. Prints one JSON line, the JAX script's.

    python -m oetr_tpu_torch.scripts.eval_demo [--scene3d] [--device cpu]

Every step before the matcher needs cv2 (the scene writer, the dataset
reads, SIFT), so the program runs where cv2 is.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np

from ..evalx.metrics import pose_auc
from .common import pose_errors, require_cv2, sift_nn


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=40)
    ap.add_argument("--hw", type=int, default=240)
    ap.add_argument("--topk", type=int, default=1024)
    ap.add_argument("--scene3d", action="store_true",
                    help="use generate_scene_3d (multi-plane depth, "
                         "rotation, perspective tilt, illumination): the "
                         "non-planar regime where the E path, not the "
                         "planar-homography fallback, is the right model")
    ap.add_argument("--rot", type=float, default=12.0)
    ap.add_argument("--tilt", type=float, default=8.0)
    ap.add_argument("--scale_max", type=float, default=1.8)
    ap.add_argument("--illum", type=float, default=0.3,
                    help="illumination gain spread: gains in [1-x, 1+x]")
    ap.add_argument("--ratio", type=float, default=0.9,
                    help="NN mutual ratio-test threshold")
    ap.add_argument("--device", default="cuda",
                    help="where the matcher and the pose estimator run")
    return ap.parse_args(argv)


def make_dataset(base: str, args):
    """The scenes under ``base`` (seed 11), as JAX's script writes them."""
    from ..data.megadepth import MegaDepthPairsDataset
    from ..data.synthetic import generate_scene, generate_scene_3d

    if args.scene3d:
        txt = generate_scene_3d(
            base, n_pairs=args.pairs, image_hw=args.hw, seed=11,
            rot_deg=args.rot, tilt_deg=args.tilt,
            scale_range=(1.0, args.scale_max),
            illum_range=(1.0 - args.illum, 1.0 + args.illum))
    else:
        txt = generate_scene(base, n_pairs=args.pairs, image_hw=args.hw,
                             max_shift_px=60, seed=11)
    return MegaDepthPairsDataset(base, txt, image_size=(args.hw, args.hw),
                                 train=False)


def evaluate(args, items: list, t0: float) -> dict:
    """SIFT + NN + pose on every item: the JAX script's JSON line."""
    scored = pose_errors(
        items, lambda i, it: sift_nn(it["image1"], it["image2"], args.topk,
                                     args.ratio, args.device), args.device)
    errors = scored["errors"]
    aucs = pose_auc(errors, [5, 10, 20])
    return {
        "metric": ("synthetic3d_sift_nn_pose_auc" if args.scene3d
                   else "synthetic_sift_nn_pose_auc"),
        "pairs": args.pairs, "hw": args.hw,
        "auc@5": round(float(aucs[0]), 4),
        "auc@10": round(float(aucs[1]), 4),
        "auc@20": round(float(aucs[2]), 4),
        "precision": round(float(np.mean(scored["precision"])), 4),
        "matching_score": round(float(np.mean(scored["matching_score"])), 4),
        "matches_per_pair": round(float(np.mean(scored["n"])), 1),
        "failed_pairs": int(np.sum(~np.isfinite(errors))),
        "wall_s": round(time.time() - t0, 1),
    }


def main(argv=None):
    args = parse_args(argv)
    require_cv2("eval_demo (the scene writer, the dataset reads and SIFT)")
    t0 = time.time()
    ds = make_dataset(tempfile.mkdtemp(prefix="oetr_evaldemo_"), args)
    print(json.dumps(evaluate(args, [ds[i] for i in range(len(ds))], t0)))


if __name__ == "__main__":
    main()
