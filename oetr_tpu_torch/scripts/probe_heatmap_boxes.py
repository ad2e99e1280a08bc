"""Overlap boxes decoded from the heat map instead of the tlbr head, on a
trained state, on the port (``scripts/probe_heatmap_boxes.py``).

Loads the full train state ``{--ckpt_dir}/step_{--step}`` (JAX's orbax
layout, written by JAX's trainer or the port's: ``training/train.py``),
runs the model on the held-out pairs of ``{--data_dir}/val`` and reports
the mean IoU against the GT boxes of the tlbr head's boxes, of the boxes
from heat-map mass quantiles (``geometry.boxes.boxes_from_prob_map``) at
q in 0.02 ... 0.20, and of the full frame. With ``--full`` it then scores
the pose A/B (SIFT -> NN -> LO-RANSAC inside each mode's crops: direct,
heat-map guided at the best q, tlbr guided, GT guided), which needs cv2,
as JAX's does. Prints one JSON line, the JAX script's.

    python -m oetr_tpu_torch.scripts.probe_heatmap_boxes \
        --ckpt_dir .ckpt_ab_d192_scratch --step 4000 --data_dir DIR [--full]

The model is the script's OETR (``--depth``, ``--d_model``, ``--layers``,
2 decoder layers) with the fused stem and the fused encoder sublayer
switched on: K3 and K2 on the card, their plain versions on the CPU.
``box_rows`` (the box half) takes the forward's outputs and needs no cv2.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..config import TrainConfig
from ..geometry.boxes import bbox_overlaps_aligned, boxes_from_prob_map
from ..training.train import create_train_state, load_checkpoint
from .common import log, require_cv2
from .overlap_ab_demo import crops_for, model_config, run_mode

QS = (0.02, 0.05, 0.10, 0.15, 0.20)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt_dir", default=".ckpt_ab_d192_scratch")
    ap.add_argument("--step", type=int, default=4000)
    ap.add_argument("--data_dir", required=True,
                    help="the A/B run's scene directory (its val/ pairs)")
    ap.add_argument("--hw", type=int, default=256)
    ap.add_argument("--d_model", type=int, default=192)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--depth", type=int, default=18)
    ap.add_argument("--full", action="store_true",
                    help="also run the SIFT pose A/B on the best variant")
    ap.add_argument("--topk", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.dec_layers = 2
    return args


def load_model(args, device):
    """The script's OETR with the state ``step_{--step}`` loaded, in eval
    mode."""
    model, state = create_train_state(
        model_config(args, fused_stem=True, attention="linear:cuda"),
        TrainConfig(), device=device)
    load_checkpoint(os.path.abspath(args.ckpt_dir), args.step, state)
    return model.eval()


@torch.no_grad()
def forward(model, img1: np.ndarray, img2: np.ndarray, chunk: int = 8):
    """The model's outputs on every pair, in chunks of 8 (numpy)."""
    device = next(model.parameters()).device
    outs = []
    for s in range(0, len(img1), chunk):
        out = model(torch.as_tensor(img1[s:s + chunk]).to(device),
                    torch.as_tensor(img2[s:s + chunk]).to(device))
        outs.append({k: v.float().cpu().numpy() for k, v in out.items()
                     if k in ("pred_bbox1", "pred_bbox2", "prob_map1",
                              "prob_map2")})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def miou(a, b) -> float:
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)
    return float(bbox_overlaps_aligned(f32(a), f32(b)).mean())


def heatmap_boxes(out: dict, hw: int, q: float):
    """(boxes1, boxes2) from the heat maps' mass quantiles at ``q``."""
    tokens = hw // 32
    return tuple(boxes_from_prob_map(torch.as_tensor(out[k]), tokens, tokens,
                                     (hw, hw), q).numpy()
                 for k in ("prob_map1", "prob_map2"))


def box_rows(out: dict, gt1: np.ndarray, gt2: np.ndarray, hw: int):
    """(rows, best q, best mean IoU): the tlbr head's, each q's and the
    full frame's mean IoU against the GT boxes."""
    rows = {"tlbr_head": {"miou1": round(miou(out["pred_bbox1"], gt1), 4),
                          "miou2": round(miou(out["pred_bbox2"], gt2), 4)}}
    best_q, best = None, -1.0
    for q in QS:
        b1, b2 = heatmap_boxes(out, hw, q)
        m1, m2 = miou(b1, gt1), miou(b2, gt2)
        rows[f"heatmap_q{q}"] = {"miou1": round(m1, 4),
                                 "miou2": round(m2, 4)}
        if (m1 + m2) / 2 > best:
            best, best_q = (m1 + m2) / 2, q
    full = np.tile([0, 0, hw, hw], (len(gt1), 1)).astype(np.float64)
    rows["full_frame"] = {"miou1": round(miou(full, gt1), 4),
                          "miou2": round(miou(full, gt2), 4)}
    return rows, best_q, best


def pose_ab(items, img1, img2, out, gt1, gt2, best_q, args, device) -> dict:
    """The pose A/B: each mode's crops, SIFT + NN, pose AUC (cv2)."""
    hw = args.hw
    full = np.tile([0, 0, hw, hw], (len(items), 1)).astype(np.float64)
    modes = {"direct": (full, full),
             "heatmap_guided": heatmap_boxes(out, hw, best_q),
             "tlbr_guided": (out["pred_bbox1"], out["pred_bbox2"]),
             "gt_guided": (gt1, gt2)}
    rows = {}
    for name, (b1, b2) in modes.items():
        row = run_mode(items, crops_for(img1, img2, b1, b2, hw, device),
                       args, device)
        rows[name] = {k: v for k, v in row.items() if k != "auc@5_sigma"}
    return rows


def val_items(args) -> list:
    from ..data.megadepth import MegaDepthPairsDataset

    val = os.path.join(args.data_dir, "val")
    ds = MegaDepthPairsDataset(val, os.path.join(val, "pairs.txt"),
                               image_size=(args.hw, args.hw), train=False)
    return [ds[i] for i in range(len(ds))]


def run(args) -> dict:
    t0 = time.time()
    device = torch.device(args.device)
    model = load_model(args, device)
    log(f"loaded {args.ckpt_dir}/step_{args.step} ({time.time() - t0:.0f}s)")
    items = val_items(args)
    img1 = np.stack([it["image1"] for it in items])
    img2 = np.stack([it["image2"] for it in items])
    gt1 = np.stack([it["overlap_box1"] for it in items]).astype(np.float64)
    gt2 = np.stack([it["overlap_box2"] for it in items]).astype(np.float64)
    out = forward(model, img1, img2)
    log(f"forward done ({time.time() - t0:.0f}s)")
    rows, best_q, best = box_rows(out, gt1, gt2, args.hw)
    result = {"metric": "heatmap_box_probe", "ckpt": args.ckpt_dir,
              "step": args.step, "best_q": best_q,
              "best_miou": round(best, 4), **rows}
    if args.full:
        result["pose_ab"] = pose_ab(items, img1, img2, out, gt1, gt2, best_q,
                                    args, device)
    result["wall_s"] = round(time.time() - t0, 1)
    return result


def main(argv=None):
    args = parse_args(argv)
    require_cv2("probe_heatmap_boxes (the dataset reads and the SIFT rows)")
    print(json.dumps(run(args)))


if __name__ == "__main__":
    main()
