"""The heat-map decode's (q, pad) selection for a trained OETR, on the port
(``scripts/sweep_decode.py``).

Sweeps the decode grid on a selection set of held-out scale-difference
pairs (``--val_seed`` 1234 by default, never a reported set); rerun with
``--qs`` and ``--pads`` pinned to the winner on the reporting set. Per
mode: decode the boxes (``models.oetr.decode_boxes(source="heatmap", q,
pad)``, the pipelines' decode), crop and equalise (``ops/warp``), SIFT ->
NN -> LO-RANSAC, pose AUC with a bootstrap spread. The parameters are a
params-only store (the committed ``.ckpt_oetr_r5/params`` by default),
read by ``interop.read_checkpoint``; the model runs with the fused stem
and the fused encoder sublayer switched on (K3 and K2 on the card, their
plain versions on the CPU). The SIFT half needs cv2, as JAX's does, so
the program runs where cv2 is. Prints one JSON line, the JAX script's,
with direct and GT rows and one row per (q, pad).

    python -m oetr_tpu_torch.scripts.sweep_decode [--ckpt DIR] \
        [--qs 0.05,0.1,0.15] [--pads 0.1,0.15,0.2,0.25] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..interop.from_flax import convert_flax_params
from ..interop.orbax_read import read_checkpoint
from ..models.oetr import build_oetr, decode_boxes
from .common import log, require_cv2
from .overlap_ab_demo import clamp_boxes, crops_for, model_config, run_mode
from .probe_heatmap_boxes import forward, miou


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=".ckpt_oetr_r5/params")
    ap.add_argument("--val_seed", type=int, default=1234)
    ap.add_argument("--val_pairs", type=int, default=100)
    ap.add_argument("--hw", type=int, default=256)
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--d_model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--topk", type=int, default=1024)
    ap.add_argument("--qs", default="0.05,0.1,0.15")
    ap.add_argument("--pads", default="0.1,0.15,0.2,0.25")
    ap.add_argument("--data_dir", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.dec_layers = 2
    return args


def load_model(args, device):
    """The script's OETR with the store ``--ckpt``'s parameters, in eval
    mode."""
    cfg = model_config(args, fused_stem=True, attention="linear:cuda")
    model = build_oetr(cfg, device=device)
    model.load_state_dict(convert_flax_params(
        read_checkpoint(os.path.abspath(args.ckpt)), cfg))
    return model.eval()


def val_items(args) -> list:
    """The selection set: ``--data_dir``'s val pairs, generated there (or
    in a temporary directory) where missing."""
    from ..data.megadepth import MegaDepthPairsDataset
    from ..data.synthetic import generate_scene

    tmp = args.data_dir or tempfile.mkdtemp(prefix="oetr_sweep_")
    val = os.path.join(tmp, "val")
    txt = os.path.join(val, "pairs.txt")
    if not os.path.exists(txt):
        txt = generate_scene(val, n_pairs=args.val_pairs, image_hw=args.hw,
                             seed=args.val_seed, scale_range=(1.8, 3.2))
    ds = MegaDepthPairsDataset(val, txt, image_size=(args.hw, args.hw),
                               train=False)
    return [ds[i] for i in range(len(ds))]


def run(args) -> dict:
    t0 = time.time()
    device = torch.device(args.device)
    qs = [float(x) for x in args.qs.split(",")]
    pads = [float(x) for x in args.pads.split(",")]
    hw = args.hw
    model = load_model(args, device)
    log(f"params restored from {args.ckpt} ({time.time() - t0:.0f}s)")
    items = val_items(args)
    img1 = np.stack([it["image1"] for it in items])
    img2 = np.stack([it["image2"] for it in items])
    gt1 = np.stack([it["overlap_box1"] for it in items]).astype(np.float64)
    gt2 = np.stack([it["overlap_box2"] for it in items]).astype(np.float64)
    out = forward(model, img1, img2)
    log(f"forward done ({time.time() - t0:.0f}s)")

    def mode(b1, b2):
        return run_mode(items, crops_for(img1, img2, b1, b2, hw, device),
                        args, device)

    full = np.tile([0, 0, hw, hw], (len(items), 1)).astype(np.float64)
    result = {"metric": "decode_sweep", "ckpt": args.ckpt,
              "val_seed": args.val_seed, "val_pairs": len(items),
              "direct": mode(full, full), "gt_guided": mode(gt1, gt2)}
    log(f"base rows done ({time.time() - t0:.0f}s)")
    probs = {k: torch.as_tensor(out[k]) for k in ("prob_map1", "prob_map2")}
    best_key, best_auc = None, -1.0
    for q in qs:
        for pad in pads:
            b1, b2 = (b.numpy() for b in decode_boxes(
                probs, (hw, hw), (hw, hw), source="heatmap", q=q, pad=pad))
            row = mode(b1, b2)
            row["pred_miou"] = round((miou(clamp_boxes(b1, hw), gt1)
                                      + miou(clamp_boxes(b2, hw), gt2)) / 2,
                                     4)
            key = f"q{q}_pad{pad}"
            result[key] = row
            log(f"{key}: auc@5 {row['auc@5']} miou {row['pred_miou']} "
                f"({time.time() - t0:.0f}s)")
            if row["auc@5"] > best_auc:
                best_auc, best_key = row["auc@5"], key
    d5, g5 = result["direct"]["auc@5"], result["gt_guided"]["auc@5"]
    result["best"] = best_key
    result["best_lift_recovered"] = round(
        (best_auc - d5) / max(g5 - d5, 1e-9), 4)
    result["wall_s"] = round(time.time() - t0, 1)
    return result


def main(argv=None):
    args = parse_args(argv)
    require_cv2("sweep_decode (the scene writer, the dataset reads and the "
                "SIFT rows)")
    print(json.dumps(run(args)))


if __name__ == "__main__":
    main()
