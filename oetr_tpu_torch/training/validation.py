"""Training-time validation: IoU recall of predicted overlap boxes (port of
``oetr_tpu/training/validation.py``).

Per-pair IoU (and optionally OIoU) of the predicted against the
ground-truth boxes over the validation batches' valid pairs, both images;
recall at thresholds 0.5:0.05:0.95, headline R0.5 / R0.75 / R0.9.
"""
from __future__ import annotations

import numpy as np
import torch

from ..evalx.metrics import iou_recalls
from ..geometry.boxes import bbox_oiou, bbox_overlaps_aligned


def evaluate(model, batches, oiou: bool = False) -> dict:
    """Recall summary of ``model``'s boxes over an iterable of batches,
    each a dict with image1/image2 [B, H, W, 3], overlap_box1/2 [B, 4] and
    overlap_valid [B] (numpy arrays or tensors). The forward runs in eval
    mode under ``torch.no_grad`` on the model's device; the model's mode
    is restored."""
    device = next(model.parameters()).device
    training = model.training
    model.eval()
    ious, oious = [], []
    try:
        with torch.no_grad():
            for batch in batches:
                out = model(torch.as_tensor(batch["image1"]).to(device),
                            torch.as_tensor(batch["image2"]).to(device))
                v = np.asarray(torch.as_tensor(batch["overlap_valid"]))
                for side in ("1", "2"):
                    pred = out[f"pred_bbox{side}"].cpu()[torch.from_numpy(v)]
                    gt = torch.as_tensor(batch[f"overlap_box{side}"])[
                        torch.from_numpy(v)].float()
                    if len(pred) == 0:
                        continue
                    ious += bbox_overlaps_aligned(pred, gt).tolist()
                    if oiou:
                        oious += bbox_oiou(gt, pred).tolist()
    finally:
        model.train(training)

    recalls = iou_recalls(ious) if ious else np.zeros(10)
    out = {
        "recalls": recalls,
        "R0.5": float(recalls[0]),
        "R0.75": float(recalls[5]),
        "R0.9": float(recalls[8]),
        "mean_iou": float(np.mean(ious)) if ious else 0.0,
        "num_samples": len(ious),
    }
    if oiou and oious:
        out["oiou_recalls"] = iou_recalls(oious)
        out["mean_oiou"] = float(np.mean(oious))
    return out
