"""From-scratch training demo on the port (``scripts/train_demo.py``):
synthetic scenes -> OETR -> IoU recall.

Trains a small OETR (ResNet18 to layer3, d_model 64, 8 heads, 2 encoder
and 2 decoder layers) from seeded weights on the host scene generator's
two-view pairs (``data/synthetic.generate_scene``: exact GT overlap boxes)
with OETR's trainer (AdamW, ``cycle=True``), and reports the IoU-recall
table (``training/validation.evaluate``) before and after. Prints one
JSON line, the JAX script's.

    python -m oetr_tpu_torch.scripts.train_demo [--steps 300] [--device cpu]

The scene writer and the dataset reads need cv2. The phases take their
model and batches, so a caller can train on the on-device generator's
pairs instead (``data/device_synth.make_device_generator``).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..config import BackboneConfig, NeckConfig, OETRConfig, TrainConfig
from ..training.train import batch_to, create_train_state, make_train_step
from ..training.validation import evaluate
from .common import log, require_cv2


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--train_pairs", type=int, default=192)
    ap.add_argument("--val_pairs", type=int, default=48)
    ap.add_argument("--hw", type=int, default=160)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains and runs")
    return ap.parse_args(argv)


def model_config(fused_stem: bool = False,
                 attention: str = "linear") -> OETRConfig:
    """The demo's OETR; ``fused_stem`` and ``attention='linear:cuda'``
    put K3 and K2 on its path (JAX's script runs with them off)."""
    return OETRConfig(
        backbone=BackboneConfig(depth=18, stop_layer="layer3",
                                last_layer=256, fused_stem=fused_stem),
        neck=NeckConfig(d_model=64, nhead=8, num_layers=2,
                        num_decoder_layers=2, max_shape=(16, 16),
                        attention=attention))


def train_config(args) -> TrainConfig:
    return TrainConfig(batch_size=args.batch, image_size=(args.hw, args.hw),
                       lr=args.lr, lr_milestones=(10 ** 6,))


def write_scenes(base: str, args) -> None:
    """Fresh scenes under ``base``/train and ``base``/val (seeds 0 and
    999, as JAX's script)."""
    from ..data.synthetic import generate_scene

    for name, n, seed in (("train", args.train_pairs, 0),
                          ("val", args.val_pairs, 999)):
        generate_scene(os.path.join(base, name), n_pairs=n,
                       image_hw=args.hw, seed=seed)


def open_datasets(base: str, hw: int):
    """(train, val) ``MegaDepthPairsDataset``s of the scenes under
    ``base``; the training one resamples its pairs from numpy's global
    generator."""
    from ..data.megadepth import MegaDepthPairsDataset

    return tuple(MegaDepthPairsDataset(
        os.path.join(base, name), os.path.join(base, name, "pairs.txt"),
        image_size=(hw, hw), train=name == "train")
        for name in ("train", "val"))


def epoch_batches(train_ds, batch: int):
    """Host batches forever, the pairs resampled every epoch."""
    while True:
        train_ds.build_dataset()
        yield from train_ds.batches(batch)


def train_oetr(state, batches, steps: int,
               generator: torch.Generator | None, t0: float | None = None):
    """``steps`` of OETR's train step (``cycle=True``, as JAX's script) on
    ``batches`` (numpy or device dicts); the losses, tensors on the device
    (read only where logged)."""
    device = next(state.model.parameters()).device
    step_fn, losses = make_train_step(cycle=True), []
    for it, batch in zip(range(steps), batches):
        state, metrics = step_fn(state, batch_to(batch, device), generator)
        losses.append(metrics["loss"])
        if it % 25 == 0 and t0 is not None:
            log(f"step {it} loss {float(metrics['loss']):.4f} "
                f"iou {float(metrics['iou1']):.3f} "
                f"({time.time() - t0:.0f}s)")
    return losses


def summary(args, losses, r_init: dict, r_final: dict, t0: float) -> dict:
    """The JAX script's JSON line."""
    scalars = lambda r: {k: round(float(v), 4) for k, v in r.items()
                         if np.ndim(v) == 0}
    return {
        "metric": "synthetic_overlap_iou_recall",
        "steps": args.steps, "batch": args.batch, "hw": args.hw,
        "loss_first": round(float(losses[0]), 4),
        "loss_last": round(float(losses[-1]), 4),
        "init": scalars(r_init), "final": scalars(r_final),
        "wall_s": round(time.time() - t0, 1),
    }


def run(args, train_ds, val_ds, model_cfg: OETRConfig | None = None,
        params: dict | None = None, t0: float | None = None) -> dict:
    """Train and score on the given datasets: the JSON line. ``params``
    (a state dict) replaces the seeded initial weights."""
    t0 = time.time() if t0 is None else t0
    model, state = create_train_state(model_cfg or model_config(),
                                      train_config(args), device=args.device)
    if params is not None:
        model.load_state_dict(params)
    r_init = evaluate(model, val_ds.batches(args.batch))
    log(f"init recall: {r_init}")
    generator = torch.Generator(device=args.device).manual_seed(1)
    losses = train_oetr(state, epoch_batches(train_ds, args.batch),
                        args.steps, generator, t0)
    r_final = evaluate(model, val_ds.batches(args.batch))
    return summary(args, losses, r_init, r_final, t0)


def main(argv=None):
    args = parse_args(argv)
    require_cv2("train_demo (the scene writer and the dataset reads)")
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="oetr_synth_")
    write_scenes(tmp, args)
    train_ds, val_ds = open_datasets(tmp, args.hw)
    print(json.dumps(run(args, train_ds, val_ds, t0=t0)))


if __name__ == "__main__":
    main()
