"""Overlap-guided against direct matching under scale difference, on the
port (``scripts/overlap_ab_demo.py``).

  1. synthetic scale-difference pairs (camera 2 dollies in, scale
     1.8-3.2 for the held-out pairs);
  2. a small OETR trained from seeded weights on them (OETR's trainer,
     ``cycle=True`` and the optional auxiliary losses), on host epochs or,
     with ``--device_data``, on the on-device generator's pairs;
  3. held-out pairs matched SIFT -> NN -> LO-RANSAC three ways: direct
     (full images), OETR-guided (crops of the trained model's boxes,
     ``decode_boxes``, equalised by ``crop_resize_batch``, keypoints mapped
     back by ``unwarp_keypoints``) and GT-guided (the oracle boxes), each
     scored by pose AUC with a bootstrap spread.

``--ckpt_dir`` saves and resumes the whole train state with
``training/train.py``'s ``save_checkpoint`` (``step_N`` torch files);
JAX's orbax directories are not read. Prints one JSON line, the JAX
script's (``--skip_eval``: the short segment line).

    python -m oetr_tpu_torch.scripts.overlap_ab_demo [--steps 700]

The scene writer, the dataset reads and every SIFT row need cv2, so the
program runs where cv2 is.
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
from ..geometry.boxes import bbox_overlaps_aligned
from ..models.oetr import decode_boxes
from ..models.sift_based import sift_keypoints
from ..ops.warp import crop_resize_batch, unwarp_keypoints
from ..training.train import (batch_to, create_train_state,
                              latest_checkpoint_step, load_checkpoint,
                              make_train_step, save_checkpoint)
from .common import (auc_row, gray_u8, index_pairs, log, nn_matches0,
                     pose_errors, require_cv2, step_seed)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=700)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--train_pairs", type=int, default=256)
    ap.add_argument("--val_pairs", type=int, default=40)
    ap.add_argument("--val_seed", type=int, default=999,
                    help="val-set RNG seed (another seed gives a fresh "
                         "held-out set)")
    ap.add_argument("--hw", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--d_model", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--dec_layers", type=int, default=2)
    ap.add_argument("--depth", type=int, default=18,
                    help="resnet depth (18/50)")
    ap.add_argument("--milestones", type=str, default="",
                    help="comma-separated step milestones for 0.1x lr decay"
                         " (default: none)")
    ap.add_argument("--train_scale_min", type=float, default=1.8,
                    help="lower edge of the train pairs' scale range (val "
                         "pairs stay at 1.8-3.2)")
    ap.add_argument("--train_translate_frac", type=float, default=0.0,
                    help="fraction of train pairs that are pure same-scale "
                         "translations")
    ap.add_argument("--topk", type=int, default=1024)
    ap.add_argument("--ckpt_dir", type=str, default="",
                    help="checkpoint dir: resume from the latest step if "
                         "present, save the final state")
    ap.add_argument("--save_every", type=int, default=1000,
                    help="with --ckpt_dir: also save every N steps")
    ap.add_argument("--data_dir", type=str, default="",
                    help="persistent dataset dir: generate once, reuse on "
                         "restart")
    ap.add_argument("--aux_match", type=float, default=0.0,
                    help="weight of the auxiliary coarse-correspondence "
                         "InfoNCE (token matching from the known geometry)")
    ap.add_argument("--heatmap", type=float, default=0.0,
                    help="weight of dense heatmap supervision")
    ap.add_argument("--size_loss", type=float, default=0.0,
                    help="weight of the tlbr size-head supervision")
    ap.add_argument("--reweight", type=float, default=0.0,
                    help="difficulty reweighting power: per-pair loss "
                         "weights ~ scale_diff**p")
    ap.add_argument("--device_data", action="store_true",
                    help="generate training batches on the device "
                         "(data/device_synth); val pairs still from disk")
    ap.add_argument("--illum_jitter", type=float, default=0.0,
                    help="with --device_data: +-fraction illumination "
                         "gain jitter on image2")
    ap.add_argument("--box_source", type=str, default="tlbr",
                    choices=("tlbr", "heatmap"),
                    help="eval-time box decode (models.oetr.decode_boxes)")
    ap.add_argument("--box_q", type=float, default=0.1)
    ap.add_argument("--box_pad", type=float, default=0.2)
    ap.add_argument("--skip_eval", action="store_true",
                    help="train/checkpoint only; prints a short JSON "
                         "instead of the A/B table")
    ap.add_argument("--device", default="cuda",
                    help="where OETR, the crops, the matcher and the pose "
                         "estimator run")
    return ap.parse_args(argv)


def model_config(args, fused_stem: bool = False,
                 attention: str = "linear") -> OETRConfig:
    tokens = args.hw // 32       # layer3 stride 16, then the patch merge
    return OETRConfig(
        backbone=BackboneConfig(depth=args.depth, stop_layer="layer3",
                                last_layer=256 if args.depth == 18 else 1024,
                                fused_stem=fused_stem),
        neck=NeckConfig(d_model=args.d_model, nhead=8,
                        num_layers=args.layers,
                        num_decoder_layers=args.dec_layers,
                        max_shape=(tokens, tokens), attention=attention))


def train_config(args) -> TrainConfig:
    milestones = (tuple(int(m) for m in args.milestones.split(","))
                  if args.milestones else (10 ** 6,))
    return TrainConfig(batch_size=args.batch, image_size=(args.hw, args.hw),
                       lr=args.lr, lr_milestones=milestones)


def make_datasets(args):
    """(train dataset or None with --device_data, val dataset), generated
    under ``--data_dir`` (reused when present) or a temporary directory."""
    from ..data.megadepth import MegaDepthPairsDataset
    from ..data.synthetic import generate_scene

    hw = args.hw
    tmp = args.data_dir or tempfile.mkdtemp(prefix="oetr_ab_")
    train_txt = os.path.join(tmp, "train", "pairs.txt")
    val_txt = os.path.join(tmp, "val", "pairs.txt")
    if not (args.data_dir and os.path.exists(val_txt)
            and (args.device_data or os.path.exists(train_txt))):
        if not args.device_data:
            train_txt = generate_scene(
                os.path.join(tmp, "train"), n_pairs=args.train_pairs,
                image_hw=hw, seed=0,
                scale_range=(args.train_scale_min, 3.2),
                p_translate=args.train_translate_frac)
        val_txt = generate_scene(os.path.join(tmp, "val"),
                                 n_pairs=args.val_pairs, image_hw=hw,
                                 seed=args.val_seed, scale_range=(1.8, 3.2))
    else:
        log(f"reusing dataset at {tmp}")
    train_ds = None
    if not args.device_data:
        train_ds = MegaDepthPairsDataset(os.path.join(tmp, "train"),
                                         train_txt, image_size=(hw, hw),
                                         train=True)
    val_ds = MegaDepthPairsDataset(os.path.join(tmp, "val"), val_txt,
                                   image_size=(hw, hw), train=False)
    return train_ds, val_ds


def batch_stream(args, train_ds, start_step: int, device):
    """Training batches forever: host epochs, or with --device_data the
    device generator on a stream seeded from the start step."""
    if args.device_data:
        from ..data.device_synth import make_device_generator

        gen = make_device_generator(
            args.hw, args.batch,
            scale_range=(max(args.train_scale_min, 1.0), 3.2),
            p_translate=args.train_translate_frac,
            illum_jitter=args.illum_jitter, device=device)
        g = torch.Generator(device=device).manual_seed(
            step_seed(7, start_step))
        while True:
            yield gen(g)
    else:
        while True:
            train_ds.build_dataset()
            yield from train_ds.batches(args.batch,
                                        geometry=args.aux_match > 0)


def train_overlap(state, batches, args, start_step: int, generator,
                  ckpt_dir: str | None = None, t0: float | None = None):
    """Steps ``start_step`` .. ``args.steps`` of OETR's train step with the
    demo's losses (cycle, ``--aux_match``, ``--heatmap``, ``--size_loss``,
    ``--reweight``), saving every ``--save_every`` with a checkpoint dir:
    (the step reached, the last loss, a tensor or None)."""
    device = next(state.model.parameters()).device
    step_fn = make_train_step(cycle=True, aux_match_weight=args.aux_match,
                              heatmap_weight=args.heatmap,
                              size_weight=args.size_loss,
                              reweight_power=args.reweight)
    it, last = start_step, None
    for batch in batches:
        if it >= args.steps:
            break
        state, metrics = step_fn(state, batch_to(batch, device), generator)
        last = metrics["loss"]
        if it % 50 == 0 and t0 is not None:
            miou = float((metrics["iou1"] + metrics["iou2"]) / 2)
            aux = (f" aux {float(metrics['aux_match_loss']):.3f}"
                   if "aux_match_loss" in metrics else "")
            log(f"step {it} loss {float(last):.4f} train_miou {miou:.3f}"
                f"{aux} ({time.time() - t0:.0f}s)")
        it += 1
        if (ckpt_dir and args.save_every and it % args.save_every == 0
                and it < args.steps):
            save_checkpoint(ckpt_dir, state, it)
            log(f"checkpoint step {it}")
    return it, last


@torch.no_grad()
def predict_boxes(model, img1: np.ndarray, img2: np.ndarray, args,
                  chunk: int = 40):
    """Decoded overlap boxes of every pair (float64 numpy), the model in
    eval mode over padded chunks of 40."""
    device = next(model.parameters()).device
    training = model.training
    model.eval()
    d1s, d2s = [], []
    for s in range(0, len(img1), chunk):
        a = torch.as_tensor(img1[s:s + chunk]).to(device)
        b = torch.as_tensor(img2[s:s + chunk]).to(device)
        n = a.shape[0]
        if n < chunk:
            a = torch.cat([a, a[-1:].expand(chunk - n, -1, -1, -1)])
            b = torch.cat([b, b[-1:].expand(chunk - n, -1, -1, -1)])
        c1, c2 = decode_boxes(model(a, b), (args.hw, args.hw),
                              (args.hw, args.hw), source=args.box_source,
                              q=args.box_q, pad=args.box_pad)
        d1s.append(c1[:n].cpu().numpy())
        d2s.append(c2[:n].cpu().numpy())
    model.train(training)
    return (np.concatenate(d1s).astype(np.float64),
            np.concatenate(d2s).astype(np.float64))


def clamp_boxes(b, hw: int) -> np.ndarray:
    """Boxes clipped to the image; a degenerate one (< 16 px a side)
    becomes the full image."""
    b = np.asarray(b, np.float64).copy()
    b[:, 0::2] = np.clip(b[:, 0::2], 0, hw)
    b[:, 1::2] = np.clip(b[:, 1::2], 0, hw)
    bad = ((b[:, 2] - b[:, 0]) < 16) | ((b[:, 3] - b[:, 1]) < 16)
    b[bad] = [0, 0, hw, hw]
    return b


def crops_for(img1, img2, boxes1, boxes2, hw: int, device):
    """The boxes' crops on ``hw`` canvases: (crop1, ratio1, box1, crop2,
    ratio2, box2), numpy."""
    out = []
    for img, boxes in ((img1, boxes1), (img2, boxes2)):
        box = torch.as_tensor(clamp_boxes(boxes, hw), dtype=torch.float32,
                              device=device)
        crop, ratio, _ = crop_resize_batch(torch.as_tensor(img).to(device),
                                           box, (hw, hw))
        out += [crop.cpu().numpy(), ratio.cpu().numpy(), box.cpu().numpy()]
    return tuple(out)


def run_mode(items: list, crops, args, device) -> dict:
    """SIFT + NN (ratio 0.9) inside the crops, keypoints mapped back to
    the images, scored by pose AUC."""
    crop1, ratio1, box1, crop2, ratio2, box2 = crops
    t = lambda a: torch.as_tensor(np.asarray(a))[None]

    def run_pair(i, it_):
        xy0, _, v0, d0 = sift_keypoints(gray_u8(crop1[i]), args.topk,
                                        with_descriptors=True)
        xy1, _, v1, d1 = sift_keypoints(gray_u8(crop2[i]), args.topk,
                                        with_descriptors=True)
        m0 = nn_matches0(d0, d1, v0, v1, 0.9, device)
        u0 = unwarp_keypoints(t(xy0), t(box1[i]), t(ratio1[i]))[0].numpy()
        u1 = unwarp_keypoints(t(xy1), t(box2[i]), t(ratio2[i]))[0].numpy()
        return u0, u1, index_pairs(m0, m0 > -1)

    return auc_row(pose_errors(items, run_pair, device))


def evaluate(model, items: list, args, device) -> dict:
    """The trained model's boxes against GT (mean IoU) and the three
    matching modes."""
    img1 = np.stack([it_["image1"] for it_ in items])
    img2 = np.stack([it_["image2"] for it_ in items])
    pred1, pred2 = predict_boxes(model, img1, img2, args)
    gt1 = np.stack([it_["overlap_box1"] for it_ in items]).astype(np.float64)
    gt2 = np.stack([it_["overlap_box2"] for it_ in items]).astype(np.float64)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    iou1 = bbox_overlaps_aligned(f32(pred1), f32(gt1)).numpy()
    iou2 = bbox_overlaps_aligned(f32(pred2), f32(gt2)).numpy()
    full = np.tile([0, 0, args.hw, args.hw], (len(items), 1)).astype(
        np.float64)
    modes = {"direct": (full, full), "oetr_guided": (pred1, pred2),
             "gt_guided": (gt1, gt2)}
    return {"pred_box_miou": round(float((iou1.mean() + iou2.mean()) / 2), 4),
            **{name: run_mode(items, crops_for(img1, img2, b1, b2, args.hw,
                                               device), args, device)
               for name, (b1, b2) in modes.items()}}


def loss_field(last):
    value = float("nan") if last is None else float(last)
    return round(value, 4) if np.isfinite(value) else None


def run(args, params: dict | None = None) -> dict:
    """The whole program; ``params`` (a state dict) replaces the seeded
    initial weights. Returns the JSON line."""
    t0 = time.time()
    device = torch.device(args.device)
    train_ds, val_ds = make_datasets(args)
    model, state = create_train_state(model_config(args), train_config(args),
                                      device=device)
    if params is not None:
        model.load_state_dict(params)
    ckpt_dir = os.path.abspath(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt_dir:
        last_step = latest_checkpoint_step(ckpt_dir)
        if last_step is not None:
            state = load_checkpoint(ckpt_dir, last_step, state)
            start = last_step
            log(f"resumed from step {last_step}")
    generator = torch.Generator(device=device).manual_seed(step_seed(1, start))
    it, last = train_overlap(state,
                             batch_stream(args, train_ds, start, device),
                             args, start, generator, ckpt_dir, t0)
    if ckpt_dir and it > start:
        save_checkpoint(ckpt_dir, state, it)
        log(f"saved checkpoint step {it}")
    if args.skip_eval:
        return {"metric": "overlap_ab_train_segment", "steps": it,
                "train_loss_last": loss_field(last),
                "wall_s": round(time.time() - t0, 1)}
    items = [val_ds[i] for i in range(len(val_ds))]
    fields = evaluate(model, items, args, device)
    return {"metric": "overlap_ab_pose_auc", "steps": args.steps,
            "hw": args.hw, "val_pairs": args.val_pairs,
            "d_model": args.d_model, "layers": args.layers,
            "train_loss_last": loss_field(last), **fields,
            "wall_s": round(time.time() - t0, 1)}


def main(argv=None):
    args = parse_args(argv)
    require_cv2("overlap_ab_demo (the scene writer, the dataset reads and "
                "the SIFT rows)")
    print(json.dumps(run(args)))


if __name__ == "__main__":
    main()
