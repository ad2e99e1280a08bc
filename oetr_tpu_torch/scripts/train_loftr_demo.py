"""LoFTR end to end on the port (``scripts/train_loftr_demo.py``): train the
dense matcher from scratch, report its pose AUC.

Trains LoFTR (``--d_coarse`` 192, d_fine 96, ``--layers`` 4 coarse
layers, 1024 matches) on fresh scene pairs from the on-device generator,
with coarse-cell GT assignments from depth and pose and, with
``--fine_weight`` > 0, the fine loss against the continuous warp of the
cell centres; then scores pose AUC on the held-out scenes of the sparse
demo's protocol (seed 99) beside SIFT + NN. The optimiser is JAX's chain
(global-norm clip 1.0, Adam, x0.1 at 70% of the steps). Step ``it``'s
pairs come from a ``torch.Generator`` seeded from the step, so a resumed
run draws what an uninterrupted one draws.

``--ckpt_dir`` keeps the final parameters (``loftr``) and the segment
state (``loftr_state``) as torch files with
``training/train.py::save_checkpoint``'s keys; ``--max_steps_per_segment``
saves the state and re-executes the program. Prints one JSON line, the JAX
script's.

    python -m oetr_tpu_torch.scripts.train_loftr_demo [--steps 6000]

The held-out scenes and the SIFT row need cv2 (the training does not).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..data.device_synth import make_device_generator
from ..models.loftr import build_loftr
from ..training.loftr import make_loftr_train_step, warp_cell_centers_batch
from ..training.superglue import gt_matches_batch
from .common import (LUM, Segments, adam, auc_row, gray_of, load_state, log,
                     pose_errors, require_cv2, restore, save_state, saver,
                     sift_nn, step_generator)

MODULE = "oetr_tpu_torch.scripts.train_loftr_demo"
SEED = 17


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--hw", type=int, default=256)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--d_coarse", type=int, default=192)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--val_pairs", type=int, default=200)
    ap.add_argument("--fine_weight", type=float, default=1.0,
                    help="weight of the fine refinement loss (0 = coarse "
                    "only)")
    ap.add_argument("--ckpt_dir", type=str, default="")
    ap.add_argument("--max_steps_per_segment", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where LoFTR trains and runs")
    return ap.parse_args(argv)


def build_model(args, device, generator: torch.Generator | None = None):
    """The demo's LoFTR, weights from ``generator`` (seed 0 when None)."""
    return build_loftr(device=device, generator=generator,
                       d_coarse=args.d_coarse, d_fine=96,
                       coarse_layers=args.layers, max_matches=1024)


def cell_centers(hw: int, device) -> torch.Tensor:
    """The coarse cell centres [N, 2] in pixels (stride 8, 8·i + 3.5)."""
    u = torch.arange(hw // 8, dtype=torch.float32, device=device) * 8 + 3.5
    gy, gx = torch.meshgrid(u, u, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


@torch.no_grad()
def prep(raw: dict, centers: torch.Tensor):
    """A scene batch -> the step's inputs: gray images, the coarse GT
    assignment (mutual NN within 6 px, occlusion-checked) and the
    continuous warp of the cell centres with its validity."""
    lum = torch.tensor(LUM, device=raw["image1"].device)
    g0 = raw["image1"] @ lum[:, None]
    g1 = raw["image2"] @ lum[:, None]
    ctr = centers[None].expand(g0.shape[0], -1, -1)
    ones = torch.ones(ctr.shape[:2], dtype=torch.bool, device=ctr.device)
    T = raw["pose2"] @ torch.linalg.inv_ex(raw["pose1"]).inverse
    gt = gt_matches_batch(ctr, ones, ctr, ones, raw["depth1"], raw["K1"], T,
                          raw["K2"], depth1=raw["depth2"], radius=6.0)
    gt_xy1, gt_ok1 = warp_cell_centers_batch(ctr, raw["depth1"], raw["K1"],
                                             T, raw["K2"],
                                             depth1=raw["depth2"])
    return g0, g1, gt, gt_xy1, gt_ok1


def device_batches(args, device):
    """``raw_of(it)``: step ``it``'s scene pairs from the device generator."""
    gen = make_device_generator(args.hw, args.batch, scale_range=(1.0, 2.0),
                                p_translate=0.5, device=device)
    return lambda it: gen(step_generator(SEED, it, device))


def train_loftr(model, opt, sched, args, raw_of, start: int = 0,
                stop: int | None = None, segments: Segments | None = None,
                save=None, t0: float | None = None) -> dict | None:
    """LoFTR's steps ``start`` .. ``stop`` (``args.steps`` when None) of an
    ``args.steps``-step run on ``raw_of(it)``, ticking ``segments`` (one
    step a tick) with ``save(next_step)``. Returns the last step's
    metrics."""
    device = next(model.parameters()).device
    centers = cell_centers(args.hw, device)
    step_fn = make_loftr_train_step(model, opt, fine_weight=args.fine_weight,
                                    scheduler=sched, clip_norm=1.0)
    model.train()
    m = None
    for it in range(start, args.steps if stop is None else stop):
        g0, g1, gt, gt_xy1, gt_ok1 = prep(raw_of(it), centers)
        if args.fine_weight:
            m = step_fn(g0, g1, gt, gt_xy1, gt_ok1)
        else:
            m = step_fn(g0, g1, gt)
        if it % 100 == 0:
            loss = float(m["loss"])
            fine = (f" fine {float(m['fine_loss']):.4f} "
                    f"(sup {float(m['fine_frac']):.3f})"
                    if "fine_loss" in m else "")
            if t0 is not None:
                log(f"step {it} loss {loss:.4f}{fine} "
                    f"({time.time() - t0:.0f}s)")
            if not np.isfinite(loss):
                raise RuntimeError(f"diverged at {it}")
        if segments and segments.due(it, args.steps):
            segments.tick(lambda: save(it + 1))
    model.eval()
    return m


@torch.no_grad()
def match_pairs(model, items: list, chunk: int = 8) -> list:
    """(mkpts0, mkpts1, valid) of every item, in padded chunks of 8."""
    device = next(model.parameters()).device
    mk = []
    for s in range(0, len(items), chunk):
        part = items[s:s + chunk]
        padded = part + [part[-1]] * (chunk - len(part))
        g = lambda key: torch.as_tensor(
            np.stack([gray_of(i, key) for i in padded])).to(device)
        out = model(g("image1"), g("image2"))
        mk += [tuple(out[k][j].cpu().numpy()
                     for k in ("mkpts0", "mkpts1", "valid"))
               for j in range(len(part))]
    return mk


def evaluate(model, items: list, device, sift: bool = True) -> dict:
    """The ``loftr`` row (dense matches are their own keypoints: index i
    matches index i) and, with ``sift``, the SIFT + NN row (512
    keypoints, ratio 0.95; needs cv2)."""
    mk = match_pairs(model, items)

    def loftr_pair(pi, it_):
        m0, m1, v = mk[pi]
        sel = np.nonzero(v)[0]
        return m0[sel], m1[sel], np.stack([np.arange(len(sel))] * 2)

    rows = {"loftr": auc_row(pose_errors(items, loftr_pair, device))}
    if sift:
        rows["sift_nn"] = auc_row(pose_errors(
            items, lambda pi, it_: sift_nn(it_["image1"], it_["image2"], 512,
                                           0.95, device), device))
    return rows


def val_items(base: str, args) -> list:
    from ..data.megadepth import MegaDepthPairsDataset
    from ..data.synthetic import generate_scene

    txt = generate_scene(os.path.join(base, "val"), n_pairs=args.val_pairs,
                         image_hw=args.hw, seed=99, scale_range=(1.0, 2.0),
                         p_translate=0.5)
    ds = MegaDepthPairsDataset(os.path.join(base, "val"), txt,
                               image_size=(args.hw, args.hw), train=False)
    return [ds[i] for i in range(len(ds))]


def run(args, argv: list[str], base: str | None = None) -> dict:
    t0 = time.time()
    device = torch.device(args.device)
    model = build_model(args, device)
    final = state_path = None
    if args.ckpt_dir:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        final = os.path.join(args.ckpt_dir, "loftr")
        state_path = os.path.join(args.ckpt_dir, "loftr_state")
    saved = load_state(final) if final else None
    if saved is not None:
        log("restoring final loftr params")
        model.load_state_dict(saved["model"])
    elif args.steps > 0:
        opt, sched = adam(model, args.lr, args.steps)
        start = restore(state_path, model, opt, sched)
        # JAX's script segments only with a checkpoint directory.
        segments = Segments(args.max_steps_per_segment if state_path else 0,
                            argv, MODULE, every=1)
        train_loftr(model, opt, sched, args, device_batches(args, device),
                    start, segments=segments,
                    save=saver(state_path, model, opt, sched), t0=t0)
        if final and not os.path.exists(final):
            save_state(final, step=args.steps, model=model.state_dict())

    items = val_items(base or tempfile.mkdtemp(prefix="oetr_loftr_"), args)
    rows = evaluate(model, items, device)
    return {"metric": "loftr_pose_auc", "steps": args.steps, "hw": args.hw,
            "d_coarse": args.d_coarse, "fine_weight": args.fine_weight,
            "val_pairs": args.val_pairs, **rows,
            "wall_s": round(time.time() - t0, 1)}


def main(argv=None):
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    require_cv2("train_loftr_demo (the held-out scenes and the SIFT row)")
    print(json.dumps(run(args, argv)))


if __name__ == "__main__":
    main()
