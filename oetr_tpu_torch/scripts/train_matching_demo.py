"""Learned SuperPoint + SuperGlue end to end on the port
(``scripts/train_matching_demo.py``): train from scratch, then score
against SIFT + NN on the synthetic pose benchmark.

  1. SuperPoint: the joint step, MagicPoint's detector loss on synthetic
     shapes plus the descriptor hinge on texture homography pairs, from
     host batches (cv2) or with ``--device_data`` from the on-device pair
     generator with a texture-domain teacher (``--teacher corner``:
     Shi-Tomasi labels; ``ha``: homographic adaptation from 40% of the
     steps; ``none``);
  2. SuperGlue: the transport NLL on GT assignments from the scenes'
     depth and pose, over the trained SuperPoint's keypoints (host scenes,
     or ``--device_data`` fresh on-device scene pairs);
  3. held-out scenes: SIFT + NN, SP + NN and SP + SG rows (pose AUC with a
     bootstrap spread, precision, matches), detector repeatability, GT
     assignment precision and recall, and the SG >= NN gate.

The optimiser is JAX's chain: optax's global-norm clip at 1.0, then Adam
on a piecewise-constant rate (x0.1 at 70% of the steps). Host streams are
numpy in JAX's order of draws (texture pool, shapes batch, homographies,
SuperGlue's permutation); device streams are a ``torch.Generator`` a step,
seeded from the step (``common.step_seed``), so a resumed run draws what
an uninterrupted one draws. On resume of the host SuperPoint path the
numpy stream is reseeded with 1000 + the step, as JAX's script does.

``--ckpt_dir`` keeps the final parameters (``superpoint``, ``superglue``)
and the segment state (``superpoint_state``, ``superglue_state``) in JAX's
orbax layout (``common.py``), so JAX's script, its
``build_shipped_model`` and the port's read what this program trains and
the other way round; a finished phase is restored instead of trained.
``--max_steps_per_segment`` saves the state and re-executes the program
after that many steps. Prints one JSON line, the JAX script's.

    python -m oetr_tpu_torch.scripts.train_matching_demo [--device_data]

The scene writer, the dataset reads and the SIFT rows need cv2; so does
the host SuperPoint path (``cv2.warpPerspective``).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..data.device_synth import (make_device_generator,
                                 make_homography_pair_generator)
from ..models.sift_based import sift_keypoints
from ..models.superglue import build_superglue
from ..models.superpoint import build_superpoint, build_superpoint_net
from ..training.losses import interpolate_depth
from ..training.superglue import gt_matches_batch, make_superglue_train_step
from ..training.superpoint import (corners_to_cell_labels,
                                   make_corner_labeler, make_ha_labeler,
                                   make_superpoint_joint_ha_train_step,
                                   make_superpoint_joint_train_step,
                                   random_homography, synthetic_shapes_batch)
from .common import (LUM, Segments, adam, auc_row, gray_of, gray_u8,
                     index_pairs, load_final, log, nn_matches0, pose_errors,
                     relative_pose, require_cv2, restore, save_final, saver,
                     sift_nn, step_generator)

MODULE = "oetr_tpu_torch.scripts.train_matching_demo"
SP_LR = 5e-4
SG_HOST_LR = 1e-4        # the host SuperGlue path's rate (not --sg_lr)
HP_SEED, SG_SEED = 11, 23
HA_OFFSET = 10 ** 6      # the HA labeler's draws: step 10**6 + it of HP_SEED


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sp_steps", type=int, default=2000)
    ap.add_argument("--sg_steps", type=int, default=1500)
    ap.add_argument("--sp_batch", type=int, default=32)
    ap.add_argument("--sg_batch", type=int, default=8)
    ap.add_argument("--sp_hw", type=int, default=128)
    ap.add_argument("--hw", type=int, default=256,
                    help="scene pair size for SG training + eval")
    ap.add_argument("--topk", type=int, default=512)
    ap.add_argument("--train_pairs", type=int, default=192)
    ap.add_argument("--val_pairs", type=int, default=40)
    ap.add_argument("--tex_pool", type=int, default=160)
    ap.add_argument("--ckpt_dir", type=str, default="")
    ap.add_argument("--desc_dim", type=int, default=128)
    ap.add_argument("--device_data", action="store_true",
                    help="stream both training phases from on-device "
                         "generators (data/device_synth): fresh texture "
                         "homography pairs for the SP descriptor hinge and "
                         "fresh scene pairs with GT assignments for SG")
    ap.add_argument("--sg_lr", type=float, default=1e-4)
    ap.add_argument("--teacher", choices=("corner", "ha", "none"),
                    default="corner",
                    help="texture-domain detector supervision for the "
                         "--device_data SP phase: 'ha' = homographic "
                         "adaptation from the current detector (from 40%% "
                         "of the steps), 'corner' = the static Shi-Tomasi "
                         "teacher (training/superpoint.make_corner_labeler)"
                         " from step 0, 'none' = shapes + descriptor only")
    ap.add_argument("--max_steps_per_segment", type=int, default=0,
                    help="checkpoint the phase state and re-execute the "
                         "process after this many optimizer steps (SP + SG "
                         "combined); 0 = off. Requires --ckpt_dir.")
    ap.add_argument("--device", default="cuda",
                    help="where the networks train and run")
    args = ap.parse_args(argv)
    if args.max_steps_per_segment and not args.ckpt_dir:
        ap.error("--max_steps_per_segment requires --ckpt_dir")
    return args


# ------------------------------------------------------------ geometry --

def warp_points_via_depth(xy, depth1, K1, T_0to1, K2):
    """[K, 2] image-1 points -> image 2 through depth and pose, in float32:
    (xy2 [K, 2], ok [K]) as numpy."""
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    xy, K1, T, K2 = f(xy), f(K1), f(T_0to1), f(K2)
    z, ok = interpolate_depth(f(depth1)[None], xy[None])
    z, ok = z[0], ok[0]
    x = (xy[:, 0] - K1[0, 2]) * z / K1[0, 0]
    y = (xy[:, 1] - K1[1, 2]) * z / K1[1, 1]
    P = torch.stack([x, y, z], dim=-1)
    Pc2 = P @ T[:3, :3].T + T[:3, 3]
    uv = Pc2 @ K2.T
    w = uv[:, 2:]
    xy2 = uv[:, :2] / torch.where(w.abs() > 1e-9, w, torch.full_like(w, 1e-9))
    ok = ok & (Pc2[:, 2] > 1e-6)
    return xy2.numpy(), ok.numpy()


def gt_matches_from_geometry(xy0, v0, xy1, v1, depth1, K1, T_0to1, K2,
                             radius=3.0):
    """Mutual-NN GT assignment under the known warp: [K] int32, -1
    unmatched."""
    xy2, ok = warp_points_via_depth(xy0, depth1, K1, T_0to1, K2)
    ok = ok & np.asarray(v0)
    d = np.linalg.norm(xy2[:, None] - np.asarray(xy1)[None], axis=-1)
    d[~ok] = 1e9
    d[:, ~np.asarray(v1)] = 1e9
    nn1 = d.argmin(1)
    best = d[np.arange(len(xy0)), nn1]
    nn0 = d.argmin(0)
    mutual = nn0[nn1] == np.arange(len(xy0))
    return np.where((best < radius) & mutual, nn1, -1).astype(np.int32)


# -------------------------------------------------------- superpoint --

def texture_pool(rng: np.random.Generator, n: int, hw: int) -> list:
    """``n`` gray textures [hw, hw] float32 in [0, 1] (cv2's gray)."""
    import cv2

    from ..data.synthetic import _texture

    return [cv2.cvtColor(_texture(rng, hw, hw),
                         cv2.COLOR_RGB2GRAY).astype(np.float32) / 255.0
            for _ in range(n)]


def host_pair_batch(pool: list, hw: int):
    """``pair_batch(rng, b, it) -> (im0, im1, H)``: pool textures and their
    cv2 warps under random homographies (scale 0.55-1.8), numpy."""
    import cv2

    def pair_batch(rng, b, it=0):
        im0 = np.zeros((b, hw, hw, 1), np.float32)
        im1 = np.zeros((b, hw, hw, 1), np.float32)
        Hs = np.zeros((b, 3, 3), np.float64)
        for i in range(b):
            g = pool[int(rng.integers(len(pool)))]
            H = random_homography(rng, (hw, hw), scale_range=(0.55, 1.8))
            im0[i, :, :, 0] = g
            im1[i, :, :, 0] = cv2.warpPerspective(
                g, H, (hw, hw), flags=cv2.INTER_LINEAR,
                borderMode=cv2.BORDER_CONSTANT, borderValue=0.0)
            Hs[i] = H
        return im0, im1, Hs

    return pair_batch


def device_pair_batch(hw: int, b: int, device):
    """``pair_batch(rng, b, it)`` from the on-device homography pair
    generator, step ``it``'s draws from its own generator."""
    gen = make_homography_pair_generator(hw, b, scale_range=(0.55, 1.8),
                                         device=device)
    return lambda rng, b_, it=0: gen(step_generator(HP_SEED, it, device))


def train_superpoint(net, opt, sched, args, rng, pair_batch, start: int = 0,
                     stop: int | None = None,
                     segments: Segments | None = None, save=None,
                     t0: float | None = None) -> dict | None:
    """SuperPoint's steps ``start`` .. ``stop`` (``args.sp_steps`` when
    None) of an ``args.sp_steps``-step run: each a shapes
    batch from ``rng`` and a pair batch from ``pair_batch``; with
    ``--device_data`` and a teacher, the joint step with texture-domain
    labels. Returns the last step's metrics (tensors on the device)."""
    device = next(net.parameters()).device
    t = lambda a: torch.as_tensor(a).to(device)
    teacher = args.device_data and args.teacher != "none"
    clip = dict(scheduler=sched, clip_norm=1.0)
    if teacher:
        if args.teacher == "ha":
            ha_label = make_ha_labeler(net, args.sp_hw)
            ha_start = int(args.sp_steps * 0.4)
        else:
            corner_label = make_corner_labeler(args.sp_hw, device=device)
            ha_start = 0
        step_ha = make_superpoint_joint_ha_train_step(
            net, opt, lambda_desc=1.0, lambda_ha=1.0, **clip)
    else:
        step = make_superpoint_joint_train_step(net, opt, lambda_desc=1.0,
                                                **clip)
    hc, b, hw = args.sp_hw // 8, args.sp_batch, args.sp_hw
    m = None
    stop = args.sp_steps if stop is None else stop
    for it in range(start, stop):
        imgs, corners, counts = synthetic_shapes_batch(rng, b, hw)
        labels = t(corners_to_cell_labels(corners, (hw, hw), counts))
        im0, im1, H = (t(x).float() for x in pair_batch(rng, b, it))
        if teacher:
            if it >= ha_start:
                hl = (ha_label(im0, step_generator(HP_SEED, HA_OFFSET + it,
                                                   device))
                      if args.teacher == "ha" else corner_label(im0))
                ha_w = 1.0
            else:
                hl = torch.full((b, hc, hc), 64, dtype=torch.int32,
                                device=device)
                ha_w = 0.0
            m = step_ha(t(imgs), labels, im0, im1, H, hl, ha_w)
        else:
            m = step(t(imgs), labels, im0, im1, H)
        if it % 100 == 0:
            det, des = float(m["det_loss"]), float(m["desc_loss"])
            ha = float(m.get("ha_loss", 0.0))
            if t0 is not None:
                log(f"SP step {it} det {det:.3f} desc {des:.3f} "
                    f"ha {ha:.3f} ({time.time() - t0:.0f}s)")
            if not (np.isfinite(det) and np.isfinite(des)):
                raise RuntimeError(f"SP training diverged at {it}")
        if segments and segments.due(it, args.sp_steps):
            segments.tick(lambda: save(it + 1))
    return m


def extractor(net, args):
    """The fixed-k SuperPoint sharing ``net``'s weights: threshold 0, the
    top-k cells by score."""
    device = next(net.parameters()).device
    sp = build_superpoint(device=device, max_keypoints=args.topk,
                          keypoint_threshold=0.0,
                          descriptor_dim=args.desc_dim)
    sp.net = net
    return sp.eval()


@torch.no_grad()
def extract(sp, grays: np.ndarray) -> dict:
    """SuperPoint on [B, hw, hw, 1] numpy grays: numpy outputs."""
    device = next(sp.parameters()).device
    out = sp(torch.as_tensor(grays).to(device))
    return {k: out[k].cpu().numpy()
            for k in ("keypoints", "scores", "descriptors", "valid")}


def extract_pairs(sp, items: list, chunk: int = 16) -> list:
    """[(features of image1, of image2)] for every item, in chunks."""
    feats = []
    for s in range(0, len(items), chunk):
        part = items[s:s + chunk]
        e0 = extract(sp, np.stack([gray_of(it, "image1") for it in part]))
        e1 = extract(sp, np.stack([gray_of(it, "image2") for it in part]))
        feats += [({k: v[j] for k, v in e0.items()},
                   {k: v[j] for k, v in e1.items()}) for j in range(len(part))]
    return feats


# --------------------------------------------------------- superglue --

SG_KEYS = ("keypoints", "scores", "descriptors", "valid")


def sg_batch_of(pairs: list, hw: int, device, gt: list | None = None) -> dict:
    """SuperGlue's input dict from [(e0, e1)] numpy features."""
    t = lambda a: torch.as_tensor(np.stack(a)).to(device)
    batch = {}
    for key in SG_KEYS:
        for side in (0, 1):
            batch[f"{key}{side}"] = t([p[side][key] for p in pairs])
    if gt is not None:
        batch["gt_matches0"] = t(gt)
    batch["image_hw0"] = batch["image_hw1"] = (hw, hw)
    return batch


def build_sg(args, device, generator: torch.Generator | None = None):
    """The demo's SuperGlue, weights from ``generator`` (seed 0 when
    None)."""
    return build_superglue(device=device, generator=generator,
                           descriptor_dim=args.desc_dim)


def sg_host_features(sp, train_ds) -> list:
    """The host path's static data: every training pair's features and
    its GT assignment from depth and pose."""
    feats = []
    for s in range(0, len(train_ds), 16):
        items = [train_ds[i] for i in range(s, min(s + 16, len(train_ds)))]
        for it_, (e0, e1) in zip(items, extract_pairs(sp, items)):
            gt = gt_matches_from_geometry(
                e0["keypoints"], e0["valid"], e1["keypoints"], e1["valid"],
                it_["depth1"], it_["intrinsics1"], relative_pose(it_),
                it_["intrinsics2"])
            feats.append((e0, e1, gt))
    return feats


def sg_host_batches(feats: list, rng, b: int, hw: int, device):
    """Batches of ``b`` pairs in the order of ``rng``'s permutations."""
    n = len(feats)
    order, pos = rng.permutation(n), 0
    while True:
        idx = [int(order[(pos + j) % n]) for j in range(b)]
        pos += b
        if pos >= n:
            order, pos = rng.permutation(n), 0
        yield sg_batch_of([feats[i][:2] for i in idx], hw, device,
                          [feats[i][2] for i in idx])


@torch.no_grad()
def sg_device_prep(sp, raw: dict, hw: int) -> dict:
    """A device scene batch -> SuperGlue's batch: gray images, frozen
    SuperPoint, GT assignments from depth and pose, all on the device."""
    lum = torch.tensor(LUM, device=raw["image1"].device)
    e0 = sp(raw["image1"] @ lum[:, None])
    e1 = sp(raw["image2"] @ lum[:, None])
    T = raw["pose2"] @ torch.linalg.inv_ex(raw["pose1"]).inverse
    gt = gt_matches_batch(e0["keypoints"], e0["valid"], e1["keypoints"],
                          e1["valid"], raw["depth1"], raw["K1"], T,
                          raw["K2"], depth1=raw["depth2"])
    batch = {f"{k}{s}": e[k] for k in SG_KEYS for s, e in ((0, e0), (1, e1))}
    return dict(batch, gt_matches0=gt, image_hw0=(hw, hw), image_hw1=(hw, hw))


def device_sg_batches(sp, args, device, start: int = 0):
    """Step ``it``'s SuperGlue batch from the on-device scene generator."""
    gen = make_device_generator(args.hw, args.sg_batch, scale_range=(1.0, 2.0),
                                p_translate=0.5, device=device)
    it = start
    while True:
        yield sg_device_prep(sp, gen(step_generator(SG_SEED, it, device)),
                             args.hw)
        it += 1


def train_superglue(sg, opt, sched, batches, steps: int, start: int = 0,
                    log_every: int = 100, segments: Segments | None = None,
                    save=None, t0: float | None = None) -> dict | None:
    """SuperGlue's steps ``start`` .. ``steps`` on ``batches``; the last
    step's metrics."""
    step = make_superglue_train_step(sg, opt, scheduler=sched, clip_norm=1.0)
    m = None
    for it, batch in zip(range(start, steps), batches):
        m = step(batch)
        if it % log_every == 0 and t0 is not None:
            n_gt = float((batch["gt_matches0"] >= 0).sum(-1).float().mean())
            log(f"SG step {it} nll {float(m['loss']):.4f} acc "
                f"{float(m['match_acc']):.3f} gt/pair {n_gt:.0f} "
                f"({time.time() - t0:.0f}s)")
        if segments and segments.due(it, steps):
            segments.tick(lambda: save(it + 1))
    return m


@torch.no_grad()
def sg_matches0(sg, feats: list, args, device) -> list:
    """SuperGlue's matches0 of every pair, in batches of ``sg_batch``
    (the last padded with its last pair)."""
    out = []
    for s in range(0, len(feats), args.sg_batch):
        chunk = feats[s:s + args.sg_batch]
        padded = chunk + [chunk[-1]] * (args.sg_batch - len(chunk))
        m = sg(sg_batch_of(padded, args.hw, device))["matches0"].cpu().numpy()
        out += [m[j] for j in range(len(chunk))]
    return out


# -------------------------------------------------------------- eval --

def repeatability(items: list, kp_of_pair, hw: int, radius=3.0) -> float:
    """Detector repeatability@radius under the known depth and pose warp:
    the share of detections that, warped into the other image, have a
    detection there within ``radius`` px (both directions; only warps
    landing inside the frame count)."""
    fracs = []
    for pi, it_ in enumerate(items):
        xy0, v0, xy1, v1 = kp_of_pair(pi, it_)
        T10 = relative_pose(it_)
        for (xa, va, xb, vb, Tab, da, Ka, Kb) in (
                (xy0, v0, xy1, v1, T10, it_["depth1"], it_["intrinsics1"],
                 it_["intrinsics2"]),
                (xy1, v1, xy0, v0, np.linalg.inv(T10), it_["depth2"],
                 it_["intrinsics2"], it_["intrinsics1"])):
            w, ok = warp_points_via_depth(xa, da, Ka, Tab, Kb)
            ok = ok & np.asarray(va)
            inb = (ok & (w[:, 0] >= 0) & (w[:, 0] <= hw - 1)
                   & (w[:, 1] >= 0) & (w[:, 1] <= hw - 1))
            if inb.sum() == 0:
                continue
            d = np.linalg.norm(w[inb][:, None] - np.asarray(xb)[None],
                               axis=-1)
            d[:, ~np.asarray(vb)] = 1e9
            fracs.append(float((d.min(1) < radius).mean()))
    return round(float(np.mean(fracs)), 4)


def assign_pr(items: list, feats: list, m0_of_pair) -> dict:
    """GT-assignment precision and recall of matches0 on held-out pairs."""
    ps, rs = [], []
    for pi, it_ in enumerate(items):
        e0, e1 = feats[pi]
        gt = gt_matches_from_geometry(
            e0["keypoints"], e0["valid"], e1["keypoints"], e1["valid"],
            it_["depth1"], it_["intrinsics1"], relative_pose(it_),
            it_["intrinsics2"])
        m0 = m0_of_pair(pi)
        sel = (m0 > -1) & e0["valid"]
        has = (gt >= 0) & e0["valid"]
        ps.append(((m0 == gt) & sel).sum() / max(sel.sum(), 1))
        rs.append(((m0 == gt) & has).sum() / max(has.sum(), 1))
    return {"assign_precision": round(float(np.mean(ps)), 4),
            "assign_recall": round(float(np.mean(rs)), 4)}


def evaluate(sp, sg, items: list, args, device, sift: bool = True) -> dict:
    """The three-row table on held-out ``items`` (dataset dicts), the
    repeatability of SuperPoint (and SIFT), the assignment quality and the
    gate: the JSON line's fields but the run's own. ``sift=False`` leaves
    the SIFT row and SIFT's repeatability out (they need cv2)."""
    k, hw = args.topk, args.hw
    feats = extract_pairs(sp, items)
    nn_m0 = [nn_matches0(e0["descriptors"], e1["descriptors"], e0["valid"],
                         e1["valid"], 0.95, device) for e0, e1 in feats]
    sg_m0 = sg_matches0(sg, feats, args, device)

    def learned(m0s):
        def run_pair(pi, it_):
            e0, e1 = feats[pi]
            return (e0["keypoints"], e1["keypoints"],
                    index_pairs(m0s[pi], (m0s[pi] > -1) & e0["valid"]))
        return run_pair

    rows = {}
    if sift:
        rows["sift_nn"] = auc_row(pose_errors(
            items, lambda pi, it_: sift_nn(it_["image1"], it_["image2"], k,
                                           0.95, device), device))
    rows["sp_nn"] = auc_row(pose_errors(items, learned(nn_m0), device))
    rows["sp_sg"] = auc_row(pose_errors(items, learned(sg_m0), device))
    rep = {"superpoint": repeatability(
        items, lambda pi, it_: (feats[pi][0]["keypoints"],
                                feats[pi][0]["valid"],
                                feats[pi][1]["keypoints"],
                                feats[pi][1]["valid"]), hw)}
    if sift:
        def sift_kp(pi, it_):
            xy0, _, v0 = sift_keypoints(gray_u8(it_["image1"]), k)[:3]
            xy1, _, v1 = sift_keypoints(gray_u8(it_["image2"]), k)[:3]
            return xy0, v0, xy1, v1
        rep["sift"] = repeatability(items, sift_kp, hw)
    log(f"repeatability@3px: {rep}")
    rows["sp_nn"].update(assign_pr(items, feats, lambda pi: nn_m0[pi]))
    rows["sp_sg"].update(assign_pr(items, feats, lambda pi: sg_m0[pi]))
    gate = (rows["sp_sg"]["precision"] >= rows["sp_nn"]["precision"]
            and rows["sp_sg"]["auc@5"] >= rows["sp_nn"]["auc@5"])
    return {**rows, "repeatability@3px": rep, "sg_beats_nn_gate": bool(gate)}


# -------------------------------------------------------------- main --

def scene_datasets(base: str, args):
    """(train, val) scene datasets (seeds 1 and 99, scale 1-2, half of
    the pairs pure translations), as JAX's script writes them."""
    from ..data.megadepth import MegaDepthPairsDataset
    from ..data.synthetic import generate_scene

    out = []
    for name, n, seed in (("train", args.train_pairs, 1),
                          ("val", args.val_pairs, 99)):
        txt = generate_scene(os.path.join(base, name), n_pairs=n,
                             image_hw=args.hw, seed=seed,
                             scale_range=(1.0, 2.0), p_translate=0.5)
        out.append(MegaDepthPairsDataset(os.path.join(base, name), txt,
                                         image_size=(args.hw, args.hw),
                                         train=False))
    return tuple(out)


def run(args, argv: list[str], base: str | None = None) -> dict:
    """The whole program; ``base`` holds the scenes (a fresh temporary
    directory when None). Returns the JSON line."""
    t0 = time.time()
    device = torch.device(args.device)
    rng = np.random.default_rng(0)
    if args.ckpt_dir:
        os.makedirs(args.ckpt_dir, exist_ok=True)
    state_path = lambda n: (os.path.join(args.ckpt_dir, n)
                            if args.ckpt_dir else None)
    segments = Segments(args.max_steps_per_segment, argv, MODULE)

    net = build_superpoint_net(device=device, descriptor_dim=args.desc_dim)
    if not load_final(state_path("superpoint"), net) and args.sp_steps > 0:
        if args.device_data:
            pair_batch = device_pair_batch(args.sp_hw, args.sp_batch, device)
        else:
            log(f"texture pool ({args.tex_pool})...")
            pair_batch = host_pair_batch(
                texture_pool(rng, args.tex_pool, args.sp_hw), args.sp_hw)
        opt, sched = adam(net, SP_LR, args.sp_steps)
        path = state_path("superpoint_state")
        start = restore(path, net, opt, sched)
        if start:
            rng = np.random.default_rng(1000 + start)
        train_superpoint(net, opt, sched, args, rng, pair_batch, start,
                         segments=segments, save=saver(path, net, opt, sched),
                         t0=t0)
        save_final(state_path("superpoint"), net)
    sp = extractor(net, args)

    log("generating scene pairs for SG training/eval...")
    base = base or tempfile.mkdtemp(prefix="oetr_matchdemo_")
    train_ds, val_ds = scene_datasets(base, args)
    sg = build_sg(args, device)
    if not load_final(state_path("superglue"), sg) and args.sg_steps > 0:
        sg.train()
        if args.device_data:
            opt, sched = adam(sg, args.sg_lr, args.sg_steps)
            path = state_path("superglue_state")
            start = restore(path, sg, opt, sched)
            train_superglue(sg, opt, sched,
                            device_sg_batches(sp, args, device, start),
                            args.sg_steps, start, 200, segments,
                            saver(path, sg, opt, sched), t0)
        else:
            feats = sg_host_features(sp, train_ds)
            n_gt = np.mean([int((f[2] >= 0).sum()) for f in feats])
            log(f"SG training data ready: {len(feats)} pairs, {n_gt:.0f} GT "
                f"matches/pair ({time.time() - t0:.0f}s)")
            opt, sched = adam(sg, SG_HOST_LR, args.sg_steps)
            train_superglue(sg, opt, sched,
                            sg_host_batches(feats, rng, args.sg_batch,
                                            args.hw, device),
                            args.sg_steps, t0=t0)
        save_final(state_path("superglue"), sg)
    sg.eval()

    items = [val_ds[i] for i in range(len(val_ds))]
    fields = evaluate(sp, sg, items, args, device)
    return {"metric": "learned_matching_pose_auc",
            "sp_steps": args.sp_steps, "sg_steps": args.sg_steps,
            "hw": args.hw, "topk": args.topk, "val_pairs": args.val_pairs,
            **{k: fields[k] for k in ("sift_nn", "sp_nn", "sp_sg")},
            "repeatability@3px": fields["repeatability@3px"],
            "sg_beats_nn_gate": fields["sg_beats_nn_gate"],
            "wall_s": round(time.time() - t0, 1)}


def main(argv=None):
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    require_cv2("train_matching_demo (the scene writer, the dataset reads, "
                "the SIFT rows and the host SuperPoint pairs)")
    print(json.dumps(run(args, argv)))


if __name__ == "__main__":
    main()
