"""End-to-end SfM demo on the port: images -> matches -> tracks -> BA -> ATE
(port of ``scripts/sfm_demo.py``, with the same flags and JSON line).

    python -m oetr_tpu_torch.sfm.demo [--n_views 12 --hw 320 --seed 3 ...]

  1. ``render_rig``: N views of one textured 3-D plane set along a camera
     arc, ray-cast on the host (``data/synthetic.py``);
  2. candidate matches per view pair within ``--max_span``: SIFT + NN on
     the host (``--matcher sift_nn``, needs cv2; the NN on the card), or
     SuperPoint + SuperGlue / LoFTR modules the caller passes
     (``candidates_sp_sg``, ``candidates_loftr``); or, where neither cv2
     nor trained weights exist, the rendered depths' own correspondences
     (``depth_candidates``);
  3. ``two_view``: ``estimate_pose`` per edge (5-point stage on, 1 px):
     inlier filtering and the relative-pose chain, on the card;
  4. ``chain_init``: incremental poses from the matches alone, each edge's
     baseline scale from shared-track depths;
  5. ``reconstruct_rows``: tracks -> DLT triangulation -> BA from the chain
     (2 rounds) and from a drifting odometry-style start (3 rounds), with
     the ATE of each before and after;
  6. ``export``: a COLMAP model and database.

The chain row starts camera 0 at the identity, so in float32 its BA never
moves (``sfm/ba.py``: JAX's NaN Jacobian at zero rotation); the odometry
row is the one that shows BA at work, and its gate is the demo's.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..data.synthetic import _render_planes, _rot, _texture
from ..evalx.trajectory import absolute_trajectory_error
from ..geometry.ransac import estimate_pose
from .ba import triangulate_points
from .reconstruct import export_colmap, export_database, reconstruct

MIN_CANDIDATES = 16
MIN_INLIERS = 12
# depth_candidates: grid step (px), keypoint noise (px), share of
# outliers, relative depth agreement for "not occluded".
GRID_STEP = 8
NOISE_PX = 0.5
OUTLIER_SHARE = 0.2
DEPTH_TOL = 0.01


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def _log_so3(R: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(cos)
    if th < 1e-8:
        return np.zeros(3)
    return th / (2 * np.sin(th)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])


def render_rig(n_views: int, hw: int, seed: int, arc_deg: float = 30.0,
               depth_bg: float = 12.0, noise: float = 0.0):
    """N cameras on a lateral arc looking at a shared 3-D plane set.

    Returns (images [N, hw, hw, 3] uint8, K [3, 3], gt_cams6 [N, 6]
    world->cam (so3 log, t), depths list of [hw, hw]).
    """
    rng = np.random.default_rng(seed)
    f = 0.9 * hw
    K = np.array([[f, 0, hw / 2], [0, f, hw / 2], [0, 0, 1.0]])

    # Shared scene: background plane + floating foreground planes
    # (parallax and occlusion). The plane covers every camera's footprint,
    # the yawed arc-end views' too, and its texture is tiled from
    # independent patches so that every footprint has corners.
    half_bg = ((depth_bg / f) * hw * 1.2
               + 2.0 * depth_bg * np.sin(np.deg2rad(arc_deg / 2)))
    ppw_bg = min(f / depth_bg, 3072 / (2 * half_bg))
    tw = int(2 * half_bg * ppw_bg)
    bg_tex = np.zeros((tw, tw, 3), np.uint8)
    ps = 160
    for y in range(0, tw, ps):
        for x in range(0, tw, ps):
            bg_tex[y:y + ps, x:x + ps] = _texture(
                rng, min(ps, tw - y), min(ps, tw - x))
    planes = [{
        "z": depth_bg, "x0": -half_bg, "y0": -half_bg,
        "x1": half_bg, "y1": half_bg, "tex": bg_tex, "ppw": ppw_bg,
    }]
    for _ in range(3):
        zf = float(rng.uniform(0.5, 0.8)) * depth_bg
        half = float(rng.uniform(0.10, 0.2)) * (zf / f) * hw
        cx = float(rng.uniform(-0.25, 0.25)) * (zf / f) * hw
        cy = float(rng.uniform(-0.25, 0.25)) * (zf / f) * hw
        ppw = min(f / zf, 512 / (2 * half))
        tws = max(int(np.ceil(2 * half * ppw)), 16)
        planes.append({"z": zf, "x0": cx - half, "y0": cy - half,
                       "x1": cx + half, "y1": cy + half,
                       "tex": _texture(rng, tws, tws), "ppw": ppw})
    planes.sort(key=lambda p: -p["z"])

    # Arc: cameras orbit laterally around the scene center at depth_bg,
    # yawing to keep it centered.
    images, cams6, depths = [], [], []
    angs = np.deg2rad(np.linspace(-arc_deg / 2, arc_deg / 2, n_views))
    radius = depth_bg
    for a in angs:
        c = np.array([radius * np.sin(a), 0.1 * radius * np.sin(2 * a),
                      radius - radius * np.cos(a)])
        R = _rot(0.0, -a, 0.0)
        img, d = _render_planes(planes, K, R, c, hw)
        if noise > 0:
            img = np.clip(img.astype(np.float32)
                          + rng.normal(0, noise, img.shape), 0,
                          255).astype(np.uint8)
        images.append(img)
        depths.append(d)
        cams6.append(np.concatenate([_log_so3(R), -R @ c]))
    return (np.stack(images), K, np.stack(cams6).astype(np.float64),
            depths)


def edges_within(n: int, max_span: int) -> list[tuple[int, int]]:
    return [(i, j) for i in range(n) for j in range(i + 1, n)
            if j - i <= max_span]


# ------------------------------------------------------ candidate matches
def candidates_sift_nn(images: np.ndarray, edges, topk: int, device):
    """SIFT keypoints and RootSIFT descriptors on the host (cv2), then the
    port's NN matcher (ratio 0.95, mutual) per edge on ``device``.
    Returns (keypoints per view, {edge: (ia, ib, p0, p1)})."""
    import cv2

    from ..models.matchers import nearest_neighbor_match
    from ..models.sift_based import sift_keypoints

    kps, descs, valids = [], [], []
    for im in images:
        g = cv2.cvtColor(im, cv2.COLOR_RGB2GRAY)
        xy, _, v, d = sift_keypoints(g, topk, with_descriptors=True)
        kps.append(xy)
        descs.append(torch.as_tensor(d, device=device))
        valids.append(v)
    vt = [torch.as_tensor(v, device=device) for v in valids]
    cands = {}
    for i, j in edges:
        m = nearest_neighbor_match(descs[i][None], descs[j][None],
                                   vt[i][None], vt[j][None],
                                   ratio_threshold=0.95)
        m0 = m["matches0"][0].cpu().numpy()
        sel = (m0 > -1) & valids[i]
        ia, ib = np.nonzero(sel)[0], m0[sel]
        cands[(i, j)] = (ia, ib, kps[i][ia], kps[j][ib])
    return kps, cands


def _gray(images: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(images, dtype=torch.float32,
                           device=device).mean(-1, keepdim=True) / 255


def candidates_sp_sg(images: np.ndarray, edges, superpoint, superglue):
    """SuperPoint on every view and SuperGlue per edge, the caller's
    modules (their device). Returns as ``candidates_sift_nn``."""
    device = next(superpoint.parameters()).device
    hw = tuple(images.shape[1:3])
    with torch.no_grad():
        e = superpoint(_gray(images, device))
        kps = [e["keypoints"][i].cpu().numpy() for i in range(len(images))]
        valids = e["valid"].cpu().numpy()
        cands = {}
        for i, j in edges:
            m = superglue({
                "keypoints0": e["keypoints"][i:i + 1],
                "keypoints1": e["keypoints"][j:j + 1],
                "scores0": e["scores"][i:i + 1],
                "scores1": e["scores"][j:j + 1],
                "descriptors0": e["descriptors"][i:i + 1],
                "descriptors1": e["descriptors"][j:j + 1],
                "valid0": e["valid"][i:i + 1], "valid1": e["valid"][j:j + 1],
                "image_hw0": hw, "image_hw1": hw})
            m0 = m["matches0"][0].cpu().numpy()
            sel = (m0 > -1) & valids[i]
            ia, ib = np.nonzero(sel)[0], m0[sel]
            cands[(i, j)] = (ia, ib, kps[i][ia], kps[j][ib])
    return kps, cands


def candidates_loftr(images: np.ndarray, edges, loftr):
    """The caller's LoFTR module per edge. Track nodes are coarse grid
    cells: query-side matches are cell centres; target-side positions are
    quantized to the nearest cell for linking tracks across edges (one
    observation per target cell, the most confident), while the two-view
    step uses the continuous fine positions."""
    device = next(loftr.parameters()).device
    hc = images.shape[1] // 8
    gray = _gray(images, device)
    u = np.arange(hc, dtype=np.float32) * 8 + 3.5
    gy, gx = np.meshgrid(u, u, indexing="ij")
    grid_xy = np.stack([gx.reshape(-1), gy.reshape(-1)],
                       -1).astype(np.float32)
    kps = [grid_xy for _ in range(len(images))]
    cands = {}
    with torch.no_grad():
        for i, j in edges:
            out = loftr(gray[i:i + 1], gray[j:j + 1])
            v = out["valid"][0].cpu().numpy()
            ia = out["cells0"][0].cpu().numpy()[v]
            xy1 = out["mkpts1"][0].cpu().numpy()[v]
            conf = out["conf"][0].cpu().numpy()[v]
            cb = np.clip(np.round((xy1 - 3.5) / 8.0), 0,
                         hc - 1).astype(np.int64)
            ib = cb[:, 1] * hc + cb[:, 0]
            keep, seen = [], set()
            for idx in np.argsort(-conf):
                if int(ib[idx]) not in seen:
                    seen.add(int(ib[idx]))
                    keep.append(idx)
            keep = np.asarray(sorted(keep), np.int64)
            ia, ib, xy1 = ia[keep], ib[keep], xy1[keep]
            cands[(i, j)] = (ia, ib, kps[i][ia], xy1.astype(np.float32))
    return kps, cands


def depth_candidates(depths, K: np.ndarray, cams6: np.ndarray, edges,
                     seed: int):
    """Correspondences from the rendered depths, for where neither cv2 nor
    trained matcher weights exist: each view's keypoints start as a grid
    (every ``GRID_STEP`` px); for each edge both views' grid points with
    depth are lifted to the world and projected into the partner, kept
    where they land inside it in front of the camera and the partner's
    depth at the nearest pixel agrees within ``DEPTH_TOL`` (relative: not
    occluded), and appended there as keypoints with ``NOISE_PX`` Gaussian
    noise. Then ``OUTLIER_SHARE`` of each edge's matches are re-pointed at
    random keypoints of the partner. Returns as ``candidates_sift_nn``."""
    from ..evalx.trajectory import so3_exp_np

    rng = np.random.default_rng(seed)
    hw = depths[0].shape[0]
    Kinv = np.linalg.inv(K)
    u = np.arange(GRID_STEP // 2, hw, GRID_STEP, dtype=np.float64)
    gx, gy = np.meshgrid(u, u)
    grid = np.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    Rs = [so3_exp_np(c[:3]) for c in cams6]
    kps = [[g] for g in [grid] * len(depths)]
    sizes = [len(grid)] * len(depths)

    def project(src, dst):
        z = depths[src][grid[:, 1].astype(int), grid[:, 0].astype(int)]
        rays = np.concatenate([grid, np.ones((len(grid), 1))], 1) @ Kinv.T
        Xc = rays * z[:, None]
        Xw = (Xc - cams6[src][3:]) @ Rs[src]            # R^T (x - t)
        Xd = Xw @ Rs[dst].T + cams6[dst][3:]
        zd = Xd[:, 2]
        uv = (Xd / np.where(zd > 1e-9, zd, 1e-9)[:, None]) @ K.T
        uv = uv[:, :2]
        px = np.clip(np.rint(uv), 0, hw - 1).astype(int)
        inside = ((z > 0) & (zd > 1e-6) & (uv >= -0.5).all(1)
                  & (uv <= hw - 0.5).all(1))
        dd = depths[dst][px[:, 1], px[:, 0]]
        keep = inside & (np.abs(dd - zd) <= DEPTH_TOL * zd)
        idx = np.nonzero(keep)[0]
        return idx, uv[idx] + rng.normal(0, NOISE_PX, (len(idx), 2))

    cands = {}
    for i, j in edges:
        ia_list, ib_list = [], []
        for src, dst in ((i, j), (j, i)):
            idx, uv = project(src, dst)
            new = sizes[dst] + np.arange(len(idx))
            kps[dst].append(uv)
            sizes[dst] += len(idx)
            pair = (idx, new) if src == i else (new, idx)
            ia_list.append(pair[0])
            ib_list.append(pair[1])
        ia, ib = np.concatenate(ia_list), np.concatenate(ib_list)
        bad = rng.random(len(ia)) < OUTLIER_SHARE
        ib = np.where(bad, rng.integers(0, len(grid), len(ia)), ib)
        cands[(i, j)] = (ia, ib)
    kps = [np.concatenate(k).astype(np.float32) for k in kps]
    return kps, {e: (ia, ib, kps[e[0]][ia], kps[e[1]][ib])
                 for e, (ia, ib) in cands.items()}


# -------------------------------------------------------- geometry steps
def two_view(cands: dict, K: np.ndarray, device):
    """``estimate_pose`` per edge (5-point stage on, 1 px, its generator
    seeded 100 + 31 i + j) on ``device``: edges with fewer than
    MIN_CANDIDATES candidates, not ok, or under MIN_INLIERS inliers are
    dropped. Returns (matches {edge: [2, M] inlier index pairs}, rel
    {edge: (R, t_unit) cam_i -> cam_j, float64})."""
    to = lambda a: torch.as_tensor(a, device=device)
    Kt = torch.as_tensor(K, dtype=torch.float32, device=device)
    matches, rel = {}, {}
    for (i, j), (ia, ib, p0, p1) in cands.items():
        if len(ia) < MIN_CANDIDATES:
            continue
        pad = max(64, 1 << int(np.ceil(np.log2(len(p0)))))
        P0 = np.zeros((pad, 2), np.float32)
        P1 = np.zeros((pad, 2), np.float32)
        P0[:len(p0)] = p0
        P1[:len(p1)] = p1
        vm = np.zeros(pad, bool)
        vm[:len(p0)] = True
        res = estimate_pose(
            to(P0), to(P1), to(vm), Kt, Kt,
            torch.Generator(device=device).manual_seed(100 + 31 * i + j),
            thresh_px=1.0, use_5pt=True)
        if not bool(res["ok"]):
            continue
        inl = res["inliers"].cpu().numpy()[:len(p0)]
        if inl.sum() < MIN_INLIERS:
            continue
        matches[(i, j)] = np.stack([ia[inl], ib[inl]])
        rel[(i, j)] = (res["R"].cpu().numpy().astype(np.float64),
                       res["t"].cpu().numpy().astype(np.float64))
        log(f"edge ({i},{j}): {int(inl.sum())} inliers / {len(p0)}")
    return matches, rel


def chain_init(kps, matches: dict, rel: dict, K: np.ndarray, n: int,
               device) -> np.ndarray:
    """Incremental poses [n, 6] from the matches alone. Gauge: camera 0 at
    the identity, edge (0, 1)'s baseline 1. Each later edge's scale is the
    median ratio, over keypoints of camera i seen by both, of the depth in
    the frame built so far to the depth from the edge's unit-baseline
    triangulation. Raises ValueError when a chain edge (i, i + 1) is
    missing."""
    for i in range(n - 1):
        if (i, i + 1) not in rel:
            raise ValueError(f"chain edge ({i},{i + 1}) failed — scene too "
                             "hard")

    def two_view_depths(i, j, R, t):
        """Triangulated cam-i depths for each inlier match of (i, j)."""
        ia, ib = matches[(i, j)]
        p0, p1 = kps[i][ia], kps[j][ib]
        m = len(p0)
        c1 = np.concatenate([_log_so3(R), t])
        cams = np.stack([np.zeros((m, 6)), np.tile(c1, (m, 1))], 1)
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                        device=device)
        pts = triangulate_points(
            f32(cams), f32(np.tile(K[None, None], (m, 2, 1, 1))),
            f32(np.stack([p0, p1], axis=1)),
            torch.ones((m, 2), dtype=torch.bool, device=device))
        return ia, ib, pts[:, 2].cpu().numpy()

    Kinv = np.linalg.inv(K)

    def forward_depths(i, ia, ib, depths_i, Rr, tr_scaled, into):
        """Record cam-(i+1) depths by lifting cam-i keypoints through the
        (scaled) edge transform."""
        for a, b, d in zip(ia.tolist(), ib.tolist(), depths_i.tolist()):
            if d <= 1e-6:
                continue
            x = Kinv @ np.array([kps[i][a][0], kps[i][a][1], 1.0])
            pc = Rr @ (x * d) + tr_scaled
            if pc[2] > 1e-6:
                into[b] = float(pc[2])

    Rw, tw = [np.eye(3)], [np.zeros(3)]
    kp_depth = [dict() for _ in range(n)]   # per view: kp idx -> cam depth
    R01, t01 = rel[(0, 1)]
    ia, ib, d0 = two_view_depths(0, 1, R01, t01)
    kp_depth[0].update({a: float(d) for a, d in zip(ia.tolist(),
                                                    d0.tolist()) if d > 1e-6})
    forward_depths(0, ia, ib, d0, R01, t01, kp_depth[1])
    Rw.append(R01.copy())
    tw.append(t01.copy())
    for i in range(1, n - 1):
        Rr, tr = rel[(i, i + 1)]
        ia, ib, d_local = two_view_depths(i, i + 1, Rr, tr)
        num, den = [], []
        for idx, dl in zip(ia.tolist(), d_local.tolist()):
            if idx in kp_depth[i] and dl > 1e-6:
                num.append(kp_depth[i][idx])
                den.append(dl)
        if len(num) < 5:
            scale = 1.0
            log(f"edge ({i},{i + 1}): <5 shared tracks, scale=1 (weak)")
        else:
            scale = float(np.median(np.asarray(num) / np.asarray(den)))
        Rw.append(Rr @ Rw[i])
        tw.append(Rr @ tw[i] + scale * tr)
        d_fwd = np.array([kp_depth[i].get(a, dl * scale)
                          for a, dl in zip(ia.tolist(), d_local.tolist())])
        forward_depths(i, ia, ib, d_fwd, Rr, scale * tr, kp_depth[i + 1])
    return np.stack([np.concatenate([_log_so3(R), t])
                     for R, t in zip(Rw, tw)])


def odometry_init(gt_cams6: np.ndarray, seed: int) -> np.ndarray:
    """A drifting odometry-style start: the truth with 0.02 rad and 0.15
    units of Gaussian noise (camera 0 exact)."""
    n = len(gt_cams6)
    rng = np.random.default_rng(seed + 1)
    odo = gt_cams6 + np.concatenate(
        [rng.normal(0, 0.02, (n, 3)), rng.normal(0, 0.15, (n, 3))], axis=1)
    odo[0] = gt_cams6[0]
    return odo


def reconstruct_rows(kps, matches: dict, K: np.ndarray, gt_cams6, init_cams6,
                     odo_cams6, max_span: int, ba_iters: int, device):
    """The demo's two rows: ``reconstruct`` from the chain (2 rounds) and
    from the odometry start (3 rounds). Returns (chain recon, odometry
    recon, the ATE of each start and result against the truth)."""
    n = len(gt_cams6)
    Kt = np.tile(K[None], (n, 1, 1))
    kw = dict(min_track_len=2, max_views=max_span + 1, ba_iters=ba_iters,
              device=device)
    recon = reconstruct(kps, matches, Kt, init_cams6.astype(np.float32),
                        rounds=2, **kw)
    rec2 = reconstruct(kps, matches, Kt, odo_cams6.astype(np.float32),
                       rounds=3, **kw)
    ate = {name: absolute_trajectory_error(c, gt_cams6) for name, c in (
        ("init", init_cams6), ("ba", recon["cams"]), ("odometry_init",
                                                       odo_cams6),
        ("odometry_ba", rec2["cams"]))}
    return recon, rec2, ate


def export(exp_dir: str, kps, matches: dict, K: np.ndarray,
           recon: dict) -> bool:
    """COLMAP model (``export_colmap``) and database (``export_database``)
    of the chain row under ``exp_dir``; True when all four files exist."""
    n = len(kps)
    names = [f"view_{i:02d}.jpg" for i in range(n)]
    Kt = np.tile(K[None], (n, 1, 1))
    export_colmap(exp_dir, names, Kt, recon)
    export_database(os.path.join(exp_dir, "database.db"), names, Kt, kps,
                    matches)
    return all(os.path.exists(os.path.join(exp_dir, f))
               for f in ("cameras.bin", "images.bin", "points3D.bin",
                         "database.db"))


def summary(recon: dict, ate: dict) -> dict:
    """The demo's JSON fields of the two rows (``ba_beats_init``: the
    odometry row's ATE below half its start's, the chain row's within 5%
    of its start's)."""
    return {
        "tracks": int(recon["tracks"].num_tracks),
        "tracks_valid": int(recon["point_valid"].sum()),
        "ate_rmse_init": round(ate["init"]["ate_rmse"], 4),
        "ate_rmse_ba": round(ate["ba"]["ate_rmse"], 4),
        "rot_err_mean_deg_init": round(ate["init"]["rot_err_mean_deg"], 4),
        "rot_err_mean_deg_ba": round(ate["ba"]["rot_err_mean_deg"], 4),
        "ate_rmse_odometry_init": round(ate["odometry_init"]["ate_rmse"], 4),
        "ate_rmse_odometry_ba": round(ate["odometry_ba"]["ate_rmse"], 4),
        "rot_err_mean_deg_odometry_init":
            round(ate["odometry_init"]["rot_err_mean_deg"], 4),
        "rot_err_mean_deg_odometry_ba":
            round(ate["odometry_ba"]["rot_err_mean_deg"], 4),
        "ba_beats_init": bool(
            ate["odometry_ba"]["ate_rmse"]
            < 0.5 * ate["odometry_init"]["ate_rmse"]
            and ate["ba"]["ate_rmse"] <= ate["init"]["ate_rmse"] * 1.05),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_views", type=int, default=12)
    ap.add_argument("--hw", type=int, default=320)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--topk", type=int, default=1024)
    ap.add_argument("--max_span", type=int, default=3,
                    help="match view pairs (i, j) with j - i <= span")
    ap.add_argument("--matcher", choices=("sift_nn", "sp_sg", "loftr"),
                    default="sift_nn")
    ap.add_argument("--ckpt_dir", default=".ckpt_matching_r5",
                    help="SP/SG checkpoint dir for --matcher sp_sg")
    ap.add_argument("--ba_iters", type=int, default=20)
    ap.add_argument("--arc_deg", type=float, default=45.0)
    ap.add_argument("--noise", type=float, default=6.0,
                    help="gaussian pixel noise std (0-255 units) — "
                         "degrades keypoint localization so the chained "
                         "init drifts and BA has honest work to do")
    ap.add_argument("--export", default="",
                    help="dir for COLMAP model + database export")
    ap.add_argument("--device", default="cuda",
                    help="where matching, pose and BA run")
    args = ap.parse_args(argv)
    if args.matcher != "sift_nn":
        raise SystemExit(
            f"--matcher {args.matcher} needs trained weights on the port, "
            "and the trained checkpoints cannot reach the card's machine yet "
            "(ROADMAP.md queue 1, item 2); candidates_sp_sg and "
            "candidates_loftr take modules with the caller's parameters")

    t0 = time.time()
    log(f"rendering {args.n_views}-view rig ({args.hw}^2)...")
    images, K, gt_cams6, _ = render_rig(args.n_views, args.hw, args.seed,
                                        arc_deg=args.arc_deg,
                                        noise=args.noise)
    n = args.n_views
    edges = edges_within(n, args.max_span)
    kps, cands = candidates_sift_nn(images, edges, args.topk, args.device)
    matches, rel = two_view(cands, K, args.device)
    try:
        init_cams6 = chain_init(kps, matches, rel, K, n, args.device)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    recon, rec2, ate = reconstruct_rows(
        kps, matches, K, gt_cams6, init_cams6,
        odometry_init(gt_cams6, args.seed), args.max_span, args.ba_iters,
        args.device)
    log(f"{recon['tracks'].num_tracks} tracks "
        f"({int(recon['point_valid'].sum())} valid after BA), cost "
        f"{recon['cost_history'][0]:.1f} -> {recon['cost_history'][-1]:.1f}")
    log(f"odometry row: cost {rec2['cost_history'][0]:.1f} -> "
        f"{rec2['cost_history'][-1]:.1f}, ATE "
        f"{ate['odometry_init']['ate_rmse']:.4f} -> "
        f"{ate['odometry_ba']['ate_rmse']:.4f}")
    exp_dir = args.export or tempfile.mkdtemp(prefix="oetr_sfm_")
    ok_export = export(exp_dir, kps, matches, K, recon)
    print(json.dumps({
        "metric": "sfm_ate", "n_views": n, "hw": args.hw,
        "matcher": args.matcher, "edges_matched": len(matches),
        **summary(recon, ate),
        "colmap_export_ok": bool(ok_export), "export_dir": exp_dir,
        "wall_s": round(time.time() - t0, 1)}))


if __name__ == "__main__":
    main()
