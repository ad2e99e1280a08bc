"""End-to-end SfM: matches -> tracks -> triangulation -> BA -> COLMAP model
(port of ``oetr_tpu/sfm/reconstruct.py``).

    pair matches --build_tracks--> tracks --triangulate_points-->
    initial points --bundle_adjust (LM + implicit-Schur CG)-->
    refined cameras/points --export_colmap--> cameras/images/points3D

Track building and export are host graph work, numpy as in JAX; the
geometry (triangulation on the eigh kernel, BA) runs on the card unless
the caller passes ``device="cpu"``. Between BA rounds the validity gates
read the residuals back to the host, as JAX's do.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .ba import bundle_adjust, residuals, triangulate_points


# ------------------------------------------------------------------ tracks
class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n)

    def find(self, a: int) -> int:
        p = self.parent
        while p[a] != a:
            p[a] = p[p[a]]
            a = p[a]
        return a

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


@dataclass
class Tracks:
    """Feature tracks in flat observation form (static-shape friendly).

    obs_cam/obs_pt: [O] int32 — observation o is track obs_pt[o] seen by
    image obs_cam[o]; obs_kp: [O] index into that image's keypoints;
    obs_uv: [O, 2] pixel coords; num_tracks: P.
    """
    obs_cam: np.ndarray
    obs_pt: np.ndarray
    obs_kp: np.ndarray
    obs_uv: np.ndarray
    num_tracks: int


def build_tracks(keypoints: list[np.ndarray],
                 matches: dict[tuple[int, int], np.ndarray],
                 min_track_len: int = 2) -> Tracks:
    """Union-find over matched keypoints -> consistent tracks.

    Args:
      keypoints: per-image [N_i, 2] arrays.
      matches: {(i, j): [2, M]} keypoint-index pairs (i < j convention,
        same layout the runner writes to matches.h5).
      min_track_len: drop tracks observed by fewer images.

    Tracks where one image observes two different keypoints (merge
    conflicts) are dropped, matching COLMAP's track-builder policy. Track
    ids follow the order in which each track's root is first met, image
    by image and keypoint by keypoint, as in JAX.
    """
    offsets = np.cumsum([0] + [len(k) for k in keypoints])
    uf = _UnionFind(offsets[-1])
    for (i, j), m in matches.items():
        for a, b in np.asarray(m).T:
            uf.union(offsets[i] + int(a), offsets[j] + int(b))

    roots: dict[int, list[tuple[int, int]]] = {}
    for img in range(len(keypoints)):
        for k in range(len(keypoints[img])):
            r = uf.find(offsets[img] + k)
            roots.setdefault(r, []).append((img, k))

    obs_cam, obs_pt, obs_kp, obs_uv = [], [], [], []
    pid = 0
    for members in roots.values():
        imgs = [im for im, _ in members]
        if len(members) < min_track_len or len(set(imgs)) != len(imgs):
            continue
        for im, k in members:
            obs_cam.append(im)
            obs_pt.append(pid)
            obs_kp.append(k)
            obs_uv.append(keypoints[im][k])
        pid += 1
    if pid == 0:
        return Tracks(np.zeros(0, np.int32), np.zeros(0, np.int32),
                      np.zeros(0, np.int32), np.zeros((0, 2), np.float32), 0)
    return Tracks(np.asarray(obs_cam, np.int32), np.asarray(obs_pt, np.int32),
                  np.asarray(obs_kp, np.int32),
                  np.asarray(obs_uv, np.float32), pid)


# --------------------------------------------------------------- reconstruct
def _tracks_to_view_arrays(tracks: Tracks, max_views: int):
    """[P, V] padded per-track view tables for batched triangulation."""
    P = tracks.num_tracks
    cam_tbl = np.zeros((P, max_views), np.int32)
    uv_tbl = np.zeros((P, max_views, 2), np.float32)
    valid_tbl = np.zeros((P, max_views), bool)
    fill = np.zeros(P, np.int32)
    for o in range(len(tracks.obs_cam)):
        p = tracks.obs_pt[o]
        f = fill[p]
        if f < max_views:
            cam_tbl[p, f] = tracks.obs_cam[o]
            uv_tbl[p, f] = tracks.obs_uv[o]
            valid_tbl[p, f] = True
            fill[p] = f + 1
    return cam_tbl, uv_tbl, valid_tbl


def reconstruct(keypoints: list[np.ndarray],
                matches: dict[tuple[int, int], np.ndarray],
                K: np.ndarray, cams_init: np.ndarray,
                min_track_len: int = 2, max_views: int = 8,
                ba_iters: int = 15, cg_iters: int = 40,
                huber_delta: float = 4.0,
                max_reproj_px: float = 8.0,
                rounds: int = 1,
                device: str | torch.device | None = None) -> dict:
    """Triangulate tracks and bundle-adjust cameras + points.

    Args:
      keypoints: per-image [N_i, 2]; matches: {(i, j): [2, M]}.
      K: [C, 3, 3] per-image intrinsics.
      cams_init: [C, 6] world->camera (so3 log, t) initial poses (from
        two-view chains, priors, or noisy odometry).
      rounds: BA rounds; between rounds every track is RE-triangulated
        from the refined cameras and the validity gate re-evaluated
        (COLMAP's retriangulation pass) — from a noisy initialization
        the first triangulation mis-places points and a single-round
        gate would discard their observations forever.
      device: where triangulation and BA run (the card by default).

    The cameras and K go in as float32, as in JAX. Returns dict with cams
    [C, 6], pts [P, 3], tracks, point_valid [P], cost_history, as numpy.
    """
    tracks = build_tracks(keypoints, matches, min_track_len)
    if tracks.num_tracks == 0:
        raise ValueError("no tracks survived — not enough matches")
    dev = torch.device("cuda" if device is None else device)

    cam_tbl, uv_tbl, valid_tbl = _tracks_to_view_arrays(tracks, max_views)
    to = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)
    Kt = to(np.asarray(K), torch.float32)
    cam_tbl, uv_t, tbl_t = to(cam_tbl).long(), to(uv_tbl), to(valid_tbl)
    obs_cam, obs_pt = to(tracks.obs_cam).long(), to(tracks.obs_pt).long()
    obs_uv = to(tracks.obs_uv)

    def per_track_max_err(cams, pts):
        r = residuals(cams, pts, Kt, obs_cam, obs_pt, obs_uv,
                      torch.ones(len(tracks.obs_cam), dtype=torch.float32,
                                 device=dev))
        err = np.linalg.norm(r.cpu().numpy(), axis=-1)
        mx = np.zeros(tracks.num_tracks)
        np.maximum.at(mx, tracks.obs_pt, err)
        return mx

    cams = to(np.asarray(cams_init), torch.float32)
    history = []
    for _ in range(max(1, rounds)):
        pts = triangulate_points(cams[cam_tbl], Kt[cam_tbl], uv_t, tbl_t)
        # Pre-BA gate is loose (4x): init poses are noisy, so only gross
        # mis-triangulations (wrong matches, near-degenerate rays) go;
        # the strict filter runs after optimization, as in COLMAP.
        point_valid = per_track_max_err(cams, pts) < 4.0 * max_reproj_px
        obs_valid = to(point_valid[tracks.obs_pt])
        out = bundle_adjust(cams, pts, Kt, obs_cam, obs_pt, obs_uv,
                            obs_valid, iters=ba_iters, cg_iters=cg_iters,
                            huber_delta=huber_delta)
        cams, pts = out["cams"], out["pts"]
        history.append(out["cost_history"].cpu().numpy())

    point_valid &= per_track_max_err(cams, pts) < max_reproj_px

    return {
        "cams": cams.cpu().numpy(),
        "pts": pts.cpu().numpy(),
        "point_valid": point_valid,
        "cost_history": np.concatenate(history),
        "tracks": tracks,
    }


# -------------------------------------------------------------------- export
def export_colmap(path: str, image_names: list[str], K: np.ndarray,
                  recon: dict, ext: str = ".bin") -> None:
    """Write a COLMAP-readable model (cameras/images/points3D).

    Formats per read_write_model.py (PINHOLE camera, qvec/tvec images,
    RGB+error points with track elements); each rotation is the port's
    ``so3_exp`` of the camera's log, on the host in the log's dtype.
    """
    import os

    from ..geometry.ransac import so3_exp
    from .colmap_model import Camera, Image, Point3D, rotmat2qvec, write_model

    os.makedirs(path, exist_ok=True)
    cams, pts, tracks = recon["cams"], recon["pts"], recon["tracks"]
    point_valid = recon["point_valid"]

    cameras, images = {}, {}
    for i, name in enumerate(image_names):
        fx, fy = float(K[i][0, 0]), float(K[i][1, 1])
        cx, cy = float(K[i][0, 2]), float(K[i][1, 2])
        cameras[i + 1] = Camera(id=i + 1, model="PINHOLE",
                                width=int(2 * cx), height=int(2 * cy),
                                params=np.array([fx, fy, cx, cy]))
        R = so3_exp(torch.as_tensor(np.asarray(cams[i][:3]))).numpy()
        images[i + 1] = Image(
            id=i + 1, qvec=rotmat2qvec(R), tvec=cams[i][3:],
            camera_id=i + 1, name=name,
            xys=np.zeros((0, 2)), point3D_ids=np.zeros(0, np.int64))

    points3D = {}
    per_track: dict[int, list[tuple[int, int]]] = {}
    for o in range(len(tracks.obs_cam)):
        per_track.setdefault(int(tracks.obs_pt[o]), []).append(
            (int(tracks.obs_cam[o]) + 1, int(tracks.obs_kp[o])))
    for p, obs in per_track.items():
        if not point_valid[p]:
            continue
        points3D[p + 1] = Point3D(
            id=p + 1, xyz=pts[p], rgb=np.array([128, 128, 128]),
            error=0.0,
            image_ids=np.array([im for im, _ in obs]),
            point2D_idxs=np.array([o for _, o in obs]))

    write_model(cameras, images, points3D, path, ext=ext)


def export_database(db_path: str, image_names: list[str], K: np.ndarray,
                    keypoints: list[np.ndarray],
                    matches: dict[tuple[int, int], np.ndarray],
                    two_view: dict[tuple[int, int], dict] | None = None
                    ) -> None:
    """Write the raw matching products into a COLMAP SQLite database
    (the reference's dloc/core/utils/database.py:138).

    ``two_view`` optionally maps (i, j) -> {'E','F','H','matches'}
    (verified geometry; matches [2, M] inlier index pairs) and fills the
    two_view_geometries table so COLMAP can skip its own verification
    pass.
    """
    from .database import COLMAPDatabase

    db = COLMAPDatabase.connect(db_path)
    try:
        db.create_tables()
        ids = []
        for i, name in enumerate(image_names):
            fx, fy = float(K[i][0, 0]), float(K[i][1, 1])
            cx, cy = float(K[i][0, 2]), float(K[i][1, 2])
            cam_id = db.add_camera(1, int(2 * cx), int(2 * cy),
                                   np.array([fx, fy, cx, cy]))
            ids.append(db.add_image(name, cam_id))
        for i, kp in enumerate(keypoints):
            db.add_keypoints(ids[i], np.asarray(kp, np.float32))
        for (i, j), m in matches.items():
            db.add_matches(ids[i], ids[j], np.asarray(m).T)
        if two_view:
            for (i, j), g in two_view.items():
                db.add_two_view_geometry(
                    ids[i], ids[j], np.asarray(g["matches"]).T,
                    F=np.asarray(g.get("F", np.eye(3))),
                    E=np.asarray(g.get("E", np.eye(3))),
                    H=np.asarray(g.get("H", np.eye(3))))
        db.commit()
    finally:
        db.close()
