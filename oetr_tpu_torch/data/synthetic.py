"""Synthetic MegaDepth-style scene generator on the host (port of
``oetr_tpu/data/synthetic.py``).

``generate_scene`` and ``generate_scene_3d`` write an on-disk tree in the
format ``MegaDepthPairsDataset`` parses (jpg images, h5 depth maps, the
10-field pair lines) from procedural textures and known two-view
geometry; ``_texture``, ``_rot`` and ``_render_planes`` are the renderers
they and the SfM demo draw on.

Nothing here needs cv2 or h5py, so it all runs on the machine with the
CUDA card: JAX's ``_texture`` blurs its noise with ``cv2.GaussianBlur``
and ``_render_planes`` samples its textures with ``cv2.remap``; here
``_gaussian_blur`` and ``_remap_linear`` compute what those calls compute.
The writers encode their JPEGs with the port's codec (``data/jpeg.py``:
``cv2.imwrite``'s bytes), resize with ``resize_linear_u8``
(``cv2.resize``'s INTER_LINEAR on uint8) and write the depth maps with the
port's HDF5 writer (``utils/hdf5.py``).
"""
from __future__ import annotations

import os

import numpy as np

from ..utils import hdf5
from .jpeg import imwrite_jpeg, resize_linear_u8


def _texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Feature-rich procedural texture in [0, 255] uint8 RGB.

    Mixes low-frequency color waves, Gaussian blobs, and — crucially for
    classical detectors (SIFT needs gradient corners, not smooth blobs) —
    sharp-edged random rectangles plus band-limited noise.
    """
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for _ in range(6):                       # low-frequency color waves
        fx, fy = rng.uniform(0.01, 0.08, 2)
        ph = rng.uniform(0, 2 * np.pi)
        c = rng.uniform(0, 1, 3)
        img += np.sin(fx * xx + fy * yy + ph)[..., None] * c[None, None]
    for _ in range(25):                      # smooth blobs
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        s = rng.uniform(2, 12)
        c = rng.uniform(-1, 1, 3)
        img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s)
                      )[..., None] * c[None, None]
    img -= img.min()
    img /= max(img.max(), 1e-6)
    for _ in range(80):                      # sharp rectangles -> corners
        cy = int(rng.integers(0, h - 4))
        cx = int(rng.integers(0, w - 4))
        rh = int(rng.integers(3, 18))
        rw = int(rng.integers(3, 18))
        c = rng.uniform(0, 1, 3)
        a = rng.uniform(0.4, 0.9)
        img[cy:cy + rh, cx:cx + rw] = (
            (1 - a) * img[cy:cy + rh, cx:cx + rw] + a * c[None, None])
    noise = rng.normal(0, 1, (h, w, 1)).astype(np.float32)
    noise = _gaussian_blur(noise[..., 0], 1.2)[..., None]
    img = np.clip(img + 0.08 * noise, 0, 1)
    return (img * 255).astype(np.uint8)


def _gaussian_blur(x: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(x, (0, 0), sigma)`` of a float32 image [h, w]:
    cv2's kernel for float input (round(8 sigma + 1) | 1 taps of the
    normalized Gaussian, computed in float64 and stored as float32), rows
    then columns, each accumulated in float32, the border reflected
    without repeating the edge (``BORDER_REFLECT_101``). cv2's SIMD sums
    round differently in the last bit."""
    n = int(round(sigma * 8 + 1)) | 1
    t = np.arange(n) - (n - 1) / 2
    k = np.exp(-0.5 / sigma ** 2 * t * t)
    k = (k / k.sum()).astype(np.float32)
    r = n // 2
    x = np.asarray(x, np.float32)
    for _ in range(2):                       # rows, then the transpose's
        L = x.shape[1]
        p = np.pad(x, ((0, 0), (r, r)), mode="reflect")
        s = k[0] * p[:, :L]
        for i in range(1, n):
            s = s + k[i] * p[:, i:i + L]
        x = s.T
    return np.ascontiguousarray(x)


def _remap_linear(tex: np.ndarray, tx: np.ndarray,
                  ty: np.ndarray) -> np.ndarray:
    """``cv2.remap(tex, tx, ty, INTER_LINEAR, borderMode=BORDER_REPLICATE)``
    of a uint8 image [H, W, C] at float32 maps [h, w]: bilinear in float32
    between the four taps around (tx, ty), each clamped to the image, and
    rounded half to even to uint8 (OpenCV 5 interpolates in float; OpenCV
    4 rounds the maps to 1/32 px and weighs in fixed point, up to a level
    apart)."""
    h, w = tex.shape[:2]
    tx = np.asarray(tx, np.float32)
    ty = np.asarray(ty, np.float32)
    x0, y0 = np.floor(tx), np.floor(ty)
    a = (tx - x0)[..., None]
    b = (ty - y0)[..., None]
    # Far outside the image every tap clamps to the edge; clip first so
    # the cast to int cannot overflow.
    x0 = np.clip(x0, -1, w).astype(np.int64)
    y0 = np.clip(y0, -1, h).astype(np.int64)
    xa, xb = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)
    ya, yb = np.clip(y0, 0, h - 1), np.clip(y0 + 1, 0, h - 1)
    t = tex.astype(np.float32)
    top = (1 - a) * t[ya, xa] + a * t[ya, xb]
    bottom = (1 - a) * t[yb, xa] + a * t[yb, xb]
    v = (1 - b) * top + b * bottom
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def generate_scene(base: str, n_pairs: int = 64, image_hw: int = 160,
                   depth_z: float = 10.0, focal: float = 120.0,
                   max_shift_px: int = 48, seed: int = 0,
                   scale_range: tuple[float, float] = (1.0, 1.0),
                   p_translate: float = 0.0) -> str:
    """Write images/depths/pairs.txt under ``base``; return pairs path.

    Each pair: two crops of one texture plane related by camera motion at
    constant depth. With ``scale_range == (1, 1)`` the motion is a pure
    lateral translation — image2 is image1 shifted by (fx*tx/z, fy*ty/z)
    pixels. With ``scale_range`` above 1, camera 2 additionally dollies
    toward the plane (tz = z*(1-1/s)): image2 is an s-times magnified
    sub-crop of the canvas — the scale-difference regime OETR exists for
    (the reference trains on pairs with scale_diff > 2,
    the reference's src/utils/megadepth_preprocess.py:199-220). GT
    overlap boxes are recomputed online by the real geometry path either
    way.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(base, "imgs"), exist_ok=True)
    os.makedirs(os.path.join(base, "depths"), exist_ok=True)

    hw = image_hw
    K = np.array([[focal, 0, hw / 2], [0, focal, hw / 2], [0, 0, 1.0]])
    Ks = ",".join(str(x) for x in K.reshape(-1))
    P1 = ",".join(str(x) for x in np.eye(4).reshape(-1))
    full_box = f"0,0,{hw},{hw}"

    lines = []
    pad = max_shift_px
    pp = hw / 2.0
    for i in range(n_pairs):
        canvas = _texture(rng, hw + 2 * pad, hw + 2 * pad)
        im1 = canvas[pad:pad + hw, pad:pad + hw]
        s = float(rng.uniform(*scale_range))
        if rng.uniform() < p_translate:
            # Curriculum mixture: a fraction of pure same-scale
            # translation pairs (easy matching) alongside the dolly
            # pairs — useful when training a backbone from scratch.
            s = 1.0
        if s <= 1.0 + 1e-6:
            # Pure lateral shift: a canvas feature at image1 pixel u
            # appears in image2 at u - (dx, dy) -> t = -(dx, dy) * z / f.
            dx = int(rng.integers(-max_shift_px, max_shift_px + 1))
            dy = int(rng.integers(-max_shift_px, max_shift_px + 1))
            im2 = canvas[pad + dy:pad + dy + hw, pad + dx:pad + dx + hw]
            cam2 = np.array([dx * depth_z / focal,
                             dy * depth_z / focal, 0.0])
            depth2 = depth_z
        else:
            # Dolly-in: image2 sees the c x c sub-crop at (ox, oy) of the
            # image1 frame, magnified to hw (s_eff = hw / c exactly).
            c = max(int(round(hw / s)), 8)
            s_eff = hw / c
            ox = int(rng.integers(0, hw - c + 1))
            oy = int(rng.integers(0, hw - c + 1))
            im2 = resize_linear_u8(canvas[pad + oy:pad + oy + c,
                                          pad + ox:pad + ox + c], (hw, hw))
            # Pinhole at camera center (cx_w, cy_w, tz), identity R:
            # u2 = s*(u1 - o') requires tz = z(1 - 1/s),
            # c_w = (z/f) * (o' - pp*(1 - 1/s)).
            # The resize samples output pixel u2 at input (u2+0.5)/s - 0.5,
            # so the rendered content obeys u2 = s*(u1 - ox) + (s-1)/2 —
            # i.e. an effective offset o' = o - 0.5*(1 - 1/s). Using o'
            # keeps the pose/intrinsics GT sub-0.1px consistent with the
            # pixels (else a systematic (s-1)/2-px bias at the 1px
            # epipolar threshold).
            tz = depth_z * (1.0 - 1.0 / s_eff)
            shrink = 1.0 - 1.0 / s_eff
            cam2 = np.array([
                depth_z / focal * (ox - (pp + 0.5) * shrink),
                depth_z / focal * (oy - (pp + 0.5) * shrink), tz])
            depth2 = depth_z - tz
        imwrite_jpeg(os.path.join(base, "imgs", f"a{i}.jpg"), im1)
        imwrite_jpeg(os.path.join(base, "imgs", f"b{i}.jpg"), im2)
        for nm, dz in ((f"a{i}", depth_z), (f"b{i}", depth2)):
            with hdf5.File(os.path.join(base, "depths", f"{nm}.h5"),
                           "w") as f:
                f.create_dataset("/depth", data=np.full((hw, hw), dz,
                                                        np.float32))
        pose2 = np.eye(4)
        pose2[:3, 3] = -cam2            # world->cam: t = -R c, R = I
        P2 = ",".join(str(x) for x in pose2.reshape(-1))
        lines.append(
            f"imgs/a{i}.jpg depths/a{i}.h5 {Ks} {P1} {full_box} "
            f"imgs/b{i}.jpg depths/b{i}.h5 {Ks} {P2} {full_box}")

    pairs = os.path.join(base, "pairs.txt")
    with open(pairs, "w") as f:
        f.write("\n".join(lines))
    return pairs


# ---------------------------------------------------------------------------
# General 3-D scenes: multi-plane depth, rotation, perspective, illumination
# ---------------------------------------------------------------------------


def _rot(rx: float, ry: float, rz: float) -> np.ndarray:
    """R = Rz @ Ry @ Rx (radians), world->cam rotation."""
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _render_planes(planes: list[dict], K: np.ndarray, R: np.ndarray,
                   c: np.ndarray, hw: int) -> tuple[np.ndarray, np.ndarray]:
    """Ray-cast fronto-parallel textured planes into a camera.

    ``planes``: far-to-near list of {z, x0, y0, x1, y1, tex, ppw} —
    a world-frame rectangle at depth ``z`` whose texture has ``ppw``
    pixels per world unit. Camera: world->cam rotation ``R``, center
    ``c`` (t = -R c). Pixel (i, j) casts the ray through continuous
    coordinate (j, i) — the cv2-keypoint convention, so a rendered
    feature at array index (i, j) projects exactly to (j, i): the
    pose/intrinsics GT is sub-pixel consistent with the pixels by
    construction (no integer-crop shortcuts).

    Returns (image uint8 RGB [hw, hw, 3], zdepth float32 [hw, hw];
    depth 0 where no plane is hit).
    """
    jj, ii = np.meshgrid(np.arange(hw, dtype=np.float64),
                         np.arange(hw, dtype=np.float64))
    # Camera-frame ray directions with d_z = 1 -> z_cam of a hit = lambda.
    d_cam = np.stack([(jj - K[0, 2]) / K[0, 0],
                      (ii - K[1, 2]) / K[1, 1],
                      np.ones_like(jj)], axis=-1)
    d_world = d_cam @ R                      # R^T d, [hw, hw, 3]
    img = np.zeros((hw, hw, 3), np.float32)
    depth = np.zeros((hw, hw), np.float32)
    for p in planes:                         # far -> near: near overwrites
        dz = d_world[..., 2]
        lam = (p["z"] - c[2]) / np.where(np.abs(dz) > 1e-12, dz, 1e-12)
        x = c[0] + lam * d_world[..., 0]
        y = c[1] + lam * d_world[..., 1]
        valid = ((lam > 1e-6) & (x >= p["x0"]) & (x <= p["x1"])
                 & (y >= p["y0"]) & (y <= p["y1"]))
        tx = ((x - p["x0"]) * p["ppw"]).astype(np.float32)
        ty = ((y - p["y0"]) * p["ppw"]).astype(np.float32)
        sampled = _remap_linear(p["tex"], tx, ty)
        img = np.where(valid[..., None], sampled.astype(np.float32), img)
        depth = np.where(valid, lam.astype(np.float32), depth)
    return np.clip(img, 0, 255).astype(np.uint8), depth


def generate_scene_3d(base: str, n_pairs: int = 64, image_hw: int = 256,
                      focal: float | None = None, seed: int = 0,
                      n_fg_planes: tuple[int, int] = (1, 3),
                      depth_bg: float = 12.0,
                      rot_deg: float = 12.0, tilt_deg: float = 8.0,
                      trans_frac: float = 0.3,
                      scale_range: tuple[float, float] = (1.0, 1.8),
                      illum_range: tuple[float, float] = (0.7, 1.3),
                      max_tex: int = 1536) -> str:
    """Harder synthetic two-view scenes; returns the pairs.txt path.

    Unlike :func:`generate_scene` (constant-depth plane, pure
    translation/dolly — the regime a planar-homography fallback wins by
    construction), each pair here is a genuinely 3-D scene: a background
    plane plus 1-3 floating foreground planes at distinct depths
    (occlusion + parallax, so the epipolar/E path is the right model),
    observed by a second camera with in-plane rotation (±rot_deg),
    out-of-plane tilt (±tilt_deg, perspective), lateral translation, a
    dolly-in scale factor from ``scale_range``, and a global illumination
    gain from ``illum_range``. Rendering is exact ray-casting
    (cv2-keypoint coordinate convention), so pose/intrinsics/depth GT is
    sub-pixel consistent; depth maps record z-depth per camera including
    occlusion, so the overlap-box GT path (geometry/overlap.py) and the
    reference's regime (scale_diff + viewpoint change,
    the reference's src/utils/megadepth_preprocess.py:141-151) are both
    exercised for real.

    Output tree/pairs format is identical to :func:`generate_scene`.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(base, "imgs"), exist_ok=True)
    os.makedirs(os.path.join(base, "depths"), exist_ok=True)

    hw = image_hw
    f = focal if focal is not None else 0.9 * hw
    K = np.array([[f, 0, hw / 2], [0, f, hw / 2], [0, 0, 1.0]])
    Ks = ",".join(str(x) for x in K.reshape(-1))
    P1 = ",".join(str(x) for x in np.eye(4).reshape(-1))
    full_box = f"0,0,{hw},{hw}"
    lines = []

    for i in range(n_pairs):
        s = float(rng.uniform(*scale_range))
        # Camera 2: dolly to depth_bg/s plus lateral offset, rotated.
        tz = depth_bg * (1.0 - 1.0 / s)
        shift_w = trans_frac * depth_bg * hw / f     # world units
        c2 = np.array([rng.uniform(-shift_w, shift_w),
                       rng.uniform(-shift_w, shift_w), tz])
        R2 = _rot(np.deg2rad(rng.uniform(-tilt_deg, tilt_deg)),
                  np.deg2rad(rng.uniform(-tilt_deg, tilt_deg)),
                  np.deg2rad(rng.uniform(-rot_deg, rot_deg)))

        # Background plane: generously covers both cameras' views.
        half_bg = (depth_bg / f) * hw * 1.1 + shift_w
        ppw_bg = min(s * f / depth_bg, max_tex / (2 * half_bg))
        tw = int(np.ceil(2 * half_bg * ppw_bg))
        planes = [{
            "z": depth_bg, "x0": -half_bg, "y0": -half_bg,
            "x1": half_bg, "y1": half_bg,
            "tex": _texture(rng, tw, tw), "ppw": ppw_bg,
        }]
        # Foreground planes: nearer, smaller, floating (parallax).
        for _ in range(int(rng.integers(*n_fg_planes, endpoint=True))):
            zf = float(rng.uniform(0.45, 0.8)) * depth_bg
            half = float(rng.uniform(0.08, 0.22)) * (zf / f) * hw
            cx = float(rng.uniform(-0.3, 0.3)) * (zf / f) * hw
            cy = float(rng.uniform(-0.3, 0.3)) * (zf / f) * hw
            ppw = min(s * f / zf, 512 / (2 * half))
            tws = max(int(np.ceil(2 * half * ppw)), 16)
            planes.append({
                "z": zf, "x0": cx - half, "y0": cy - half,
                "x1": cx + half, "y1": cy + half,
                "tex": _texture(rng, tws, tws), "ppw": ppw,
            })
        planes.sort(key=lambda p: -p["z"])   # far -> near

        im1, d1 = _render_planes(planes, K, np.eye(3), np.zeros(3), hw)
        im2, d2 = _render_planes(planes, K, R2, c2, hw)
        gain = float(rng.uniform(*illum_range))
        im2 = np.clip(im2.astype(np.float32) * gain, 0, 255).astype(np.uint8)

        imwrite_jpeg(os.path.join(base, "imgs", f"a{i}.jpg"), im1)
        imwrite_jpeg(os.path.join(base, "imgs", f"b{i}.jpg"), im2)
        for nm, dm in ((f"a{i}", d1), (f"b{i}", d2)):
            with hdf5.File(os.path.join(base, "depths", f"{nm}.h5"),
                           "w") as fh:
                fh.create_dataset("/depth", data=dm.astype(np.float32))
        pose2 = np.eye(4)
        pose2[:3, :3] = R2
        pose2[:3, 3] = -R2 @ c2
        P2 = ",".join(str(x) for x in pose2.reshape(-1))
        lines.append(
            f"imgs/a{i}.jpg depths/a{i}.h5 {Ks} {P1} {full_box} "
            f"imgs/b{i}.jpg depths/b{i}.h5 {Ks} {P2} {full_box}")

    pairs = os.path.join(base, "pairs.txt")
    with open(pairs, "w") as fh:
        fh.write("\n".join(lines))
    return pairs
