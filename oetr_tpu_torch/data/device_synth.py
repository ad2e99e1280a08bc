"""On-device synthetic scene pairs (port of ``oetr_tpu/data/device_synth.py``).

A pair is a procedural texture (6 colour waves + 25 Gaussian blobs + 80
sharp-edged alpha-blended rectangles + band-limited noise, quantised to
8 bits), cut into image 1 and re-sampled bilinearly as image 2 under a
lateral translation or a dolly-in; the ground-truth overlap boxes come
from the real geometry path (``geometry/overlap.py``) on the pair's K,
constant depth and poses. ``make_homography_pair_generator`` gives
grayscale texture pairs under a random homography instead.

Everything is batched over pairs on the chosen device. Each stage is split
in two: a *draw* takes the random numbers from an explicit
``torch.Generator`` into a small dict of tensors, one entry per
``jax.random`` call of the JAX module (same shapes and ranges; the
streams differ by design), and a deterministic *render* turns the draws
into images. So the renderers can be held to JAX on JAX's own draws.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..geometry.overlap import overlap_bbox_pair


def _uniform(generator, shape, lo=0.0, hi=1.0):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def draw_texture(generator: torch.Generator, b: int, h: int, w: int) -> dict:
    """The random numbers of ``b`` textures of h x w."""
    u = lambda *shape, lo=0.0, hi=1.0: _uniform(generator, (b,) + shape,
                                                lo, hi)
    return {
        "wave_freq": u(6, 2, lo=0.01, hi=0.08),
        "wave_phase": u(6, hi=2 * math.pi),
        "wave_color": u(6, 3),
        "blob_y": u(25, hi=float(h)), "blob_x": u(25, hi=float(w)),
        "blob_sigma": u(25, lo=2.0, hi=12.0),
        "blob_color": u(25, 3, lo=-1.0, hi=1.0),
        "rect_y": u(80, hi=float(h - 4)), "rect_x": u(80, hi=float(w - 4)),
        "rect_h": u(80, lo=3.0, hi=18.0), "rect_w": u(80, lo=3.0, hi=18.0),
        "rect_color_alpha": u(80, 4),
        "noise": torch.randn((b, h, w), generator=generator,
                             device=generator.device),
    }


def _texture(d: dict, h: int, w: int) -> torch.Tensor:
    """Render textures [B, h, w, 3] in [0, 1] on the 1/255 grid from
    ``draw_texture``'s numbers."""
    dev = d["noise"].device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]

    f = d["wave_freq"][..., None, None]                  # [B, 6, 2, 1, 1]
    phase = (f[:, :, 0] * xx + f[:, :, 1] * yy
             + d["wave_phase"][..., None, None])         # [B, 6, h, w]
    img = torch.einsum("bkhw,bkc->bhwc", torch.sin(phase), d["wave_color"])
    del phase

    cy, cx = d["blob_y"][..., None, None], d["blob_x"][..., None, None]
    s = d["blob_sigma"][..., None, None]
    g = torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2.0 * s ** 2))
    img = img + torch.einsum("bkhw,bkc->bhwc", g, d["blob_color"])
    del g

    img = img - img.amin(dim=(1, 2, 3), keepdim=True)
    img = img / img.amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-6)

    # 80 rectangles, painted in order (each over the ones before it).
    colour = d["rect_color_alpha"][..., :3]
    alpha = 0.4 + 0.5 * d["rect_color_alpha"][..., 3]
    for r in range(d["rect_y"].shape[1]):
        y0, x0 = d["rect_y"][:, r, None, None], d["rect_x"][:, r, None, None]
        rh, rw = d["rect_h"][:, r, None, None], d["rect_w"][:, r, None, None]
        mask = (yy >= y0) & (yy < y0 + rh) & (xx >= x0) & (xx < x0 + rw)
        a = alpha[:, r, None, None, None]
        c = colour[:, r, None, None, :]
        img = torch.where(mask[..., None], (1 - a) * img + a * c, img)

    # Band-limited noise: a separable 9-tap Gaussian blur (sigma 1.2) of
    # the normal draw, zero-padded as jnp.convolve(mode="same") is.
    t = torch.arange(-4, 5, dtype=torch.float32, device=dev)
    kern = torch.exp(-t * t / (2 * 1.2 * 1.2))
    kern = (kern / kern.sum()).view(1, 1, 9)
    noise = d["noise"]
    b = noise.shape[0]
    noise = F.conv1d(noise.reshape(b * h, 1, w), kern, padding=4)
    noise = noise.view(b, h, w).transpose(1, 2).reshape(b * w, 1, h)
    noise = F.conv1d(noise, kern, padding=4).view(b, w, h).transpose(1, 2)
    img = torch.clamp(img + 0.08 * noise[..., None], 0.0, 1.0)
    # 8-bit quantisation (round half to even, as jnp.round).
    return torch.round(img * 255.0) / 255.0


def _bilinear(canvas: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """Sample canvases [B, H, W, C] at float (x, y) [B, ...] -> [B, ..., C],
    with the taps clamped to the canvas."""
    b, h, w, c = canvas.shape
    x0 = torch.clamp(torch.floor(x), 0, w - 1)
    y0 = torch.clamp(torch.floor(y), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    flat = canvas.reshape(b, h * w, c)

    def tap(yi, xi):
        idx = (yi.long() * w + xi.long()).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(x.shape + (c,))

    return ((1 - wy) * ((1 - wx) * tap(y0, x0) + wx * tap(y0, x1))
            + wy * ((1 - wx) * tap(y1, x0) + wx * tap(y1, x1)))


def draw_scene(generator: torch.Generator, b: int, hw: int, pad: int,
               scale_range: tuple[float, float]) -> dict:
    """The random numbers of ``b`` scene pairs: a texture of (hw + 2 pad)²,
    the motion mode, the dolly scale, the offset seeds and the gain."""
    side = hw + 2 * pad
    return {"texture": draw_texture(generator, b, side, side),
            "mode": _uniform(generator, (b,)),
            "scale": _uniform(generator, (b,), *scale_range),
            "offset": _uniform(generator, (b, 2)),
            "illum": _uniform(generator, (b,))}


def _synthesize(d: dict, hw: int, pad: int, depth_z: float, focal: float,
                p_translate: float, illum_jitter: float) -> dict:
    """Render scene pairs and their geometry from ``draw_scene``'s numbers
    (the batched form of JAX's ``_synthesize_one``)."""
    side = hw + 2 * pad
    canvas = _texture(d["texture"], side, side)
    im1 = canvas[:, pad:pad + hw, pad:pad + hw]
    b, dev = canvas.shape[0], canvas.device

    pp = hw / 2.0
    translate = d["mode"] < p_translate
    s = torch.where(translate, 1.0, torch.clamp(d["scale"], min=1.0))
    # Offset of image 2's footprint in image 1's frame (continuous px).
    off01 = d["offset"]
    off_translate = (off01 * 2.0 - 1.0) * pad                # [-pad, pad]
    off_dolly = off01 * (hw - hw / s[:, None])               # [0, hw - hw/s]
    off = torch.where(translate[:, None], off_translate, off_dolly)
    ox, oy = off[:, 0], off[:, 1]

    # Image 2 by bilinear sampling: u1 = o + (u2 + 0.5)/s - 0.5.
    u2 = torch.arange(hw, dtype=torch.float32, device=dev)
    gx = pad + ox[:, None] + (u2[None, :] + 0.5) / s[:, None] - 0.5
    gy = pad + oy[:, None] + (u2[None, :] + 0.5) / s[:, None] - 0.5
    im2 = _bilinear(canvas, gx[:, None, :].expand(b, hw, hw),
                    gy[:, :, None].expand(b, hw, hw))
    gain = 1.0 + illum_jitter * (2.0 * d["illum"] - 1.0)
    im2 = torch.clamp(im2 * gain[:, None, None, None], 0.0, 1.0)

    # Camera 2's centre: c = z/f (o - (pp + 0.5)(1 - 1/s)), tz = z(1 - 1/s).
    shrink = 1.0 - 1.0 / s
    tz = depth_z * shrink
    cam2 = torch.stack([depth_z / focal * (ox - (pp + 0.5) * shrink),
                        depth_z / focal * (oy - (pp + 0.5) * shrink), tz],
                       dim=-1)
    eye = torch.eye(4, dtype=torch.float32, device=dev).expand(b, 4, 4)
    pose1 = eye.clone()
    pose2 = eye.clone()
    pose2[:, :3, 3] = -cam2
    K = torch.tensor([[focal, 0.0, pp], [0.0, focal, pp], [0.0, 0.0, 1.0]],
                     dtype=torch.float32, device=dev).expand(b, 3, 3)
    depth1 = torch.full((b, hw, hw), depth_z, dtype=torch.float32,
                        device=dev)
    depth2 = (depth_z - tz)[:, None, None].expand(b, hw, hw)
    crop = torch.zeros((b, 2), dtype=torch.float32, device=dev)
    ratio = torch.ones((b, 2), dtype=torch.float32, device=dev)
    box1, _, box2, _, valid = overlap_bbox_pair(
        K, depth1, pose1, crop, ratio, K, depth2, pose2, crop, ratio)
    return {"image1": im1, "image2": im2,
            "overlap_box1": box1, "overlap_box2": box2,
            "overlap_valid": valid,
            "K1": K, "K2": K, "depth1": depth1, "depth2": depth2,
            "pose1": pose1, "pose2": pose2, "crop1": crop, "crop2": crop,
            "ratio1": ratio, "ratio2": ratio, "scale": s}


def draw_homography(generator: torch.Generator, b: int,
                    max_rot_deg: float = 25.0,
                    scale_range: tuple[float, float] = (0.55, 1.8),
                    max_shift_frac: float = 0.15,
                    max_persp: float = 5e-4) -> dict:
    """The random numbers of ``b`` homographies."""
    return {"rot_deg": _uniform(generator, (b,), -max_rot_deg, max_rot_deg),
            "scale": _uniform(generator, (b,), *scale_range),
            "shift": _uniform(generator, (b, 2), -max_shift_frac,
                              max_shift_frac),
            "persp": _uniform(generator, (b, 2), -max_persp, max_persp)}


def homography_from_draws(d: dict, hw: int) -> torch.Tensor:
    """[B, 3, 3] centre-anchored rotation + scale + shift + perspective
    homographies, T2 @ P @ A @ T1, from ``draw_homography``'s numbers."""
    th = torch.deg2rad(d["rot_deg"])
    s = d["scale"]
    tsh = d["shift"] * hw
    b, dev = s.shape[0], s.device
    c, si = torch.cos(th), torch.sin(th)
    cx = cy = hw / 2.0
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    A = eye.repeat(b, 1, 1)
    A[:, 0, 0], A[:, 0, 1] = s * c, -s * si
    A[:, 1, 0], A[:, 1, 1] = s * si, s * c
    T1 = torch.tensor([[1.0, 0, -cx], [0, 1.0, -cy], [0, 0, 1.0]],
                      device=dev).expand(b, 3, 3)
    T2 = torch.tensor([[1.0, 0, cx], [0, 1.0, cy], [0, 0, 1.0]],
                      device=dev).repeat(b, 1, 1)
    T2[:, 0, 2] += tsh[:, 0]
    T2[:, 1, 2] += tsh[:, 1]
    P = eye.repeat(b, 1, 1)
    P[:, 2, 0], P[:, 2, 1] = d["persp"][:, 0], d["persp"][:, 1]
    return T2 @ P @ A @ T1


def random_homography_device(generator: torch.Generator, b: int, hw: int,
                             max_rot_deg: float = 25.0,
                             scale_range: tuple[float, float] = (0.55, 1.8),
                             max_shift_frac: float = 0.15,
                             max_persp: float = 5e-4) -> torch.Tensor:
    """[B, 3, 3] random homographies about the image centre, on the
    generator's device."""
    return homography_from_draws(draw_homography(
        generator, b, max_rot_deg, scale_range, max_shift_frac, max_persp),
        hw)


def warp_gray(g: torch.Tensor, H: torch.Tensor, hw: int):
    """Inverse-warp grayscale images [B, hw, hw] (or [B, hw, hw, 1]) by H
    [B, 3, 3]: im1(x) = g(H⁻¹ x), 0 outside (cv2.warpPerspective's border).
    Returns (im1 [B, hw, hw, 1], inside [B, hw, hw] bool). The inverse
    reads no status back to the host (``inv_ex``; JAX's ``inv`` raises on
    nothing either), so a train step that draws its pairs here waits on no
    copy."""
    if g.dim() == 4:
        g = g[..., 0]
    Hi = torch.linalg.inv_ex(H).inverse
    u = torch.arange(hw, dtype=torch.float32, device=g.device)
    gy, gx = torch.meshgrid(u, u, indexing="ij")
    pts = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)    # [hw, hw, 3]
    src = pts @ Hi[:, None].transpose(-1, -2)             # [B, hw, hw, 3]
    sx = src[..., 0] / src[..., 2]
    sy = src[..., 1] / src[..., 2]
    inside = (sx >= 0) & (sx <= hw - 1) & (sy >= 0) & (sy <= hw - 1)
    warped = _bilinear(g[..., None], sx, sy)[..., 0]
    return torch.where(inside, warped, 0.0)[..., None], inside


def _default_generator(generator, device: torch.device):
    if generator is None:
        return torch.Generator(device=device).manual_seed(0)
    g = generator.device
    if g.type != device.type or (device.index is not None
                                 and g.index not in (None, device.index)):
        raise ValueError(f"the generator is on {g}, the batch is made on "
                         f"{device}")
    return generator


def make_homography_pair_generator(hw: int, batch_size: int,
                                   max_rot_deg: float = 25.0,
                                   scale_range: tuple[float, float] = (0.55,
                                                                       1.8),
                                   max_shift_frac: float = 0.15,
                                   max_persp: float = 5e-4, device="cuda"):
    """``gen(generator=None) -> (im0 [B, hw, hw, 1], im1 [B, hw, hw, 1],
    H [B, 3, 3])``: grayscale textures and their warps im1 = warp(im0, H),
    made on ``device`` from ``generator`` (a generator on ``device``; seed
    0 when None)."""
    device = torch.device(device)

    @torch.no_grad()
    def gen(generator: torch.Generator | None = None):
        generator = _default_generator(generator, device)
        tex = _texture(draw_texture(generator, batch_size, hw, hw), hw, hw)
        g = 0.299 * tex[..., 0] + 0.587 * tex[..., 1] + 0.114 * tex[..., 2]
        H = random_homography_device(generator, batch_size, hw, max_rot_deg,
                                     scale_range, max_shift_frac, max_persp)
        im1, _ = warp_gray(g, H, hw)
        return g[..., None], im1, H

    return gen


def make_device_generator(hw: int, batch_size: int,
                          scale_range: tuple[float, float] = (1.25, 3.2),
                          p_translate: float = 0.25, max_shift_px: int = 48,
                          depth_z: float = 10.0, focal: float = 120.0,
                          illum_jitter: float = 0.0, device="cuda"):
    """``gen(generator=None) -> batch``: fresh scene pairs made on
    ``device`` from ``generator`` (a generator on ``device``; seed 0 when
    None). The batch has the JAX generator's keys: image1/2 [B, hw, hw, 3],
    overlap_box1/2 [B, 4], overlap_valid [B], K1/2 [B, 3, 3], depth1/2
    [B, hw, hw], pose1/2 [B, 4, 4], crop1/2 and ratio1/2 [B, 2], and scale
    [B]."""
    device = torch.device(device)

    @torch.no_grad()
    def gen(generator: torch.Generator | None = None) -> dict:
        generator = _default_generator(generator, device)
        draws = draw_scene(generator, batch_size, hw, max_shift_px,
                           scale_range)
        return _synthesize(draws, hw, max_shift_px, depth_z, focal,
                           p_translate, illum_jitter)

    return gen
