"""Host-side image service (port of ``oetr_tpu/data/images.py``): read,
aspect-resize, pad to static canvases.

Every image becomes (a) a full-resolution canvas padded to the bucket
shape with its valid (h, w), and (b) a copy at the OETR pass's size with
the scale back to the full-resolution frame. Nothing here needs cv2:
``read_image`` reads through the port's own decoders (``data/jpeg.py``),
which give ``cv2.imread``'s pixels, and the resizes are ``resize_area``,
numpy's copy of ``cv2.resize(..., interpolation=cv2.INTER_AREA)``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .jpeg import imread


@dataclass
class PreparedImage:
    canvas: np.ndarray        # [H, W, 3] float32 in [0, 1], padded
    valid_hw: np.ndarray      # [2] (h, w) of the valid region
    oetr_image: np.ndarray    # [h0, w0, 3] OETR-pass copy
    oetr_scale: np.ndarray    # [2] (sx, sy): full px per oetr px
    orig_hw: tuple[int, int]  # pre-resize source size
    scale_to_orig: np.ndarray  # [2] (sx, sy): original px per canvas px


def read_image(path: str, grayscale: bool = False) -> np.ndarray:
    """An image file (JPEG, PNG, PPM/PGM) -> RGB float32 [H, W, 3] in
    [0, 1], as cv2 reads it (a grayscale read is repeated over the 3
    channels). Raises FileNotFoundError for a missing file."""
    img = imread(path, grayscale)
    if grayscale:
        img = img[..., None].repeat(3, -1)
    return img.astype(np.float32) / 255.0


def _area_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] weights of cv2's area resize along one axis when it
    shrinks (or keeps) the axis: each output pixel averages the source
    pixels its cell covers, a partly covered pixel by its share
    (``computeResizeAreaTab``)."""
    scale = 1.0 / (dst / src)
    w = np.zeros((dst, src), np.float64)
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1 = int(np.ceil(fsx1))
        sx2 = min(int(np.floor(fsx2)), src - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            w[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            w[dx, sx] = np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            w[dx, sx2] = np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return w


def _area_linear_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] weights of cv2's INTER_AREA where the resize is not a
    shrink on both axes: two taps per output pixel, with the area mode's
    coefficients (``fx = (dx+1) - (sx+1)/scale``, its fraction) instead
    of bilinear's half-pixel ones, clamped at the edges."""
    inv_scale = dst / src
    scale = 1.0 / inv_scale
    w = np.zeros((dst, src), np.float64)
    for dx in range(dst):
        sx = int(np.floor(dx * scale))
        fx = float(np.float32((dx + 1) - (sx + 1) * inv_scale))
        fx = 0.0 if fx <= 0 else fx - np.floor(fx)
        if sx < 0:
            fx, sx = 0.0, 0
        if sx >= src - 1:
            fx, sx = 0.0, src - 1
        c0, c1 = np.float32(1.0 - fx), np.float32(fx)
        w[dx, sx] += c0
        if c1:
            w[dx, min(sx + 1, src - 1)] += c1
    return w


def resize_area(image: np.ndarray, size_wh: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(image, size_wh, interpolation=cv2.INTER_AREA)`` for a
    float32 [H, W] or [H, W, C] image, in numpy.

    cv2 averages over each output pixel's cell when neither axis grows
    (integer and fractional ratios alike), and otherwise interpolates
    between two source pixels per axis with the area mode's coefficients,
    on both axes, also on one that shrinks.
    """
    h, w = image.shape[:2]
    dw, dh = size_wh
    shrink = dw <= w and dh <= h
    weights = _area_weights if shrink else _area_linear_weights
    wy = weights(h, dh).astype(np.float32)
    wx = weights(w, dw).astype(np.float32)
    img = image.astype(np.float32)
    rows = np.tensordot(wy, img, axes=(1, 0))               # [dh, w, ...]
    out = np.tensordot(wx, rows, axes=(1, 1))               # [dw, dh, ...]
    return np.ascontiguousarray(np.swapaxes(out, 0, 1)).astype(np.float32)


def prepare_image(image: np.ndarray, canvas_hw: tuple[int, int],
                  oetr_hw: tuple[int, int] = (640, 640),
                  resize_max: int | None = None) -> PreparedImage:
    """Resize-and-pad an image into the static shapes the pipeline takes.

    Args:
      image: [H, W, 3] float32 in [0, 1].
      canvas_hw: bucket shape for full-resolution matching.
      oetr_hw: the OETR pass's input size.
      resize_max: optional largest side before padding.
    """
    h0, w0 = image.shape[:2]
    work = image
    scale_to_orig = np.array([1.0, 1.0])
    if resize_max is not None and max(h0, w0) > resize_max:
        r = resize_max / max(h0, w0)
        work = resize_area(image, (round(w0 * r), round(h0 * r)))
        scale_to_orig = np.array([w0 / work.shape[1], h0 / work.shape[0]])

    ch, cw = canvas_hw
    h, w = work.shape[:2]
    fit = min(cw / w, ch / h, 1.0)
    if fit < 1.0:
        work = resize_area(work, (int(w * fit), int(h * fit)))
        scale_to_orig = scale_to_orig / fit
        h, w = work.shape[:2]
    canvas = np.zeros((ch, cw, 3), np.float32)
    canvas[:h, :w] = work

    oh, ow = oetr_hw
    oetr_img = resize_area(work, (ow, oh))
    oetr_scale = np.array([w / ow, h / oh], np.float32)

    return PreparedImage(
        canvas=canvas,
        valid_hw=np.array([h, w], np.int32),
        oetr_image=oetr_img.astype(np.float32),
        oetr_scale=oetr_scale,
        orig_hw=(h0, w0),
        scale_to_orig=scale_to_orig.astype(np.float32),
    )


def batch_pairs(prepared0: list[PreparedImage],
                prepared1: list[PreparedImage]) -> dict:
    """Stack prepared images into the pipeline's input arrays."""
    stack = lambda xs: np.stack(xs, axis=0)
    return {
        "image0": stack([p.canvas for p in prepared0]),
        "image1": stack([p.canvas for p in prepared1]),
        "full_hw0": stack([p.valid_hw for p in prepared0]),
        "full_hw1": stack([p.valid_hw for p in prepared1]),
        "oetr_img0": stack([p.oetr_image for p in prepared0]),
        "oetr_img1": stack([p.oetr_image for p in prepared1]),
        "scales0": stack([p.oetr_scale for p in prepared0]),
        "scales1": stack([p.oetr_scale for p in prepared1]),
        "scale_to_orig0": stack([p.scale_to_orig for p in prepared0]),
        "scale_to_orig1": stack([p.scale_to_orig for p in prepared1]),
    }
