"""Visualisation (port of ``oetr_tpu/utils/viz.py``): match plots,
overlap-box overlays, the confidence colormap and MMA curves.

Host diagnostics in numpy; cv2 and matplotlib are imported inside the
functions that draw, so the module imports where they are missing.
"""
from __future__ import annotations

import numpy as np


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return matplotlib, plt


def _to_u8(im):
    im = np.asarray(im)
    if im.dtype != np.uint8:
        im = (np.clip(im, 0, 1) * 255).astype(np.uint8)
    return im


def error_colormap(x: np.ndarray) -> np.ndarray:
    """Red (0) to green (1) confidence colours: [N] -> [N, 4] RGBA."""
    x = np.clip(x, 0, 1)
    return np.clip(
        np.stack([2 - x * 2, x * 2, np.zeros_like(x), np.ones_like(x)], -1),
        0, 1)


def make_matching_plot(image0, image1, kpts0, kpts1, mkpts0, mkpts1, color,
                       text=(), path=None, show_keypoints=False, dpi=75):
    """Side-by-side matplotlib match plot of float [0, 1] or uint8 images,
    gray or RGB. Returns the figure (closed once saved to ``path``)."""
    matplotlib, plt = _pyplot()
    image0, image1 = _to_u8(image0), _to_u8(image1)
    fig, axes = plt.subplots(1, 2, figsize=(10, 6), dpi=dpi)
    for ax, im in zip(axes, (image0, image1)):
        ax.imshow(im, cmap="gray" if im.ndim == 2 else None)
        ax.set_axis_off()
    plt.tight_layout(pad=1)
    if show_keypoints:
        axes[0].scatter(kpts0[:, 0], kpts0[:, 1], c="k", s=2)
        axes[1].scatter(kpts1[:, 0], kpts1[:, 1], c="k", s=2)
    fig.canvas.draw()
    tf = fig.transFigure.inverted()
    fk0 = tf.transform(axes[0].transData.transform(mkpts0))
    fk1 = tf.transform(axes[1].transData.transform(mkpts1))
    fig.lines = [
        matplotlib.lines.Line2D((fk0[i, 0], fk1[i, 0]),
                                (fk0[i, 1], fk1[i, 1]),
                                zorder=1, transform=fig.transFigure,
                                c=color[i], linewidth=1)
        for i in range(len(mkpts0))]
    axes[0].scatter(mkpts0[:, 0], mkpts0[:, 1], c=color, s=4)
    axes[1].scatter(mkpts1[:, 0], mkpts1[:, 1], c=color, s=4)
    for i, t in enumerate(text):
        fig.text(0.01, 0.99 - i * 0.03, t, fontsize=10, va="top",
                 color="k")
    if path is not None:
        fig.savefig(path, bbox_inches="tight", pad_inches=0)
        plt.close(fig)
    return fig


def make_matching_plot_fast(image0, image1, mkpts0, mkpts1, color,
                            margin: int = 10, path=None):
    """cv2 side-by-side match plot. Returns the uint8 [H, W, 3] image."""
    import cv2

    def to_gray_u8(im):
        im = _to_u8(im)
        return cv2.cvtColor(im, cv2.COLOR_RGB2GRAY) if im.ndim == 3 else im

    im0, im1 = to_gray_u8(image0), to_gray_u8(image1)
    h0, w0 = im0.shape
    h1, w1 = im1.shape
    out = 255 * np.ones((max(h0, h1), w0 + w1 + margin), np.uint8)
    out[:h0, :w0] = im0
    out[:h1, w0 + margin:] = im1
    out = np.stack([out] * 3, -1)

    color_u8 = (np.asarray(color)[:, :3] * 255).astype(int)[:, ::-1]
    for (x0, y0), (x1, y1), c in zip(np.round(mkpts0).astype(int),
                                     np.round(mkpts1).astype(int),
                                     color_u8):
        c = tuple(int(v) for v in c)
        cv2.line(out, (x0, y0), (x1 + margin + w0, y1), c, 1,
                 lineType=cv2.LINE_AA)
        cv2.circle(out, (x0, y0), 2, c, -1, lineType=cv2.LINE_AA)
        cv2.circle(out, (x1 + margin + w0, y1), 2, c, -1,
                   lineType=cv2.LINE_AA)
    if path is not None:
        cv2.imwrite(str(path), out)
    return out


def plot_mma_curves(curves: dict[str, np.ndarray], thresholds=None,
                    title: str = "HPatches MMA", path=None, dpi=100):
    """MMA against the pixel threshold, one line per method (``curves``:
    name -> accuracy over ``thresholds``, 1..len px by default). Returns
    the figure."""
    _, plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4), dpi=dpi)
    for name, acc in curves.items():
        acc = np.asarray(acc, np.float64)
        thr = (np.arange(1, len(acc) + 1) if thresholds is None
               else np.asarray(thresholds))
        ax.plot(thr, acc, marker="o", markersize=3, linewidth=1.5,
                label=name)
    ax.set_xlabel("threshold [px]")
    ax.set_ylabel("MMA")
    ax.set_ylim(0, 1)
    ax.grid(alpha=0.3)
    ax.legend(fontsize=8)
    ax.set_title(title)
    fig.tight_layout()
    if path is not None:
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
    return fig


def visualize_overlap_gt(image1, bbox1, gt_bbox1, image2, bbox2, gt_bbox2,
                         path=None):
    """Predicted (blue) and ground-truth (green) overlap boxes side by
    side on [0, 255] images. Returns the uint8 image."""
    import cv2

    def prep(im):
        im = np.asarray(im)
        if im.dtype != np.uint8:
            im = np.clip(im, 0, 255).astype(np.uint8)
        if im.ndim == 2:
            im = np.stack([im] * 3, -1)
        return np.ascontiguousarray(im)

    left, right = prep(image1), prep(image2)
    for im, pred, gt in ((left, bbox1, gt_bbox1), (right, bbox2, gt_bbox2)):
        p = np.asarray(pred).astype(int)
        g = np.asarray(gt).astype(int)
        cv2.rectangle(im, (p[0], p[1]), (p[2], p[3]), (255, 0, 0), 2)
        cv2.rectangle(im, (g[0], g[1]), (g[2], g[3]), (0, 255, 0), 2)
    out = cv2.hconcat([left, right])
    if path is not None:
        cv2.imwrite(str(path), out)
    return out
