"""SuperPoint training (port of ``oetr_tpu/training/superpoint.py``).

The detector learns the 65-way cell classification (MagicPoint) on
synthetic shapes whose corners are known; the descriptor learns the hinge
loss over homography pairs (SuperPoint eq. 4-6); homographic adaptation
(``make_ha_labeler``) or a Shi-Tomasi teacher (``make_corner_labeler``)
labels texture images for the detector's loss on the target domain.

Cell labels [B, H/8, W/8] take values 0..63 (the corner's position inside
its 8x8 cell, row-major) or 64 (the dustbin), the detector head's layout.
A step updates the network in place and returns its metrics as tensors on
the network's device: nothing is read back. The batch builders
(``synthetic_shapes_batch``, ``homography_pairs_batch``) are host numpy
and import cv2 where they are called.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..data.device_synth import (_bilinear, draw_homography,
                                 homography_from_draws, warp_gray)
from ..ops.nms import remove_borders, simple_nms, topk_stable
from ..parallel.data import (global_batch, global_mean, global_numel,
                             sum_metrics, sync_params)
from .optim import apply_update


def corners_to_cell_labels(corners: np.ndarray, hw: tuple[int, int],
                           n_corners: np.ndarray | None = None) -> np.ndarray:
    """GT corner pixels -> [B, H/8, W/8] int32 cell labels.

    corners: [B, K, 2] (x, y) float; rows outside the image or beyond
    ``n_corners`` are ignored. On a collision inside one cell the last
    corner wins.
    """
    b, k = corners.shape[:2]
    h, w = hw
    labels = np.full((b, h // 8, w // 8), 64, np.int32)
    for i in range(b):
        kk = k if n_corners is None else int(n_corners[i])
        for x, y in corners[i][:kk]:
            xi, yi = int(round(x)), int(round(y))
            if 0 <= xi < w and 0 <= yi < h:
                labels[i, yi // 8, xi // 8] = (yi % 8) * 8 + (xi % 8)
    return labels


def magicpoint_loss(logits: torch.Tensor,
                    cell_labels: torch.Tensor) -> torch.Tensor:
    """Mean 65-way cross-entropy over cells (SuperPoint eq. 2, l_p)."""
    logp = F.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, cell_labels.long()[..., None])[..., 0]
    return -global_mean(ll)


def make_superpoint_train_step(net, optimizer, scheduler=None,
                               clip_norm: float | None = None):
    """``step(images, cell_labels) -> {"loss"}``: the detector loss on
    ``net`` (a ``SuperPointNet``, the raw network), its backward and the
    update (``optim.apply_update``)."""
    def step(images, cell_labels):
        optimizer.zero_grad(set_to_none=True)
        _, _, logits = net(images, with_logits=True)
        loss = magicpoint_loss(logits, cell_labels)
        loss.backward()
        apply_update(net.parameters(), optimizer, scheduler, clip_norm)
        return {"loss": loss.detach()}

    return step


def synthetic_shapes_batch(rng: np.random.Generator, b: int, hw: int = 96,
                           max_corners: int = 24):
    """Random filled quads and triangles: (images [B, hw, hw, 1] float32 in
    [0, 1], corners [B, K, 2] (x, y) padded with -1, counts [B]). Host
    side; needs cv2."""
    import cv2

    images = np.zeros((b, hw, hw, 1), np.float32)
    corners = np.full((b, max_corners, 2), -1.0, np.float32)
    counts = np.zeros(b, np.int32)
    for i in range(b):
        img = np.full((hw, hw), rng.uniform(0.0, 0.3), np.float32)
        pts_all = []
        for _ in range(int(rng.integers(2, 5))):
            n_v = int(rng.integers(3, 5))
            pts = rng.uniform(8, hw - 8, (n_v, 2)).astype(np.float32)
            hull = cv2.convexHull(pts.astype(np.float32))[:, 0, :]
            shade = float(rng.uniform(0.5, 1.0))
            cv2.fillPoly(img, [np.round(hull).astype(np.int32)], shade)
            pts_all += [tuple(p) for p in np.round(hull)]
        pts_all = pts_all[:max_corners]
        counts[i] = len(pts_all)
        for j, p in enumerate(pts_all):
            corners[i, j] = p
        images[i, :, :, 0] = img
    return images, corners, counts


# ------------------------------------------------------------ descriptor --

def cell_centers(hc: int, wc: int, stride: int = 8,
                 device=None) -> torch.Tensor:
    """[Hc*Wc, 2] full-resolution (x, y) centres of the coarse cells: grid
    index j at stride·j + stride/2 - 0.5 (``ops/nms.sample_descriptors``'
    convention)."""
    ys = (torch.arange(hc, dtype=torch.float32, device=device) * stride
          + stride / 2 - 0.5)
    xs = (torch.arange(wc, dtype=torch.float32, device=device) * stride
          + stride / 2 - 0.5)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def descriptor_hinge_loss(desc0: torch.Tensor, desc1: torch.Tensor,
                          H: torch.Tensor, hw: tuple[int, int],
                          stride: int = 8, pos_margin: float = 1.0,
                          neg_margin: float = 0.2, lambda_d: float = 250.0,
                          corr_radius: float = 8.0) -> torch.Tensor:
    """SuperPoint's descriptor loss l_d (eq. 4-6) over every pair of coarse
    cells: a pair whose image-0 centre warps (by H) within ``corr_radius``
    px of the image-1 centre and inside image 1 is positive (dot pulled
    above ``pos_margin``, weighted ``lambda_d``); every other pair is
    negative (pushed below ``neg_margin``).

    desc0, desc1 [B, Hc, Wc, D] unit descriptors; H [B, 3, 3] image-0 ->
    image-1 pixel homographies; hw the full-resolution (H, W).
    """
    b, hc, wc, d = desc0.shape
    n = hc * wc
    centers = cell_centers(hc, wc, stride, desc0.device)          # [N, 2]
    pts = torch.cat([centers, torch.ones((n, 1), dtype=torch.float32,
                                         device=desc0.device)], dim=-1)
    warped = torch.einsum("bij,nj->bni", H.float(), pts)          # [B, N, 3]
    z = warped[..., 2:]
    warped = warped[..., :2] / torch.where(z.abs() > 1e-12, z,
                                           torch.full_like(z, 1e-12))
    inside = ((warped[..., 0] >= 0) & (warped[..., 0] <= hw[1] - 1)
              & (warped[..., 1] >= 0) & (warped[..., 1] <= hw[0] - 1))
    dist = torch.linalg.vector_norm(warped[:, :, None, :]
                                    - centers[None, None], dim=-1)
    s = (dist <= corr_radius) & inside[..., None]                 # [B, N, N]

    dot = torch.einsum("bnd,bmd->bnm", desc0.reshape(b, n, d),
                       desc1.reshape(b, n, d))
    pos = torch.clamp(pos_margin - dot, min=0.0)
    neg = torch.clamp(dot - neg_margin, min=0.0)
    loss = torch.where(s, lambda_d * pos, neg)
    return loss.sum() / global_numel(b * n * n)


def random_homography(rng: np.random.Generator, hw: tuple[int, int],
                      max_rot_deg: float = 25.0,
                      scale_range: tuple[float, float] = (0.7, 1.4),
                      max_shift_frac: float = 0.15,
                      max_persp: float = 5e-4) -> np.ndarray:
    """A random rotation + scale + shift + perspective homography about the
    image centre (float64, numpy)."""
    h, w = hw
    cx, cy = w / 2.0, h / 2.0
    th = np.deg2rad(rng.uniform(-max_rot_deg, max_rot_deg))
    s = rng.uniform(*scale_range)
    tx = rng.uniform(-max_shift_frac, max_shift_frac) * w
    ty = rng.uniform(-max_shift_frac, max_shift_frac) * h
    c, si = np.cos(th), np.sin(th)
    A = np.array([[s * c, -s * si, 0], [s * si, s * c, 0], [0, 0, 1.0]])
    T1 = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
    T2 = np.array([[1, 0, cx + tx], [0, 1, cy + ty], [0, 0, 1.0]])
    P = np.eye(3)
    P[2, 0] = rng.uniform(-max_persp, max_persp)
    P[2, 1] = rng.uniform(-max_persp, max_persp)
    return (T2 @ P @ A @ T1).astype(np.float64)


def homography_pairs_batch(rng: np.random.Generator, b: int, hw: int = 128,
                           **h_kwargs):
    """Textured homography pairs: (im0 [B, hw, hw, 1] float32, im1 =
    warpPerspective(im0, H) with a constant 0 border, H [B, 3, 3] float64).
    Host side; needs cv2."""
    import cv2

    from ..data.synthetic import _texture

    im0 = np.zeros((b, hw, hw, 1), np.float32)
    im1 = np.zeros((b, hw, hw, 1), np.float32)
    Hs = np.zeros((b, 3, 3), np.float64)
    for i in range(b):
        tex = _texture(rng, hw, hw)
        g = cv2.cvtColor(tex, cv2.COLOR_RGB2GRAY).astype(np.float32) / 255.0
        H = random_homography(rng, (hw, hw), **h_kwargs)
        # A constant border: a reflected fill would repeat im0's content at
        # wrong places and make identical patches hinge negatives.
        g2 = cv2.warpPerspective(g, H, (hw, hw), flags=cv2.INTER_LINEAR,
                                 borderMode=cv2.BORDER_CONSTANT,
                                 borderValue=0.0)
        im0[i, :, :, 0] = g
        im1[i, :, :, 0] = g2
        Hs[i] = H
    return im0, im1, Hs


def make_superpoint_joint_train_step(net, optimizer, lambda_desc: float = 1.0,
                                     scheduler=None,
                                     clip_norm: float | None = None,
                                     group=None):
    """The detector loss on synthetic shapes plus ``lambda_desc`` times the
    descriptor hinge on homography pairs (one doubled batch through the
    network for both sides of the pairs), one update.

    ``step(shape_imgs, cell_labels, im0, im1, H) -> {"loss", "det_loss",
    "desc_loss"}``. ``group``: data parallelism over its ranks, each with
    its rows of the global batch.
    """
    sync_params(net, group)

    def step(shape_imgs, cell_labels, im0, im1, H):
        hw = tuple(im0.shape[1:3])
        optimizer.zero_grad(set_to_none=True)
        with global_batch(group):
            _, _, logits = net(shape_imgs, with_logits=True)
            det = magicpoint_loss(logits, cell_labels)
            _, desc = net(torch.cat([im0, im1], dim=0))
            d0, d1 = torch.chunk(desc, 2, dim=0)
            des = descriptor_hinge_loss(d0, d1, H, hw)
        loss = det + lambda_desc * des
        loss.backward()
        apply_update(net.parameters(), optimizer, scheduler, clip_norm,
                     group)
        return sum_metrics({"loss": loss.detach(), "det_loss": det.detach(),
                            "desc_loss": des.detach()}, group)

    return step


# ---------------------------------------------------------------- labels --

def labels_from_scores(nmsed: torch.Tensor, max_cells: int,
                       floor: torch.Tensor,
                       require_positive: bool = False) -> torch.Tensor:
    """65-way labels from an NMS'd [B, hw, hw] map: in each 8x8 cell the
    argmax, kept where the cell's maximum reaches the larger of the
    ``max_cells``-th largest cell maximum of its image and ``floor``
    ([B, 1, 1]) (and is > 0 with ``require_positive``); 64 elsewhere."""
    b, hw = nmsed.shape[:2]
    hc = hw // 8
    cells = nmsed.reshape(b, hc, 8, hc, 8).permute(0, 1, 3, 2, 4)
    cells = cells.reshape(b, hc, hc, 64)
    cmax = cells.amax(dim=-1)
    kth = topk_stable(cmax.reshape(b, -1), max_cells)[0][:, -1]
    thr = torch.maximum(kth[:, None, None], floor)
    keep = cmax >= thr
    if require_positive:
        keep = keep & (cmax > 0)
    return torch.where(keep, torch.argmax(cells, dim=-1),
                       torch.full_like(cmax, 64, dtype=torch.long)
                       ).to(torch.int32)


def draw_ha_homographies(generator: torch.Generator, n_homo: int, b: int,
                         hw: int) -> torch.Tensor:
    """The homographic-adaptation views' homographies [n_homo, B, 3, 3] on
    the generator's device: rotation up to 20°, scale 0.7-1.4, shift up to
    0.1 of the side, JAX's labeler's ranges."""
    d = draw_homography(generator, n_homo * b, 20.0, (0.7, 1.4), 0.1)
    return homography_from_draws(d, hw).reshape(n_homo, b, 3, 3)


@torch.no_grad()
def ha_scores(net, images: torch.Tensor, Hs: torch.Tensor,
              nms_radius: int = 4, border: int = 4) -> torch.Tensor:
    """The homographic-adaptation score map [B, hw, hw] of ``images``
    [B, hw, hw, 1] on given homographies ``Hs`` [n_homo, B, 3, 3]: the
    detector's scores on the images and on each warped view, the views'
    scores pulled back by bilinear sampling (0 where a view does not see
    the pixel), averaged over the views that see each pixel; then NMS and
    the border removed."""
    hw = images.shape[1]
    acc = net(images)[0].float()
    cnt = torch.ones_like(acc)
    u = torch.arange(hw, dtype=torch.float32, device=images.device)
    gy, gx = torch.meshgrid(u, u, indexing="ij")
    pts = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)     # [hw, hw, 3]
    for H in Hs:
        warped, _ = warp_gray(images, H, hw)
        s = net(warped)[0].float()
        dst = pts @ H[:, None].transpose(-1, -2)              # [B, hw, hw, 3]
        dx = dst[..., 0] / dst[..., 2]
        dy = dst[..., 1] / dst[..., 2]
        ok = (dx >= 0) & (dx <= hw - 1) & (dy >= 0) & (dy <= hw - 1)
        val = _bilinear(s[..., None], dx, dy)[..., 0]
        acc = acc + torch.where(ok, val, 0.0)
        cnt = cnt + ok.float()
    mean = acc / torch.clamp(cnt, min=1.0)
    return remove_borders(simple_nms(mean, nms_radius), border)


def ha_labels(net, images: torch.Tensor, Hs: torch.Tensor, nms_radius: int = 4,
              max_cells: int = 96, score_floor: float = 1e-3,
              border: int = 4) -> torch.Tensor:
    """Homographic-adaptation cell labels [B, hw/8, hw/8] int32 (64 =
    dustbin) on given homographies: ``ha_scores``, then per image the top
    ``max_cells`` cells above ``score_floor``."""
    nmsed = ha_scores(net, images, Hs, nms_radius, border)
    floor = torch.full((1, 1, 1), score_floor, dtype=torch.float32,
                       device=images.device)
    return labels_from_scores(nmsed, max_cells, floor)


def make_ha_labeler(net, hw: int, n_homo: int = 6, nms_radius: int = 4,
                    max_cells: int = 96, score_floor: float = 1e-3,
                    border: int = 4):
    """Homographic-adaptation pseudo-labels (SuperPoint §5): ``label_fn(
    images [B, hw, hw, 1], generator) -> [B, hw/8, hw/8] int32``, the
    homographies of its ``n_homo`` views drawn from ``generator`` (on the
    images' device; ``draw_ha_homographies``), then ``ha_labels`` with the
    network's current weights. Per image the top ``max_cells`` cells
    above ``score_floor`` keep a label: averaging over the views dilutes
    the peaks, so a fixed cutoff starves the labels."""
    def label_fn(images: torch.Tensor, generator: torch.Generator):
        Hs = draw_ha_homographies(generator, n_homo, images.shape[0], hw)
        return ha_labels(net, images, Hs, nms_radius, max_cells,
                         score_floor, border)

    return label_fn


@torch.no_grad()
def shi_tomasi_scores(images: torch.Tensor, nms_radius: int = 4,
                      border: int = 4, sigma: float = 1.5) -> torch.Tensor:
    """The Shi-Tomasi response [B, hw, hw] of ``images`` [B, hw, hw, 1]:
    the smaller eigenvalue of the structure tensor of 3x3 Sobel gradients
    under a separable Gaussian window (``sigma``), then NMS and the border
    removed."""
    dev = images.device
    sob = torch.tensor([[-1.0, 0, 1], [-2, 0, 2], [-1, 0, 1]],
                       device=dev) / 8
    r = max(1, int(round(2 * sigma)))
    g1 = torch.exp(-0.5 * (torch.arange(-r, r + 1, dtype=torch.float32,
                                        device=dev) / sigma) ** 2)
    g1 = g1 / g1.sum()

    def conv2(x, k):
        # SAME correlation of [B, H, W] with an odd-sized [kh, kw] kernel.
        kh, kw = k.shape
        return F.conv2d(x[:, None], k[None, None],
                        padding=(kh // 2, kw // 2))[:, 0]

    def smooth(x):
        return conv2(conv2(x, g1[None, :]), g1[:, None])

    g = images[..., 0].float()
    ix = conv2(g, sob)
    iy = conv2(g, sob.T)
    a = smooth(ix * ix)
    c = smooth(iy * iy)
    bb = smooth(ix * iy)
    resp = (a + c) / 2 - torch.sqrt(((a - c) / 2) ** 2 + bb ** 2 + 1e-12)
    return remove_borders(simple_nms(resp, nms_radius), border)


def make_corner_labeler(hw: int, nms_radius: int = 4, max_cells: int = 64,
                        quality: float = 0.01, border: int = 4,
                        sigma: float = 1.5, device="cuda"):
    """Shi-Tomasi pseudo-labels (cv2.goodFeaturesToTrack's semantics: a
    relative quality gate and spatial NMS), a static teacher where the
    detector's own homographic adaptation has nothing to stabilise:
    ``label_fn(images [B, hw, hw, 1]) -> [B, hw/8, hw/8] int32``,
    ``shi_tomasi_scores`` then per image the top ``max_cells`` cells above
    ``quality`` times the image's largest response. The images must lie
    on ``device``."""
    device = torch.device(device)

    @torch.no_grad()
    def label_fn(images: torch.Tensor) -> torch.Tensor:
        if images.device.type != device.type or images.shape[1] != hw:
            raise ValueError(f"images {tuple(images.shape)} on "
                             f"{images.device}: the labeler takes "
                             f"[B, {hw}, {hw}, 1] on {device}")
        nmsed = shi_tomasi_scores(images, nms_radius, border, sigma)
        top = nmsed.reshape(nmsed.shape[0], -1).amax(dim=-1)
        return labels_from_scores(nmsed, max_cells,
                                  (quality * top)[:, None, None],
                                  require_positive=True)

    return label_fn


def make_superpoint_joint_ha_train_step(net, optimizer,
                                        lambda_desc: float = 1.0,
                                        lambda_ha: float = 1.0,
                                        scheduler=None,
                                        clip_norm: float | None = None):
    """The joint step plus the detector loss on the texture stream against
    pseudo-labels (``make_ha_labeler`` / ``make_corner_labeler``), weighted
    by ``lambda_ha`` times the batch's ``ha_w`` (0 in a warm-up).

    ``step(shape_imgs, cell_labels, im0, im1, H, ha_labels, ha_w) ->
    {"loss", "det_loss", "desc_loss", "ha_loss"}``; ``im0`` is also the
    labelled texture batch.
    """
    def step(shape_imgs, cell_labels, im0, im1, H, ha_labels, ha_w):
        hw = tuple(im0.shape[1:3])
        optimizer.zero_grad(set_to_none=True)
        _, _, logits = net(shape_imgs, with_logits=True)
        det = magicpoint_loss(logits, cell_labels)
        _, desc0, logits0 = net(im0, with_logits=True)
        _, desc1 = net(im1)
        des = descriptor_hinge_loss(desc0, desc1, H, hw)
        ha = magicpoint_loss(logits0, ha_labels)
        loss = det + lambda_desc * des + lambda_ha * ha_w * ha
        loss.backward()
        apply_update(net.parameters(), optimizer, scheduler, clip_norm)
        return {"loss": loss.detach(), "det_loss": det.detach(),
                "desc_loss": des.detach(), "ha_loss": ha.detach()}

    return step
