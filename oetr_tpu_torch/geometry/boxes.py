"""Box algebra (port of ``oetr_tpu/geometry/boxes.py``): conversions,
IoU / GIoU / OIoU and their losses, anchor decoding, over any leading batch
dimensions. Boxes are xyxy in pixels unless a name says otherwise."""
from __future__ import annotations

import math

import torch


def box_tlbr_to_xyxy(loc: torch.Tensor, tlbr: torch.Tensor, max_h: float,
                     max_w: float) -> torch.Tensor:
    """Center (x, y) [..., 2] + normalized (t, l, b, r) [..., 4] -> xyxy
    [..., 4], clamped to [0, max_w] x [0, max_h]."""
    t, l, b, r = tlbr.unbind(-1)
    x, y = loc.unbind(-1)
    x1 = torch.clamp(x - l * max_w, 0.0, max_w)
    y1 = torch.clamp(y - t * max_h, 0.0, max_h)
    x2 = torch.clamp(x + r * max_w, 0.0, max_w)
    y2 = torch.clamp(y + b * max_h, 0.0, max_h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def box_cxywh_to_xyxy(cxywh: torch.Tensor, max_h: float,
                      max_w: float) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2) clamped to the image."""
    cx, cy, w, h = cxywh.unbind(-1)
    return torch.stack([torch.clamp(cx - w / 2, 0.0, max_w),
                        torch.clamp(cy - h / 2, 0.0, max_h),
                        torch.clamp(cx + w / 2, 0.0, max_w),
                        torch.clamp(cy + h / 2, 0.0, max_h)], dim=-1)


def box_xyxy_to_cxywh(xyxy: torch.Tensor, max_h: float,
                      max_w: float) -> torch.Tensor:
    """(x1, y1, x2, y2), clamped to the image first -> (cx, cy, w, h)."""
    x1, y1, x2, y2 = xyxy.unbind(-1)
    x1 = torch.clamp(x1, 0.0, max_w)
    x2 = torch.clamp(x2, 0.0, max_w)
    y1 = torch.clamp(y1, 0.0, max_h)
    y2 = torch.clamp(y2, 0.0, max_h)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                       dim=-1)


def box_xywh_to_xyxy(xywh: torch.Tensor) -> torch.Tensor:
    """(x1, y1, w, h) -> (x1, y1, x2, y2)."""
    x1, y1, w, h = xywh.unbind(-1)
    return torch.stack([x1, y1, x1 + w, y1 + h], dim=-1)


def _area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def _intersection(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    return wh[..., 0] * wh[..., 1]


def bbox_overlaps_aligned(boxes1: torch.Tensor, boxes2: torch.Tensor,
                          mode: str = "iou",
                          eps: float = 1e-6) -> torch.Tensor:
    """Elementwise IoU ('iou') or intersection over boxes1's area ('iof')
    of [..., 4] boxes: [...]."""
    overlap = _intersection(boxes1, boxes2)
    area1 = _area(boxes1)
    if mode == "iou":
        union = area1 + _area(boxes2) - overlap
    elif mode == "iof":
        union = area1
    else:
        raise ValueError(f"mode must be 'iou' or 'iof', got {mode!r}")
    return overlap / torch.clamp(union, min=eps)


def bbox_overlaps_pairwise(boxes1: torch.Tensor, boxes2: torch.Tensor,
                           mode: str = "iou",
                           eps: float = 1e-6) -> torch.Tensor:
    """IoU (or IoF) matrix of boxes1 [..., M, 4] against boxes2 [..., N, 4]:
    [..., M, N]."""
    overlap = _intersection(boxes1[..., :, None, :], boxes2[..., None, :, :])
    area1 = _area(boxes1)
    if mode == "iou":
        union = area1[..., :, None] + _area(boxes2)[..., None, :] - overlap
    elif mode == "iof":
        union = area1[..., :, None].expand(overlap.shape)
    else:
        raise ValueError(f"mode must be 'iou' or 'iof', got {mode!r}")
    return overlap / torch.clamp(union, min=eps)


def bbox_oiou(target: torch.Tensor, pred: torch.Tensor,
              eps: float = 1e-7) -> torch.Tensor:
    """Overlap IoU: intersection over the target's area (at least eps)."""
    return _intersection(pred, target) / torch.clamp(_area(target), min=eps)


def iou_loss(pred: torch.Tensor, target: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """-log(IoU), the IoU clamped below at eps."""
    return -torch.log(torch.clamp(bbox_overlaps_aligned(pred, target),
                                  min=eps))


def oiou_loss(pred: torch.Tensor, target: torch.Tensor,
              eps: float = 1e-7) -> torch.Tensor:
    """1 - OIoU."""
    return 1.0 - bbox_oiou(target, pred, eps)


def giou_loss(pred: torch.Tensor, target: torch.Tensor,
              eps: float = 1e-7) -> torch.Tensor:
    """1 - generalized IoU."""
    overlap = _intersection(pred, target)
    union = _area(pred) + _area(target) - overlap + eps
    ious = overlap / union
    enc_lt = torch.minimum(pred[..., :2], target[..., :2])
    enc_rb = torch.maximum(pred[..., 2:], target[..., 2:])
    enc_wh = torch.clamp(enc_rb - enc_lt, min=0.0)
    enc_area = enc_wh[..., 0] * enc_wh[..., 1] + eps
    return 1.0 - (ious - (enc_area - union) / enc_area)


def pair_overlap_loss(pred1: torch.Tensor, target1: torch.Tensor,
                      pred2: torch.Tensor, target2: torch.Tensor,
                      oiou: bool = False) -> torch.Tensor:
    """Both images' GIoU (or OIoU) losses, averaged."""
    fn = oiou_loss if oiou else giou_loss
    return (fn(pred1, target1) + fn(pred2, target2)) / 2.0


def compute_locations(h: int, w: int, stride: int = 16,
                      device=None) -> torch.Tensor:
    """Pixel centres (x, y) of an h x w feature grid, row-major: [h*w, 2]
    float32, stride * index + stride // 2."""
    xs = (torch.arange(w, dtype=torch.float32, device=device) * stride
          + stride // 2)
    ys = (torch.arange(h, dtype=torch.float32, device=device) * stride
          + stride // 2)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)


def mesh_grid_centers(h: int, w: int, stride_h: float, stride_w: float,
                      device=None) -> torch.Tensor:
    """(x+0.5, y+0.5)·stride for each cell of an h x w grid, row-major:
    [h*w, 2] float32 in (x, y) order."""
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * stride_w
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * stride_h
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def boxes_from_prob_map(prob: torch.Tensor, hf: int, wf: int,
                        image_hw: tuple[float, float],
                        q: float = 0.05) -> torch.Tensor:
    """Overlap box from heatmap mass quantiles.

    prob: [B, hf*wf] softmax heatmap (row-major). Per axis, the box spans
    from the first cell where the cumulative mass reaches q to the last
    cell from which the remaining mass still reaches q, in pixels of
    ``image_hw``. Returns [B, 4] xyxy.
    """
    h, w = image_hw
    p = prob.reshape(prob.shape[0], hf, wf)
    px = p.sum(dim=1)                       # [B, wf] column mass
    py = p.sum(dim=2)                       # [B, hf] row mass

    def interval(m, n, extent):
        c = torch.cumsum(m, dim=-1)
        total = c[..., -1:]
        lo = torch.argmax((c >= q * total).to(torch.int32), dim=-1)
        rem = total - c + m                 # mass from cell i onward
        idx = torch.arange(n, device=m.device)
        hi = torch.where(rem >= q * total, idx, 0).amax(dim=-1)
        stride = extent / n
        a = lo.float() * stride
        b = (hi.float() + 1.0) * stride
        return a, torch.maximum(b, a + stride)

    x1, x2 = interval(px, wf, w)
    y1, y2 = interval(py, hf, h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def delta2bbox(rois: torch.Tensor, deltas: torch.Tensor,
               means: tuple = (0.0, 0.0, 0.0, 0.0),
               stds: tuple = (1.0, 1.0, 1.0, 1.0),
               max_shape: tuple | None = None,
               wh_ratio_clip: float = 16.0 / 1000.0) -> torch.Tensor:
    """Decode (dx, dy, dw, dh) deltas [..., 4] against anchor boxes rois
    [..., 4]: denormalized by means and stds, dw and dh clamped to
    |log(wh_ratio_clip)|, centres moved by dx·w and dy·h, sizes scaled by
    exp; xyxy, clamped to [0, W-1] x [0, H-1] where ``max_shape`` (H, W)
    is given."""
    means_a = torch.as_tensor(means, dtype=deltas.dtype, device=deltas.device)
    stds_a = torch.as_tensor(stds, dtype=deltas.dtype, device=deltas.device)
    d = deltas * stds_a + means_a
    dx, dy, dw, dh = d.unbind(-1)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = torch.clamp(dw, -max_ratio, max_ratio)
    dh = torch.clamp(dh, -max_ratio, max_ratio)
    px = (rois[..., 0] + rois[..., 2]) * 0.5
    py = (rois[..., 1] + rois[..., 3]) * 0.5
    pw = rois[..., 2] - rois[..., 0]
    ph = rois[..., 3] - rois[..., 1]
    gx = px + pw * dx
    gy = py + ph * dy
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    out = torch.stack([gx - gw * 0.5, gy - gh * 0.5, gx + gw * 0.5,
                       gy + gh * 0.5], dim=-1)
    if max_shape is not None:
        h, w = max_shape[:2]
        lim = torch.tensor([w - 1, h - 1, w - 1, h - 1], dtype=out.dtype,
                           device=out.device)
        out = torch.minimum(torch.clamp(out, min=0.0), lim)
    return out


def mask2bbox(mask: torch.Tensor) -> torch.Tensor:
    """[x1, y1, x2, y2] of the True pixels of a [..., H, W] mask, float32;
    all zero where no pixel is True."""
    h, w = mask.shape[-2:]
    dev = mask.device
    m = mask.to(torch.float32)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    big = 1e9
    any_true = m.amax(dim=(-2, -1)) > 0
    col = m.amax(dim=-2) > 0           # [..., W]: a True pixel in the column
    row = m.amax(dim=-1) > 0           # [..., H]
    box = torch.stack([torch.where(col, xs, big).amin(-1),
                       torch.where(row, ys, big).amin(-1),
                       torch.where(col, xs, -big).amax(-1),
                       torch.where(row, ys, -big).amax(-1)], dim=-1)
    return torch.where(any_true[..., None], box, torch.zeros_like(box))
