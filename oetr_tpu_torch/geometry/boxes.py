"""Box conversions for the OETR heads (port of ``oetr_tpu/geometry/boxes.py``)."""
from __future__ import annotations

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
