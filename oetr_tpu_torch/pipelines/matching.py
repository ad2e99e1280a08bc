"""Overlap-guided matching pipelines (port of
``oetr_tpu/pipelines/matching.py``: ``SparsePipeline``, ``DensePipeline``
and their helpers).

OETR predicts the co-visible boxes on small copies of the images; the boxes
are rescaled to the full-resolution frame and gated, both overlap regions
are crop-resized onto a fixed canvas, SuperPoint and a matcher (SuperGlue)
or the dense matcher LoFTR run on the crops, and keypoints are mapped back
to the original frame (``kpts / ratio + box[:2]``). The reference's
fallback rules, which both pipelines apply:
  * a degenerate box (a side <= min_box_size) -> the full image;
  * the optional overlap-scale gate -> the full image;
  * fewer than ``fallback_min_matches`` matches -> the failing pairs only
    are re-run on the full image, in chunks of ``retry_batch`` pairs.
Everything is batched over pairs. Images are NHWC [B, H, W, 3] in [0, 1].
The OETR pass and the crop run in ``torch.profiler.record_function``
ranges (``oetr``, ``crop``), as do SuperPoint's, SuperGlue's and LoFTR's
stages, so a trace splits the device time by stage
(``profile_forward.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from ..models.oetr import decode_boxes
from ..models.superpoint import grayscale
from ..ops.warp import crop_resize_batch, unwarp_keypoints


@dataclass(frozen=True)
class PipelineConfig:
    oetr_hw: tuple[int, int] = (640, 640)     # the OETR pass's size
    canvas_hw: tuple[int, int] = (832, 832)   # crop canvas for extract/match
    min_box_size: float = 1.0                 # degenerate-box gate
    scale_gate: float = 0.0                   # > 0: overlap score > gate
    fallback_min_matches: int = 30            # retry a pair below this
    retry_batch: int = 2                      # retry chunk (0: whole batch)
    box_source: str = "heatmap"               # 'heatmap' | 'tlbr'
    box_q: float = 0.1                        # heatmap decode quantile
    box_pad: float = 0.2                      # heatmap decode padding


def _full_boxes(full_hw: torch.Tensor) -> torch.Tensor:
    """[B, 4] xyxy boxes covering each image's valid (h, w) extent."""
    hw = full_hw.float()
    zeros = torch.zeros_like(hw[:, 0])
    return torch.stack([zeros, zeros, hw[:, 1], hw[:, 0]], dim=-1)


def overlap_scale_score(bbox0: torch.Tensor,
                        bbox1: torch.Tensor) -> torch.Tensor:
    """Floor-divided box-size ratio score (the reference's pragueparks
    rule)."""
    bw0 = torch.floor(bbox0[..., 2]) - torch.floor(bbox0[..., 0])
    bh0 = torch.floor(bbox0[..., 3]) - torch.floor(bbox0[..., 1])
    bw1 = torch.floor(bbox1[..., 2]) - torch.floor(bbox1[..., 0])
    bh1 = torch.floor(bbox1[..., 3]) - torch.floor(bbox1[..., 1])

    def fdiv(a, b):
        return torch.div(a, torch.clamp(b, min=1), rounding_mode="floor")

    return torch.maximum(torch.maximum(fdiv(bw0, bw1), fdiv(bh0, bh1)),
                         torch.maximum(fdiv(bw1, bw0), fdiv(bh1, bh0)))


def gate_boxes(bbox0, bbox1, full_hw0, full_hw1, cfg: PipelineConfig):
    """Degenerate-box and scale gates; a gated pair falls back to the full
    images. full_hw*: [B, 2] (h, w). Returns (bbox0, bbox1, used_overlap
    [B] bool)."""
    sides = torch.stack([bbox0[:, 2] - bbox0[:, 0], bbox0[:, 3] - bbox0[:, 1],
                         bbox1[:, 2] - bbox1[:, 0], bbox1[:, 3] - bbox1[:, 1]],
                        dim=-1)
    ok = sides.amin(dim=-1) > cfg.min_box_size
    if cfg.scale_gate > 0:
        ok = ok & (overlap_scale_score(bbox0, bbox1) > cfg.scale_gate)
    bbox0 = torch.where(ok[:, None], bbox0, _full_boxes(full_hw0))
    bbox1 = torch.where(ok[:, None], bbox1, _full_boxes(full_hw1))
    return bbox0, bbox1, ok


def _bucketed_retry(run_plain: Callable, out: dict, image0, image1,
                    full_hw0, full_hw1, min_matches: int,
                    retry_batch: int) -> dict:
    """Fallback rule 2 at bounded cost: pairs that took the overlap crop
    and found fewer than ``min_matches`` matches are compacted on the host
    into chunks of ``retry_batch`` pairs (the last padded with the first
    failing pair), re-run on the full images, and scattered back.
    ``retry_batch=0`` re-runs the whole batch."""
    n = out["num_matches"].cpu().numpy()
    need = (n < min_matches) & out["used_overlap"].cpu().numpy()
    if not need.any():
        return out
    b = image0.shape[0]
    r = b if retry_batch <= 0 else min(retry_batch, b)
    idx = np.nonzero(need)[0]
    pad = (-len(idx)) % r
    idx_p = np.concatenate([idx, np.repeat(idx[:1], pad)])

    dev = image0.device
    chunks = []
    for c in range(0, len(idx_p), r):
        sl = torch.from_numpy(idx_p[c:c + r]).to(dev)
        chunks.append(run_plain(image0[sl], image1[sl], full_hw0[sl],
                                full_hw1[sl]))
    sel = torch.from_numpy(idx).to(dev)
    merged = dict(out)
    for key, val in out.items():
        if val is None or chunks[0].get(key) is None:
            continue
        pv = torch.cat([ch[key] for ch in chunks], dim=0)[:len(idx)]
        merged[key] = val.index_copy(0, sel, pv.to(val.dtype))
    return merged


class _OverlapPipeline:
    """What both pipelines share: OETR's boxes on the small copies, the
    gates, the crops onto the canvas, and the low-match retry. ``oetr`` is
    an OETR module or None (then every pair is matched on the full
    images); a subclass's ``_run`` matches the crops."""

    def __init__(self, oetr=None, cfg: PipelineConfig = PipelineConfig()):
        self.oetr = oetr
        self.cfg = cfg

    def predict_boxes(self, oetr_img0, oetr_img1, scales0, scales1):
        """OETR pass on the small copies -> boxes in the full-resolution
        frame, decoded by ``cfg.box_source``."""
        out = self.oetr(oetr_img0, oetr_img1)
        b0, b1 = decode_boxes(out, tuple(oetr_img0.shape[1:3]),
                              tuple(oetr_img1.shape[1:3]),
                              source=self.cfg.box_source, q=self.cfg.box_q,
                              pad=self.cfg.box_pad)
        return (b0 * torch.cat([scales0, scales0], dim=-1),
                b1 * torch.cat([scales1, scales1], dim=-1))

    def _crops(self, image0, image1, full_hw0, full_hw1, oetr_img0,
               oetr_img1, scales0, scales1, use_overlap: bool):
        """The gated boxes (OETR's, or the full images) and the crops onto
        the canvas: (crop0, crop1, bbox0, bbox1, ratio0, ratio1, used)."""
        if use_overlap and self.oetr is not None:
            with record_function("oetr"):
                bbox0, bbox1 = self.predict_boxes(oetr_img0, oetr_img1,
                                                  scales0, scales1)
                bbox0, bbox1, used = gate_boxes(bbox0, bbox1, full_hw0,
                                                full_hw1, self.cfg)
        else:
            bbox0, bbox1 = _full_boxes(full_hw0), _full_boxes(full_hw1)
            used = torch.zeros(image0.shape[0], dtype=torch.bool,
                               device=image0.device)
        canvas = self.cfg.canvas_hw
        with record_function("crop"):
            crop0, ratio0, _ = crop_resize_batch(image0, bbox0, canvas)
            crop1, ratio1, _ = crop_resize_batch(image1, bbox1, canvas)
        return crop0, crop1, bbox0, bbox1, ratio0, ratio1, used

    @torch.no_grad()
    def __call__(self, image0, image1, full_hw0, full_hw1, oetr_img0=None,
                 oetr_img1=None, scales0=None, scales1=None,
                 with_overlap: bool = True) -> dict:
        """Match a batch of pairs.

        image0/1 [B, H, W, 3] full-resolution canvases in [0, 1]; full_hw0/1
        [B, 2] the valid (h, w) of each; oetr_img0/1 [B, h, w, 3] the OETR
        pass's copies and scales0/1 [B, 2] full px per OETR px, (sx, sy).
        """
        if not (with_overlap and self.oetr is not None
                and oetr_img0 is not None):
            return self._run(image0, image1, full_hw0, full_hw1)
        out = self._run(image0, image1, full_hw0, full_hw1, oetr_img0,
                        oetr_img1, scales0, scales1, use_overlap=True)
        return _bucketed_retry(self._run, out, image0, image1, full_hw0,
                               full_hw1, self.cfg.fallback_min_matches,
                               self.cfg.retry_batch)


class SparsePipeline(_OverlapPipeline):
    """OETR -> crop -> SuperPoint -> matcher (SuperGlue).

    ``extractor`` is a SuperPoint module, ``match_fn`` takes the matcher's
    data dict and returns its matches dict, and ``oetr`` is an OETR module
    or None.
    """

    def __init__(self, extractor, match_fn: Callable, oetr=None,
                 cfg: PipelineConfig = PipelineConfig()):
        super().__init__(oetr, cfg)
        self.extractor = extractor
        self.match_fn = match_fn

    def _extract_and_match(self, crop0, crop1, hw):
        e0 = self.extractor(grayscale(crop0))
        e1 = self.extractor(grayscale(crop1))
        data = {
            "keypoints0": e0["keypoints"], "keypoints1": e1["keypoints"],
            "scores0": e0["scores"], "scores1": e1["scores"],
            "descriptors0": e0["descriptors"],
            "descriptors1": e1["descriptors"],
            "valid0": e0["valid"], "valid1": e1["valid"],
            "image_hw0": hw, "image_hw1": hw,
        }
        return e0, e1, self.match_fn(data)

    def _run(self, image0, image1, full_hw0, full_hw1, oetr_img0=None,
             oetr_img1=None, scales0=None, scales1=None,
             use_overlap: bool = False) -> dict:
        crop0, crop1, bbox0, bbox1, ratio0, ratio1, used = self._crops(
            image0, image1, full_hw0, full_hw1, oetr_img0, oetr_img1,
            scales0, scales1, use_overlap)
        canvas = self.cfg.canvas_hw
        e0, e1, m = self._extract_and_match(crop0, crop1, canvas)
        matches0 = m["matches0"]
        return {
            "keypoints0": unwarp_keypoints(e0["keypoints"], bbox0, ratio0),
            "keypoints1": unwarp_keypoints(e1["keypoints"], bbox1, ratio1),
            "valid0": e0["valid"], "valid1": e1["valid"],
            "scores0": e0["scores"], "scores1": e1["scores"],
            "descriptors0": e0["descriptors"],
            "descriptors1": e1["descriptors"],
            "matches0": matches0,
            "matching_scores0": m.get("matching_scores0"),
            "bbox0": bbox0, "bbox1": bbox1,
            "ratio0": ratio0, "ratio1": ratio1,
            "used_overlap": used,
            "num_matches": ((matches0 > -1) & e0["valid"]).sum(dim=-1),
        }


class DensePipeline(_OverlapPipeline):
    """OETR -> crop -> LoFTR (dense, detector-free matching): the
    reference's 'direct' matcher path. ``loftr`` is a LoFTR module,
    ``oetr`` an OETR module or None. The canvas (832x832 by default) is a
    multiple of LoFTR's size divisor of 8."""

    def __init__(self, loftr, oetr=None,
                 cfg: PipelineConfig = PipelineConfig(canvas_hw=(832, 832))):
        super().__init__(oetr, cfg)
        self.loftr = loftr

    def _run(self, image0, image1, full_hw0, full_hw1, oetr_img0=None,
             oetr_img1=None, scales0=None, scales1=None,
             use_overlap: bool = False) -> dict:
        crop0, crop1, bbox0, bbox1, ratio0, ratio1, used = self._crops(
            image0, image1, full_hw0, full_hw1, oetr_img0, oetr_img1,
            scales0, scales1, use_overlap)
        m = self.loftr(grayscale(crop0), grayscale(crop1))
        return {
            "mkpts0": unwarp_keypoints(m["mkpts0"], bbox0, ratio0),
            "mkpts1": unwarp_keypoints(m["mkpts1"], bbox1, ratio1),
            "conf": m["conf"], "valid": m["valid"],
            "bbox0": bbox0, "bbox1": bbox1,
            "ratio0": ratio0, "ratio1": ratio1,
            "used_overlap": used,
            "num_matches": m["valid"].sum(dim=-1),
        }
