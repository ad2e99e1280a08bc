"""The FCOS dense-prediction head and its losses (port of
``oetr_tpu/models/fcos.py``, the reference's ``oetr_fcos`` path).

``FCOSHead`` takes NHWC features [B, H, W, C], as the JAX module does, and
returns the classification logits, the tlbr box distances and the
centerness per location. ``fcos_losses`` is FCOSLossComputation with one
box per image: sigmoid focal classification, centerness-weighted GIoU
regression and centerness BCE, normalised by the positive count and the
centerness-target sum. JAX's form averages those two over the devices of
a data axis (a ``psum``); this one runs on one device, so they are the
local sums over a device count of 1. Positive locations are a dense mask,
so no shape depends on the data.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..geometry.boxes import giou_loss
from .layers import Conv, Dense, GroupNorm, LayerNorm, materialize


class Scale(nn.Module):
    """A learnable scalar multiplier (flax's ``scale`` leaf as ``weight``)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.init_value = init_value
        self.weight = nn.Parameter(torch.empty(()))

    def forward(self, x):
        return x * self.weight


class DynamicConv(nn.Module):
    """Feature/proposal bilinear mixing: features [B, N, C] times proposal
    features [B, C, D], LayerNorm and ReLU over D, flattened, then a Dense
    to 2·hidden_dim, LayerNorm and ReLU. flax infers the Dense's input
    (N·D) at first call; here ``num_tokens`` (N) and ``dim`` (D) fix it."""

    def __init__(self, hidden_dim: int, num_tokens: int, dim: int,
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype, eps=1e-6)
        self.out_layer = Dense(num_tokens * dim, 2 * hidden_dim, True, dtype)
        self.norm2 = LayerNorm(2 * hidden_dim, dtype, eps=1e-6)

    def forward(self, features, pro_features):
        x = torch.einsum("bnc,bcd->bnd", features, pro_features)
        x = F.relu(self.norm1(x))
        x = self.out_layer(x.reshape(x.shape[0], -1))
        return F.relu(self.norm2(x))


class FCOSHead(nn.Module):
    """Per-location classification, box and centerness towers: x [B, H, W,
    C] -> (logits [B, H, W, 1], bbox [B, H, W, 4], centerness [B, H, W,
    1]). Each tower is a 3x3 conv, GroupNorm (32 groups, eps 1e-6) and
    ReLU; the box distances are exp(scale · conv) (or ReLU with
    ``norm_reg_targets``, times the stride at inference)."""

    def __init__(self, in_channels: int, prior_prob: float = 0.01,
                 stride: int = 16, norm_reg_targets: bool = False,
                 centerness_on_reg: bool = True, is_training: bool = True,
                 dtype=torch.float32):
        super().__init__()
        c = in_channels
        self.prior_prob, self.stride = prior_prob, stride
        self.norm_reg_targets = norm_reg_targets
        self.centerness_on_reg = centerness_on_reg
        self.is_training = is_training
        for tower in ("cls_tower", "bbox_tower"):
            self.add_module(f"{tower}_conv", Conv(c, c, 3, 1, 1, dtype=dtype))
            self.add_module(f"{tower}_gn", GroupNorm(c, dtype, 32, eps=1e-6))
        self.cls_logits = Conv(c, 1, 3, 1, 1, dtype=dtype)
        self.centerness = Conv(c, 1, 3, 1, 1, dtype=dtype)
        self.bbox_pred = Conv(c, 4, 3, 1, 1, dtype=dtype)
        self.scales = Scale()

    def prior_bias(self) -> float:
        """The classification bias that makes P(foreground) prior_prob."""
        return -math.log((1 - self.prior_prob) / self.prior_prob)

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2)
        cls_t = F.relu(self.cls_tower_gn(self.cls_tower_conv(x)))
        box_t = F.relu(self.bbox_tower_gn(self.bbox_tower_conv(x)))
        logits = self.cls_logits(cls_t)
        centerness = self.centerness(box_t if self.centerness_on_reg
                                     else cls_t)
        bbox = self.scales(self.bbox_pred(box_t))
        if self.norm_reg_targets:
            bbox = F.relu(bbox)
            if not self.is_training:
                bbox = bbox * self.stride
        else:
            bbox = torch.exp(bbox)
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return nhwc(logits), nhwc(bbox), nhwc(centerness)


def build_fcos_head(device="cuda", generator: torch.Generator | None = None,
                    **kwargs) -> FCOSHead:
    """``FCOSHead(**kwargs)`` on ``device`` in eval mode, with weights drawn
    from ``generator`` (a CPU generator; seed 0 when None), the
    classification bias at the prior and the scale at 1, flax's initial
    values."""
    with torch.device("meta"):
        model = FCOSHead(**kwargs)
    model = materialize(model, device, generator)
    if model.scales.weight.device.type != "meta":
        with torch.no_grad():
            model.cls_logits.bias.fill_(model.prior_bias())
            model.scales.weight.fill_(model.scales.init_value)
    return model


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       gamma: float = 2.0, alpha: float = 0.25
                       ) -> torch.Tensor:
    """Element-wise sigmoid focal loss; the caller sums."""
    p = torch.sigmoid(logits)
    ce = -(targets * F.logsigmoid(logits)
           + (1 - targets) * F.logsigmoid(-logits))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
        loss = alpha_t * loss
    return loss


def softmax_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       gamma: float = 2.0) -> torch.Tensor:
    """Multi-class focal loss -(1 - p)^gamma log p of the labelled class."""
    logp = F.log_softmax(logits, dim=-1)
    logpt = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    pt = torch.exp(logpt)
    return -((1 - pt) ** gamma) * logpt


def compute_centerness_targets(reg_targets: torch.Tensor) -> torch.Tensor:
    """sqrt((min(l, r) / max(l, r)) · (min(t, b) / max(t, b)))."""
    lr = reg_targets[..., 0::2]
    tb = reg_targets[..., 1::2]
    c = ((lr.amin(dim=-1) / torch.clamp(lr.amax(dim=-1), min=1e-9))
         * (tb.amin(dim=-1) / torch.clamp(tb.amax(dim=-1), min=1e-9)))
    return torch.sqrt(torch.clamp(c, min=0.0))


def fcos_targets(locations: torch.Tensor, targets: torch.Tensor,
                 stride: float = 16.0, center_sampling_radius: float = 2.0,
                 norm_reg_targets: bool = False):
    """Per-location labels and tlbr regression targets, one box per image.

    locations [N, 2] pixel centres; targets [B, 4] xyxy boxes. A location
    is positive inside the box's centre region (``center_sampling_radius``
    strides around its centre, within the box), or inside the box when the
    radius is 0. Returns (labels [B, N] bool, reg_targets [B, N, 4]).
    """
    lx, ly = locations[None, :, 0], locations[None, :, 1]
    l = lx - targets[:, None, 0]
    t = ly - targets[:, None, 1]
    r = targets[:, None, 2] - lx
    b = targets[:, None, 3] - ly
    reg = torch.stack([l, t, r, b], dim=-1)                       # [B, N, 4]

    radius = stride * center_sampling_radius
    if radius > 0:
        cx = (targets[:, 0] + targets[:, 2]) * 0.5
        cy = (targets[:, 1] + targets[:, 3]) * 0.5
        xmin = torch.maximum(cx - radius, targets[:, 0])
        ymin = torch.maximum(cy - radius, targets[:, 1])
        xmax = torch.minimum(cx + radius, targets[:, 2])
        ymax = torch.minimum(cy + radius, targets[:, 3])
        edges = torch.stack([lx - xmin[:, None], ly - ymin[:, None],
                             xmax[:, None] - lx, ymax[:, None] - ly], dim=-1)
        inside = edges.amin(dim=-1) > 0
    else:
        inside = reg.amin(dim=-1) > 0
    if norm_reg_targets:
        reg = reg / stride
    return inside, reg


def fcos_losses(locations: torch.Tensor, box_cls: torch.Tensor,
                box_regression: torch.Tensor, centerness: torch.Tensor,
                targets: torch.Tensor) -> dict:
    """FCOS's loss triple on one device.

    locations [N, 2]; box_cls [B, H, W, 1]; box_regression [B, H, W, 4];
    centerness [B, H, W, 1]; targets [B, 4] xyxy. The positive count and
    the centerness-target sum are the local ones (JAX averages them over a
    data axis; over one device that is the same). Returns cls_loss,
    reg_loss, centerness_loss and num_pos, tensors on the inputs' device.
    """
    labels, reg_t = fcos_targets(locations, targets)
    cls_flat = box_cls.reshape(-1)
    reg_flat = box_regression.reshape(-1, 4)
    cent_flat = centerness.reshape(-1)
    reg_t_flat = reg_t.reshape(-1, 4)
    pos = labels.reshape(-1).float()

    num_pos = pos.sum()
    cent_targets = compute_centerness_targets(reg_t_flat) * pos
    # One device: the averages over devices are the local sums.
    num_pos_avg = torch.clamp(num_pos, min=1.0)
    sum_cent_avg = cent_targets.sum()

    cls_loss = sigmoid_focal_loss(cls_flat, pos).sum() / num_pos_avg

    # GIoU on tlbr distances as boxes around the origin.
    def tlbr_to_box(t):
        return torch.stack([-t[..., 0], -t[..., 1], t[..., 2], t[..., 3]],
                           dim=-1)

    reg_l = giou_loss(tlbr_to_box(reg_flat), tlbr_to_box(reg_t_flat))
    reg_loss = (reg_l * cent_targets).sum() / torch.clamp(sum_cent_avg,
                                                          min=1e-9)
    bce = (torch.clamp(cent_flat, min=0) - cent_flat * cent_targets
           + torch.log1p(torch.exp(-cent_flat.abs())))
    centerness_loss = (bce * pos).sum() / num_pos_avg
    return {"cls_loss": cls_loss, "reg_loss": reg_loss,
            "centerness_loss": centerness_loss, "num_pos": num_pos}
