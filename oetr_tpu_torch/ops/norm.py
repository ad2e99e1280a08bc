"""K3: GroupNorm + ReLU + 3x3/s2 max-pool (pad 1) of the ResNet stem.

``groupnorm_relu_maxpool`` is the port of
``oetr_tpu/ops/pallas_norm.py::groupnorm_relu_maxpool``. The GroupNorm
statistics are folded into a per-(batch, channel) scale and shift by
``gn_scale_shift`` in plain torch, as JAX computes them outside its
pallas_call; on a CUDA tensor the apply + ReLU + pool then runs as the
hand-written kernel in ``csrc/gn_relu_maxpool.cu``. A CPU tensor runs
``groupnorm_relu_maxpool_reference``, the plain torch version. Tensors are
NHWC [B, H, W, C].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check_launch, load_library


def gn_scale_shift(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   num_groups: int, eps: float):
    """(scale, shift) [B, C] float32 with GN(x) = x * scale + shift.

    Statistics are f32 sums over x as it is (var = E[x²] - E[x]², as
    flax's GroupNorm), with no f32 copy of x.
    """
    b, h, w, c = x.shape
    xg = x.reshape(b, h * w, num_groups, c // num_groups)
    n = h * w * (c // num_groups)
    mean = xg.mean(dim=(1, 3), dtype=torch.float32)           # [B, G]
    sq = torch.linalg.vector_norm(xg, dim=(1, 3), dtype=torch.float32)
    var = sq.square() / n - mean.square()
    inv = torch.rsqrt(var + eps)
    rep = c // num_groups
    inv_c = inv.repeat_interleave(rep, dim=1)                 # [B, C]
    mean_c = mean.repeat_interleave(rep, dim=1)
    g32 = gamma.float()[None, :]
    scale = inv_c * g32
    shift = beta.float()[None, :] - mean_c * inv_c * g32
    return scale, shift


def groupnorm_relu_maxpool_reference(x, gamma, beta, num_groups: int = 32,
                                     eps: float = 1e-5):
    """Plain torch version of K3 with flax's GroupNorm semantics: f32
    statistics, output in x's dtype, then ReLU and the max-pool."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h, w, num_groups, c // num_groups)
    var, mean = torch.var_mean(xf, dim=(1, 2, 4), unbiased=False,
                               keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    y = y * gamma.float() + beta.float()
    y = torch.relu(y).to(x.dtype)
    y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def groupnorm_relu_maxpool(x, gamma, beta, num_groups: int = 32,
                           eps: float = 1e-5):
    """GroupNorm -> ReLU -> max_pool(3x3, s2, pad 1) fused (K3).

    x: [B, H, W, C] with H and W even; gamma/beta [C]. Returns
    [B, H/2, W/2, C] in x's dtype. A CPU tensor runs the plain version; a
    CUDA tensor (float32 or bfloat16, contiguous) launches the kernel or
    raises.
    """
    if x.dim() != 4:
        raise ValueError(f"groupnorm_relu_maxpool: x must be NHWC, got "
                         f"{tuple(x.shape)}")
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"groupnorm_relu_maxpool: H and W must be even, got "
                         f"{h}x{w}")
    if c % num_groups:
        raise ValueError(f"groupnorm_relu_maxpool: C={c} not divisible by "
                         f"{num_groups} groups")
    if x.device.type == "cpu":
        return groupnorm_relu_maxpool_reference(x, gamma, beta, num_groups,
                                                eps)
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm_relu_maxpool: no kernel for {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"groupnorm_relu_maxpool: dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("groupnorm_relu_maxpool: x must be contiguous NHWC")
    scale, shift = gn_scale_shift(x, gamma, beta, num_groups, eps)
    lib, _ = load_library()
    entry = (lib.oetr_gn_relu_maxpool_f32 if x.dtype == torch.float32
             else lib.oetr_gn_relu_maxpool_bf16)
    out = torch.empty((b, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = entry(x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                   out.data_ptr(), b, h, w, c, stream)
    check_launch(lib, rc, "groupnorm_relu_maxpool")
    groupnorm_relu_maxpool.launches += 1
    return out


groupnorm_relu_maxpool.launches = 0
