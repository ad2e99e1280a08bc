"""K3: GroupNorm + ReLU + 3x3/s2 max-pool (pad 1) of the ResNet stem.

``groupnorm_relu_maxpool`` is the port of
``oetr_tpu/ops/pallas_norm.py::groupnorm_relu_maxpool``: the GroupNorm
statistics, folded into a per-(batch, channel) scale and shift as JAX's
``gn_scale_shift`` folds them outside its pallas_call, then the apply +
ReLU + pool. On a CUDA tensor both run as the hand-written kernels in
``csrc/gn_relu_maxpool.cu`` (a statistics pass, its fold, the apply); a CPU
tensor runs ``groupnorm_relu_maxpool_reference``, the plain torch version.
``gn_scale_shift_cuda`` runs the statistics kernels alone, against their
plain version ``gn_scale_shift``. Tensors are NHWC [B, H, W, C].

Gradients are JAX's (``groupnorm_relu_maxpool_trainable``): when grad mode
is on and x, gamma or beta requires grad, the call runs through
``autograd.KernelFunction``, whose backward is torch autograd of
``groupnorm_relu_maxpool_reference`` (flax's two-pass variance, not the
kernel's E[x²] - E[x]²).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check_launch, load_library
from .autograd import KernelFunction, needs_grad


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


def _kernel_inputs(x, gamma, beta, name):
    """Checks x for the kernels; returns (lib, dtype suffix, gamma and beta
    as f32, the stream)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous NHWC")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError(f"{name}: gamma and beta must be on {x.device}")
    lib, _ = load_library()
    suffix = "f32" if x.dtype == torch.float32 else "bf16"
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return (lib, suffix, gamma.float().contiguous(),
            beta.float().contiguous(), stream)


def _check_shape(x, num_groups, name):
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"{name}: H and W must be even, got {h}x{w}")
    if c % num_groups:
        raise ValueError(f"{name}: C={c} not divisible by {num_groups} "
                         "groups")
    return b, h, w, c


def gn_scale_shift_cuda(x, gamma, beta, num_groups: int = 32,
                        eps: float = 1e-5):
    """``gn_scale_shift`` by K3's statistics kernels: (scale, shift) [B, C]
    float32. A CPU tensor runs the plain version."""
    b, h, w, c = _check_shape(x, num_groups, "gn_scale_shift_cuda")
    if x.device.type == "cpu":
        return gn_scale_shift(x, gamma, beta, num_groups, eps)
    lib, suffix, g32, b32, stream = _kernel_inputs(
        x, gamma, beta, "gn_scale_shift_cuda")
    work = torch.empty(lib.oetr_gn_workspace_floats(b, h, w, c),
                       dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"oetr_gn_stats_{suffix}")(
            x.data_ptr(), g32.data_ptr(), b32.data_ptr(), work.data_ptr(),
            b, h, w, c, num_groups, eps, stream)
    check_launch(lib, rc, "gn_scale_shift_cuda")
    return work[:b * c].view(b, c), work[b * c:2 * b * c].view(b, c)


def groupnorm_relu_maxpool(x, gamma, beta, num_groups: int = 32,
                           eps: float = 1e-5):
    """GroupNorm -> ReLU -> max_pool(3x3, s2, pad 1) fused (K3).

    x: [B, H, W, C] with H and W even; gamma/beta [C]. Returns
    [B, H/2, W/2, C] in x's dtype. A CPU tensor runs the plain version; a
    CUDA tensor (float32 or bfloat16, contiguous) launches the kernels or
    raises. The kernels move 8 channels a thread where C is a multiple of 8
    and x is 16-byte aligned, as at the stem, and one a thread otherwise.
    Differentiable as in JAX (module docstring).
    """
    if needs_grad(x, gamma, beta):
        return KernelFunction.apply(_launch, groupnorm_relu_maxpool_reference,
                                    x, gamma, beta, num_groups, eps)
    return _launch(x, gamma, beta, num_groups, eps)


def _launch(x, gamma, beta, num_groups, eps):
    """K3's forward: the kernels on a CUDA tensor, the plain version on a
    CPU tensor."""
    b, h, w, c = _check_shape(x, num_groups, "groupnorm_relu_maxpool")
    if x.device.type == "cpu":
        return groupnorm_relu_maxpool_reference(x, gamma, beta, num_groups,
                                                eps)
    lib, suffix, g32, b32, stream = _kernel_inputs(
        x, gamma, beta, "groupnorm_relu_maxpool")
    work = torch.empty(lib.oetr_gn_workspace_floats(b, h, w, c),
                       dtype=torch.float32, device=x.device)
    out = torch.empty((b, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"oetr_gn_relu_maxpool_{suffix}")(
            x.data_ptr(), g32.data_ptr(), b32.data_ptr(), work.data_ptr(),
            out.data_ptr(), b, h, w, c, num_groups, eps, stream)
    check_launch(lib, rc, "groupnorm_relu_maxpool")
    groupnorm_relu_maxpool.launches += 1
    return out


groupnorm_relu_maxpool.launches = 0
