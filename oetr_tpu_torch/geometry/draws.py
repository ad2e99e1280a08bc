"""The random draws of the pose estimator, one function for all of them.

JAX's estimator splits one PRNG key into a key per stage
(``oetr_tpu/geometry/ransac.py:208,441``) and draws one Gumbel tensor
from each. The port takes an explicit ``torch.Generator`` instead, and
every draw goes through :func:`gumbel`, named by its stage:

  ``round1``      [..., num_hypotheses, N]            8-point samples
  ``round2``      [..., num_hypotheses // 2, N]       LO-RANSAC resampling
  ``five_point``  [..., max(num_hypotheses // 4, 32), N]
  ``homography``  [..., homography hypotheses, N]     the planar fallback
  ``parallax``    [..., 16, N]                        plane-and-parallax

So a caller that wants the draws of another source (JAX's, in the tests;
the card's, replayed on the CPU) replaces this one function; nothing else
depends on where the noise came from. A generator draws them in the order
``round1``, ``round2``, ``five_point``, ``homography``, ``parallax``,
skipping the stages a call does not run, so switching the 5-point stage or
the fallback off leaves the other stages' draws as they were.
"""
from __future__ import annotations

import torch

STAGES = ("round1", "round2", "five_point", "homography", "parallax")


def gumbel(stage: str, shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` in float32 on the generator's
    device: -log(-log(u)), u uniform on [tiny, 1)."""
    if stage not in STAGES:
        raise ValueError(f"unknown draw stage {stage!r}")
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))
