"""Mask-aware statistics pooling over the time axis.

Port of ``pkr_tpu/ops/stats_pool.py``: the trunk emits (B, C, F', T') and
pooling reduces T'.  The map may be in either memory layout (channels_last
on a CUDA device, ``models/layout.py``): the reductions read it as it
lies.  'mean+std' uses the unbiased variance (torch.var_mean's default, as
the reference model) and sqrt(max(var, 1e-10)); the mask keeps padded
time columns out of both statistics, so a bucketed batch pools exactly as
exact-length runs do.
"""

from __future__ import annotations

from typing import Optional

import torch


def stats_pool(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
               pooling: str = "mean+std", eps: float = 1e-10) -> torch.Tensor:
    """(B, C, F, T) [+ (B, T) time mask] → (B, C, F) or (B, C, 2F).

    'mean+std' concatenates along the frequency axis, like the reference's
    cat([mean, std], dim=-1) on its (B, C, F) tensors.
    """
    xf = x.to(torch.float32)
    if mask is None:
        mean = torch.mean(xf, dim=3)
        if pooling == "mean":
            return mean
        n = xf.shape[3]
        var = torch.sum((xf - mean[..., None]) ** 2, dim=3) / max(n - 1, 1)
    else:
        m = mask.to(torch.float32)[:, None, None, :]  # (B, 1, 1, T)
        n = torch.clamp(torch.sum(m, dim=3), min=1.0)  # (B, 1, 1)
        mean = torch.sum(xf * m, dim=3) / n
        if pooling == "mean":
            return mean
        var = (torch.sum(((xf - mean[..., None]) * m) ** 2, dim=3)
               / torch.clamp(n - 1.0, min=1.0))
    if pooling != "mean+std":
        raise ValueError(f"unknown pooling {pooling!r}")
    std = torch.sqrt(torch.clamp(var, min=eps))
    return torch.cat([mean, std], dim=2)


def flatten_pooled(pooled: torch.Tensor) -> torch.Tensor:
    """(B, C, F?) → (B, C*F?): the reference's channel-major Flatten, so
    imported fc1 weights line up."""
    return pooled.reshape(pooled.shape[0], -1)
