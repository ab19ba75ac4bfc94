"""Attention primitives shared by the Turtle blocks.

Softmax and normalisation run in at least float32 (float64 inputs stay
float64, so parity tests against the float64 reference are exact) and are
written NaN-free for ring-buffer cache slots that are still empty.
"""

from __future__ import annotations

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: at least float32, float64 preserved."""
    return torch.promote_types(dtype, torch.float32)


def masked_softmax(scores: torch.Tensor, valid: torch.Tensor | None = None,
                   dim: int = -1) -> torch.Tensor:
    """Softmax in (at least) fp32 with an optional boolean key-validity mask.

    Invalid positions get zero probability; rows with no valid position
    return all-zeros instead of NaN.
    """
    dtype = scores.dtype
    ad = acc_dtype(dtype)
    s = scores.to(ad)
    if valid is not None:
        s = torch.where(valid, s, torch.full_like(s, float("-inf")))
    m = s.amax(dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - m)
    denom = e.sum(dim=dim, keepdim=True)
    out = e / denom.clamp_min(torch.finfo(ad).tiny)
    return out.to(dtype)
