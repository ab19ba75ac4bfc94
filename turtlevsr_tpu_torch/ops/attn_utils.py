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


_NORM_EPS = 1e-12  # torch.nn.functional.normalize default clamp


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """torch F.normalize(p=2): x / max(||x||, 1e-12). The sum of squares
    runs in the accumulation type, the scaling in x's type; zero rows (empty
    cache frames) stay zero, with finite gradients (the sqrt never sees a
    zero, whose derivative would give 0 * inf = NaN)."""
    ad = acc_dtype(x.dtype)
    ss = x.to(ad).square().sum(dim=dim, keepdim=True)
    nonzero = ss > 0
    n = torch.sqrt(torch.where(nonzero, ss, torch.ones_like(ss)))
    n = torch.where(nonzero, n, torch.zeros_like(n))
    inv = (1.0 / n.clamp_min(_NORM_EPS)).to(x.dtype)
    return x * inv


def clipped_softmax(combined: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax over the entries that are not exactly zero, zeros elsewhere
    (turtle_arch.py:115-135); a row of zeros gives zeros, not NaN."""
    return masked_softmax(combined, valid=combined != 0, dim=dim)


def topk_keep(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Zero out everything but the top-k entries of the last axis
    (turtle_t1_arch.py:327-332), as k rounds of a running maximum. Ties:
    each round keeps the FIRST occurrence of its maximum, so k distinct
    positions survive."""
    n = scores.shape[-1]
    k = min(k, n)
    idx = torch.arange(n, device=scores.device).expand(scores.shape)
    remaining = scores.clone()
    keep = torch.zeros_like(scores, dtype=torch.bool)
    for _ in range(k):
        m = remaining.amax(dim=-1, keepdim=True)
        first = torch.where(remaining == m, idx, n).amin(dim=-1, keepdim=True)
        hit = idx == first
        keep |= hit
        remaining = remaining.masked_fill(hit, float("-inf"))
    return scores * keep.to(scores.dtype)


def local_window_mask(h: int, w: int, n: int = 4,
                      dtype: torch.dtype = torch.float32,
                      device: torch.device | str = "cpu",
                      rows: slice | None = None) -> torch.Tensor:
    """(h*w, h*w) 0/1 mask: L1 distance <= n between token grid coordinates
    (turtle_arch.py:441-457). ``rows`` restricts it to those query rows."""
    idx = torch.arange(h * w, device=device)
    q = idx if rows is None else idx[rows]
    dy = (q[:, None] // w - idx[None, :] // w).abs()
    dx = (q[:, None] % w - idx[None, :] % w).abs()
    return (dy + dx <= n).to(dtype)
