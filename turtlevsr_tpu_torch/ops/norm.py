"""Channel LayerNorm over NHWC tensors.

Semantics of the reference (turtle_arch.py:61-112):
  * variance is biased,
  * eps = 1e-5 added inside the sqrt,
  * the "BiasFree" variant divides by sqrt(var) but does NOT subtract the
    mean from the numerator.
Statistics are computed in at least float32 regardless of activation dtype.
"""

from __future__ import annotations

import torch

from turtlevsr_tpu_torch.ops.attn_utils import acc_dtype

LN_EPS = 1e-5


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    dtype = x.dtype
    ad = acc_dtype(dtype)
    xf = x.to(ad)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    inv = 1.0 / torch.sqrt(var + LN_EPS)
    if bias is None:
        y = xf * inv * weight.to(ad)
    else:
        y = (xf - mu) * inv * weight.to(ad) + bias.to(ad)
    return y.to(dtype)
