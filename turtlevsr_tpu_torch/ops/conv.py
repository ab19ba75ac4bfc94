"""NHWC convolutions with PyTorch-compatible initialisation.

The port keeps the JAX package's layout at its public functions: NHWC
activations and conv weights as the reference's modules hold them (OIHW,
``nn.Conv2d.weight``). These helpers serve the plain versions of the
kernels and the convs that the JAX package leaves to its compiler
(``project_out`` 1x1, ``reduce_chan_level*``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, *, stride: int = 1,
           padding: int = 0, groups: int = 1) -> torch.Tensor:
    """2-D convolution, NHWC activations, OIHW weights (cout, cin // groups,
    kh, kw), computed in x.dtype like ``torch.nn.Conv2d``."""
    kh, kw = weight.shape[2:]
    weight = weight.to(x.dtype)
    if kh == kw == 1 and stride == 1 and padding == 0 and groups == 1:
        # 1x1 conv as a flat matmul: no layout change at all in NHWC
        y = x @ weight[:, :, 0, 0].t()
    else:
        y = F.conv2d(x.permute(0, 3, 1, 2), weight, None, stride=stride,
                     padding=padding, groups=groups).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def conv_init(conv: torch.nn.Conv2d, generator: torch.Generator) -> None:
    """``torch.nn.Conv2d.reset_parameters`` statistics from an explicit
    generator: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias,
    fan_in = (cin // groups) * kh * kw."""
    fan_in = conv.weight.shape[1] * conv.weight.shape[2] * conv.weight.shape[3]
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        for p in (conv.weight, conv.bias):
            if p is not None:
                r = torch.rand(p.shape, generator=generator,
                               dtype=torch.float32)
                p.copy_(((2.0 * r - 1.0) * bound).to(p.dtype))
