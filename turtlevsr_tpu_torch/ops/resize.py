"""Space<->depth resizers in torch.nn.PixelShuffle/PixelUnshuffle channel
order (the reference's Downsample/Upsample, turtle_arch.py:139-157) on NHWC
maps. The bilinear/bicubic resizers of the SR variant are not ported yet."""

from __future__ import annotations

import torch


def pixel_unshuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """NHWC equivalent of torch.nn.PixelUnshuffle(r):
    out[..., c*r*r + i*r + j] = in[h*r+i, w*r+j, c]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # b, H, W, c, i, j
    return x.reshape(b, h // r, w // r, c * r * r)


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """NHWC equivalent of torch.nn.PixelShuffle(r)."""
    b, h, w, c = x.shape
    co = c // (r * r)
    x = x.reshape(b, h, w, co, r, r)
    x = x.permute(0, 1, 4, 2, 5, 3)  # b, h, i, w, j, co
    return x.reshape(b, h * r, w * r, co)
