"""Resizers on NHWC maps.

pixel_(un)shuffle follow torch.nn.PixelShuffle/PixelUnshuffle channel order
(the reference's Downsample/Upsample, turtle_arch.py:139-157).

upsample_bilinear / resize_bicubic reproduce torch.nn.functional.interpolate
(align_corners=False, no antialias; bicubic a = -0.75, which is also
cv2.INTER_CUBIC of the SR dataset's /4 input synthesis) as two separable
dense (out, in) matrices built in float64 numpy: half-pixel centres, taps
replicated at the border. The products run in the accumulation type and the
result is rounded to the map's type once. These are plain tensor products on
the card, as they are plain XLA in the JAX package (no kernel).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from turtlevsr_tpu_torch.ops.attn_utils import acc_dtype


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


def _linear_kernel(t: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(t))


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys' cubic convolution kernel; torch and cv2 use a = -0.75."""
    t = np.abs(t)
    t2, t3 = t * t, t * t * t
    return np.where(
        t <= 1.0, (a + 2.0) * t3 - (a + 3.0) * t2 + 1.0,
        np.where(t < 2.0, a * t3 - 5.0 * a * t2 + 8.0 * a * t - 4.0 * a, 0.0))


@functools.lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int, kind: str) -> np.ndarray:
    """Dense (n_out, n_in) float64 interpolation matrix: half-pixel
    convention, border-replicated taps, no antialias."""
    if kind == "linear":
        taps, kern, first = 2, _linear_kernel, 0.0
    elif kind == "cubic":
        taps, kern, first = 4, _cubic_kernel, -1.0
    else:
        raise ValueError(f"unknown kind {kind!r}")
    dst = np.arange(n_out, dtype=np.float64)
    src = (dst + 0.5) * (n_in / n_out) - 0.5
    idx = (np.floor(src) + first)[:, None] + np.arange(taps)[None, :]
    w = kern(src[:, None] - idx)
    w = w / w.sum(axis=1, keepdims=True)
    idx = np.clip(idx, 0, n_in - 1).astype(np.int64)
    mat = np.zeros((n_out, n_in), dtype=np.float64)
    for t in range(taps):
        np.add.at(mat, (dst.astype(np.int64), idx[:, t]), w[:, t])
    return mat


def _resize_separable(x: torch.Tensor, out_h: int, out_w: int,
                      kind: str) -> torch.Tensor:
    _, h, w, _ = x.shape
    ad = acc_dtype(x.dtype)
    mh = torch.from_numpy(_resize_matrix(h, out_h, kind)).to(x.device, ad)
    mw = torch.from_numpy(_resize_matrix(w, out_w, kind)).to(x.device, ad)
    y = torch.einsum("Oh,bhwc->bOwc", mh, x.to(ad))
    y = torch.einsum("Ow,bhwc->bhOc", mw, y)
    return y.to(x.dtype)


def upsample_bilinear(x: torch.Tensor, scale: int) -> torch.Tensor:
    """torch.nn.Upsample(scale_factor=scale, mode='bilinear',
    align_corners=False) on NHWC (turtlesuper_t1_arch.py:975-977)."""
    _, h, w, _ = x.shape
    return _resize_separable(x, h * scale, w * scale, "linear")


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """F.interpolate(mode='bicubic', align_corners=False) on NHWC: the SR
    input's /4 downsample (inference.py:214-220)."""
    return _resize_separable(x, out_h, out_w, "cubic")
