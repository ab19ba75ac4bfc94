"""The SAB lattice permutation between a map and its window tokens.

The reference's windowing puts the window factor outermost in the pixel
index: token (i, j) of the (hh, ww) = (H / ws, W / ws) grid gathers the ws^2
pixels {(a * hh + i, b * ww + j)}, a strided lattice over the whole image,
with feature order (a, b, c). ``lattice_split`` turns a map (N, H, W, C) into
tokens (N, hh * ww, ws * ws * C); ``lattice_merge`` is its inverse. On a CUDA
tensor both launch the copy kernel of ``csrc/lattice.cu`` (or raise); on a
CPU tensor, and only there, they run the plain version beside them (a 6-D
transpose). The two permutations are mutual inverses, so the gradient of
each is the other: :class:`LatticeSplit` and :class:`LatticeMerge` run one
wrapper forward and the other backward (on the card, each kernel is the
other's backward kernel), as the JAX package's ``lattice_split_op`` and
``lattice_merge_op`` do."""

from __future__ import annotations

import torch

from turtlevsr_tpu_torch.kernels import build
from turtlevsr_tpu_torch.kernels.ffn import (
    _KERNEL_DTYPES,
    _check,
    _need_cuda,
    _stream,
)


def lattice_split_plain(x: torch.Tensor, ws: int) -> torch.Tensor:
    """Plain version of :func:`lattice_split`."""
    n, h, w, c = x.shape
    hh, ww = h // ws, w // ws
    t = x.reshape(n, ws, hh, ws, ww, c).permute(0, 2, 4, 1, 3, 5)
    return t.reshape(n, hh * ww, ws * ws * c)


def lattice_merge_plain(t: torch.Tensor, ws: int, h: int,
                        w: int) -> torch.Tensor:
    """Plain version of :func:`lattice_merge`."""
    n, hw, d = t.shape
    hh, ww = h // ws, w // ws
    c = d // (ws * ws)
    x = t.reshape(n, hh, ww, ws, ws, c).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(n, h, w, c)


def _check_grid(h: int, w: int, ws: int):
    if ws < 1 or h % ws or w % ws:
        raise ValueError(f"the window {ws} must divide the map {h} x {w}")


def _launch(src: torch.Tensor, out_shape, n, hh, ww, ws, c, merge: bool):
    what = "lattice_merge" if merge else "lattice_split"
    if src.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{what}: the kernel takes bfloat16 or float32, "
                         f"got {src.dtype}")
    if (c * src.element_size()) % 16:
        raise ValueError(f"{what}: a pixel's channels must fill 16-byte "
                         f"pieces (C a multiple of 8), got C={c}")
    out = torch.empty(out_shape, dtype=src.dtype, device=src.device)
    rc = build.load("lattice").turtle_lattice_launch(
        _check("input", src, src), out.data_ptr(), n, hh, ww, ws,
        c * src.element_size() // 16, int(merge), _stream(src))
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with code {rc} "
                           "(-1: shape not taken; else a CUDA error)")
    return out


def lattice_split(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(N, H, W, C) map -> (N, hh * ww, ws * ws * C) window tokens.

    Replaces ``lattice_split_op`` in turtlevsr_tpu/kernels/lattice.py
    (kernel: csrc/lattice.cu; a pure copy, bound by bytes)."""
    if x.dim() != 4:
        raise ValueError("lattice_split takes a (N, H, W, C) map")
    n, h, w, c = x.shape
    _check_grid(h, w, ws)
    if x.device.type == "cpu":
        return lattice_split_plain(x, ws)
    _need_cuda("lattice_split", x)
    hh, ww = h // ws, w // ws
    out = _launch(x, (n, hh * ww, ws * ws * c), n, hh, ww, ws, c, False)
    lattice_split.launches += 1
    return out


lattice_split.launches = 0


def lattice_merge(t: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(N, hh * ww, ws * ws * C) window tokens -> (N, H, W, C) map.

    Replaces ``lattice_merge_op`` in turtlevsr_tpu/kernels/lattice.py
    (kernel: csrc/lattice.cu; a pure copy, bound by bytes)."""
    _check_grid(h, w, ws)
    hh, ww = h // ws, w // ws
    if t.dim() != 3 or t.shape[1] != hh * ww or t.shape[2] % (ws * ws):
        raise ValueError(f"lattice_merge takes (N, {hh * ww}, ws*ws*C) "
                         f"tokens, got {tuple(t.shape)}")
    if t.device.type == "cpu":
        return lattice_merge_plain(t, ws, h, w)
    _need_cuda("lattice_merge", t)
    n, c = t.shape[0], t.shape[2] // (ws * ws)
    out = _launch(t, (n, h, w, c), n, hh, ww, ws, c, True)
    lattice_merge.launches += 1
    return out


lattice_merge.launches = 0


class LatticeSplit(torch.autograd.Function):
    """:func:`lattice_split` whose backward is :func:`lattice_merge`."""

    @staticmethod
    def forward(ctx, x, ws: int):
        ctx.ws, ctx.hw = ws, tuple(x.shape[1:3])
        return lattice_split(x, ws)

    @staticmethod
    def backward(ctx, g):
        # the wrappers take contiguous inputs only
        return lattice_merge(g.contiguous(), ctx.ws, *ctx.hw), None


class LatticeMerge(torch.autograd.Function):
    """:func:`lattice_merge` whose backward is :func:`lattice_split`."""

    @staticmethod
    def forward(ctx, t, ws: int, h: int, w: int):
        ctx.ws = ws
        return lattice_merge(t, ws, h, w)

    @staticmethod
    def backward(ctx, g):
        return lattice_split(g.contiguous(), ctx.ws), None, None, None
