"""Streaming inference engine: whole-frame and tiled sliding-window modes.

Protocol of the reference (inference.py:172-246 run_inference_patched,
:260-370 run_inference): frames stream in order; the causal-history cache is
threaded from frame to frame and stays on the device; the previous frame
equals the current one on the first frame. Tiled mode pads H, W to multiples
of 8 (reflect), slides a ``tile``-sized window with stride ``tile - overlap``
(the last window snapped to the border), keeps a cache PER TILE, overlap-adds
the outputs in float32, divides by the coverage count, clamps to [0, 1] and
crops.

Like the JAX package's engine, and unlike the reference's python loop over
tiles with its cache round trips through the host, the tile grid rides the
batch axis of the model: one batched call per chunk of at most
``max_tile_batch`` tiles, all caches resident on the device. A chunk works
on views ``[a:b]`` of the per-tile caches, which the model writes in place;
the ring count of a slot is one scalar for all tiles and advances once per
frame. The last chunk may be short (no padded tiles are computed). Not
ported: data parallelism over a mesh, and the SR variant's resize (the model
itself raises "not ported yet" for that variant).
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from turtlevsr_tpu_torch.models import require_device
from turtlevsr_tpu_torch.models.turtle import Turtle


def _pad8(h: int, w: int) -> Tuple[int, int]:
    """inference.py:186-188 round-up-to-8 (pads only if not divisible)."""
    hp = ((h + 8) // 8) * 8 if h % 8 else h
    wp = ((w + 8) // 8) * 8 if w % 8 else w
    return hp, wp


def _tile_grid(size: int, tile: int, stride: int) -> list:
    """inference.py:200-201: range(0, size - tile, stride) + [size - tile]."""
    return list(range(0, size - tile, stride)) + [size - tile]


class VideoFrames:
    """Sorted frame-folder reader -> float32 RGB in [0, 1], HWC."""

    def __init__(self, folder: str, pattern: str = "*.*"):
        self.files = sorted(glob.glob(os.path.join(folder, pattern)))
        if not self.files:
            raise FileNotFoundError(f"no frames in {folder}")

    def __len__(self):
        return len(self.files)

    def __iter__(self) -> Iterator[np.ndarray]:
        from PIL import Image

        for f in self.files:
            yield np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0


def _slot_views(slot, a: int, b: int):
    """Tiles [a, b) of a cache slot: views of k and v, the shared count."""
    if slot is None:
        return None
    return {"k": slot["k"][a:b], "v": slot["v"][a:b], "n": slot["n"]}


class InferenceEngine:
    """Stateful streaming restorer for one video.

    Usage:
        eng = InferenceEngine(model)          # on the card, bfloat16
        eng = InferenceEngine(model, mode="tiled", tile=320,
                              tile_overlap=192)
        for frame in frames:                  # HWC float32 [0, 1]
            out = eng.step(frame)             # HWC float32
        eng.reset()                           # before the next video

    The model is moved to ``device`` and cast to ``dtype`` in place.
    max_tile_batch: tiled mode runs the grid in chunks of at most this many
    tiles (720p at tile 320 / overlap 192 is 45 tiles), which bounds the
    activations of one model call.
    """

    def __init__(self, model: Turtle, *, mode: str = "whole",
                 tile: int = 320, tile_overlap: int = 128,
                 max_tile_batch: int = 15,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cuda"):
        if mode not in ("whole", "tiled"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "tiled" and (tile <= 0 or not 0 <= tile_overlap < tile
                                or max_tile_batch < 1):
            raise ValueError(
                f"tiled mode needs 0 <= tile_overlap < tile and "
                f"max_tile_batch >= 1, got tile={tile}, "
                f"tile_overlap={tile_overlap}, "
                f"max_tile_batch={max_tile_batch}")
        self.device = require_device(device)
        self.dtype = dtype
        self.mode = mode
        self.tile = tile
        self.tile_overlap = tile_overlap
        self.max_tile_batch = max_tile_batch
        self.model = model.to(device=self.device, dtype=dtype).eval()
        self.cfg = model.cfg
        self._cache = None
        self._prev = None
        self._shape = None

    def reset(self) -> None:
        self._cache = None
        self._prev = None

    def step(self, frame: np.ndarray) -> np.ndarray:
        """Restore one HWC [0, 1] frame, advancing the causal history."""
        return self.step_async(frame).float().cpu().numpy()

    def step_async(self, frame: np.ndarray) -> torch.Tensor:
        """Like :meth:`step`, but returns the device tensor (H, W, C, engine
        dtype) without a host synchronisation: the work is queued on the
        current stream, and fetching the tensor waits for it."""
        h, w, _ = frame.shape
        if self._shape != (h, w):
            self._shape = (h, w)
            self.reset()
        cur = torch.as_tensor(np.ascontiguousarray(frame))
        if self.device.type == "cuda":
            # from pinned memory the copy is queued like a kernel; a copy
            # from pageable memory would wait for the previous frame's work
            cur = cur.pin_memory().to(self.device, non_blocking=True)
        cur = cur.to(device=self.device, dtype=self.dtype)[None]  # (1, H, W, C)
        prev = cur if self._prev is None else self._prev
        with torch.inference_mode():
            if self.mode == "whole":
                if self._cache is None:
                    self._cache = self.model.init_cache(1, h, w, self.dtype)
                out, self._cache = self.model(torch.stack([prev, cur], dim=1),
                                              self._cache)
            else:
                out = self._step_tiled(prev, cur)
        self._prev = cur
        return out[0]

    # -- tiled mode --------------------------------------------------------
    def tile_plan(self, h: int, w: int):
        """(padded height, padded width, tile side, row offsets, column
        offsets) of the tile grid for frames of (h, w)."""
        hp, wp = _pad8(h, w)
        t = min(self.tile, hp, wp)
        if t % 8:
            raise ValueError("tile size should be a multiple of 8")
        stride = t - self.tile_overlap
        if stride <= 0:
            raise ValueError(f"tile_overlap {self.tile_overlap} leaves no "
                             f"stride for tiles of {t}")
        return hp, wp, t, _tile_grid(hp, t, stride), _tile_grid(wp, t, stride)

    def _step_tiled(self, prev: torch.Tensor, cur: torch.Tensor):
        h, w = cur.shape[1:3]
        hp, wp, t, his, wis = self.tile_plan(h, w)

        def tiles_of(fr):
            fr = fr.permute(0, 3, 1, 2)  # reflect padding wants NCHW
            fr = F.pad(fr, (0, wp - w, 0, hp - h), mode="reflect")[0]
            fr = fr.permute(1, 2, 0)
            return torch.stack([fr[hi:hi + t, wi:wi + t]
                                for hi in his for wi in wis])

        x = torch.stack([tiles_of(prev), tiles_of(cur)], dim=1)
        n_tiles = x.shape[0]
        if self._cache is None:
            self._cache = self.model.init_cache(n_tiles, t, t, self.dtype)
        cache = self._cache
        outs, counts = [], None
        for a in range(0, n_tiles, self.max_tile_batch):
            b = min(a + self.max_tile_batch, n_tiles)
            # the model writes the views in place; every chunk sees the
            # count of the frame's start
            out_c, new_c = self.model(
                x[a:b], tuple(_slot_views(s, a, b) for s in cache))
            outs.append(out_c)
            counts = [None if s is None else s["n"] for s in new_c]
        # the per-tile buffers now hold this frame; the counts advance once
        self._cache = tuple(
            None if s is None else {"k": s["k"], "v": s["v"], "n": n}
            for s, n in zip(cache, counts))
        outs = torch.cat(outs).float()
        e = torch.zeros((hp, wp, cur.shape[-1]), dtype=torch.float32,
                        device=self.device)
        wgt = torch.zeros((hp, wp, 1), dtype=torch.float32,
                          device=self.device)
        k = 0
        for hi in his:
            for wi in wis:
                e[hi:hi + t, wi:wi + t] += outs[k]
                wgt[hi:hi + t, wi:wi + t] += 1.0
                k += 1
        restored = (e / wgt).clamp_(0.0, 1.0)
        return restored[None, :h, :w].to(self.dtype)
