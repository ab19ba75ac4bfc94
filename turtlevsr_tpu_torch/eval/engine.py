"""Streaming inference engine, whole-frame mode.

Protocol of the reference (inference.py:260-370): frames stream in order;
the causal-history cache is threaded from frame to frame and stays on the
device; the previous frame equals the current one on the first frame. The
tiled sliding-window mode of the JAX package's engine is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from turtlevsr_tpu_torch.models import require_device
from turtlevsr_tpu_torch.models.turtle import Turtle


class InferenceEngine:
    """Stateful streaming restorer for one video.

    Usage:
        eng = InferenceEngine(model)          # on the card, bfloat16
        for frame in frames:                  # HWC float32 [0, 1]
            out = eng.step(frame)             # HWC float32
        eng.reset()                           # before the next video

    The model is moved to ``device`` and cast to ``dtype`` in place.
    """

    def __init__(self, model: Turtle, *, mode: str = "whole",
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cuda"):
        if mode == "tiled":
            raise NotImplementedError(
                "not ported yet: tiled sliding-window inference")
        if mode != "whole":
            raise ValueError(f"unknown mode {mode!r}")
        self.device = require_device(device)
        self.dtype = dtype
        self.mode = mode
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
        cur = torch.as_tensor(np.ascontiguousarray(frame)).to(
            device=self.device, dtype=self.dtype)[None]  # (1, H, W, C)
        prev = cur if self._prev is None else self._prev
        with torch.inference_mode():
            if self._cache is None:
                self._cache = self.model.init_cache(1, h, w, self.dtype)
            out, self._cache = self.model(torch.stack([prev, cur], dim=1),
                                          self._cache)
        self._prev = cur
        return out[0]
