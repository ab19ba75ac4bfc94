"""Fixed-shape ring buffers for the truncated causal-history KV cache.

The reference grows each cache slot from ``None`` by concatenation and keeps
the trailing ``num_frames_tocache`` frames (turtle_arch.py:273-288). Here a
slot is preallocated at its maximum size with a count ``n`` of frames ever
appended: the append writes one frame's block at position ``n % N``, and
positions not yet written are masked out of every softmax, which is
numerically identical to the reference's shorter concatenations. Position
order is NOT age order; FHR's token softmax is order-invariant.

Slot layout (the same as the JAX package's ``core/cache.py``):
  FHR slot: k, v of shape (B, heads, N * ctok, L), ctok = dim // heads
  n: int64 scalar tensor on the slot's device (write pointer = n % N;
     min(n, N) positions are valid)
Only the FHR slots are ported; the SAB slots belong to the CHM blocks.
"""

from __future__ import annotations

import torch


def fhr_slot_init(batch: int, heads: int, n_frames: int, ctok: int, l: int,
                  dtype: torch.dtype = torch.float32,
                  device: torch.device | str = "cuda") -> dict:
    shape = (batch, heads, n_frames * ctok, l)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "n": torch.zeros((), dtype=torch.int64, device=device),
    }


def fhr_slot_append(slot: dict, k_new: torch.Tensor,
                    v_new: torch.Tensor) -> dict:
    """Write one frame's ctok token block at the ring position.

    IN PLACE: the slot's ``k`` and ``v`` buffers are overwritten at the
    ring position (a copy of the multi-hundred-MB cache per frame would cost
    more than the attention that reads it), so the slot passed in must not
    be used again. The returned dict shares those buffers and carries the
    new count. The position comes from the device-side count without a host
    read, as one index_copy_ along the token axis."""
    ctok = k_new.shape[2]
    n_frames = slot["k"].shape[2] // ctok
    ptr = (slot["n"] % n_frames) * ctok
    idx = ptr + torch.arange(ctok, device=ptr.device)
    slot["k"].index_copy_(2, idx, k_new.to(slot["k"].dtype))
    slot["v"].index_copy_(2, idx, v_new.to(slot["v"].dtype))
    return {"k": slot["k"], "v": slot["v"], "n": slot["n"] + 1}


def token_valid_mask(n: torch.Tensor, n_frames: int,
                     block: int) -> torch.Tensor:
    """(n_frames * block,) bool — validity of per-frame token blocks."""
    idx = torch.arange(n_frames * block, device=n.device)
    return (idx // block) < n
