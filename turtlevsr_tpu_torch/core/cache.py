"""Fixed-shape ring buffers for the truncated causal-history KV cache.

The reference grows each cache slot from ``None`` by concatenation and keeps
the trailing ``num_frames_tocache`` frames (turtle_arch.py:273-288). Here a
slot is preallocated at its maximum size with a count ``n`` of frames ever
appended: the append writes one frame's block at position ``n % N``, and
positions not yet written are masked out of every softmax, which is
numerically identical to the reference's shorter concatenations. Position
order is NOT age order; every consumer (SAB's per-frame attention, FHR's
token softmax) is order-invariant.

Slot layout (the same as the JAX package's ``core/cache.py``):
  FHR slot: k, v of shape (B, heads, N * ctok, L), ctok = dim // heads
  SAB slot (the CHM blocks): k of shape (B, N, HW, 2 * dim), the
            l2-normalised window keys of each cached frame, and v of shape
            (B, N, HW, ws * ws * dim), its projected window values; HW =
            (H / ws) * (W / ws) window tokens, ws = the level's window size;
            in the t0 variant k is a vestigial (B, N, 8, 8) zero buffer,
            never read (see sab_slot_append_v)
  n: int64 scalar tensor on the slot's device (write pointer = n % N;
     min(n, N) positions are valid)

When autograd records (training), an append writes a new buffer instead
(``torch.index_copy``): a later frame's attention saves the ring for its
backward, and BPTT through the clip needs each frame's ring as it was, as
the JAX package's functional cache gives it.
"""

from __future__ import annotations

import torch

from turtlevsr_tpu_torch.kernels.vjp import records


def _ring_write(buf: torch.Tensor, dim: int, idx: torch.Tensor,
                new: torch.Tensor) -> torch.Tensor:
    """buf with ``new`` at positions ``idx`` of ``dim``: in place, or out of
    place when autograd records."""
    new = new.to(buf.dtype)
    if records(buf, new):
        return torch.index_copy(buf, dim, idx, new)
    return buf.index_copy_(dim, idx, new)


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
    new count (when autograd records, it holds new buffers; see the module
    note). The position comes from the device-side count without a host
    read, as one index_copy along the token axis."""
    ctok = k_new.shape[2]
    n_frames = slot["k"].shape[2] // ctok
    ptr = (slot["n"] % n_frames) * ctok
    idx = ptr + torch.arange(ctok, device=ptr.device)
    return {"k": _ring_write(slot["k"], 2, idx, k_new),
            "v": _ring_write(slot["v"], 2, idx, v_new), "n": slot["n"] + 1}


def sab_slot_init(batch: int, n_frames: int, hw_q: int, dk: int, hw_v: int,
                  dv: int, dtype: torch.dtype = torch.float32,
                  device: torch.device | str = "cuda") -> dict:
    return {
        "k": torch.zeros((batch, n_frames, hw_q, dk), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, n_frames, hw_v, dv), dtype=dtype,
                         device=device),
        "n": torch.zeros((), dtype=torch.int64, device=device),
    }


def sab_slot_append(slot: dict, k_new: torch.Tensor,
                    v_new: torch.Tensor) -> dict:
    """Write one frame (k_new, v_new have no frame axis) at the ring
    position. IN PLACE like :func:`fhr_slot_append`: the slot passed in must
    not be used again; the position comes from the device-side count
    without a host read."""
    n_frames = slot["v"].shape[1]
    idx = (slot["n"] % n_frames).reshape(1)
    return {"k": _ring_write(slot["k"], 1, idx, k_new[:, None]),
            "v": _ring_write(slot["v"], 1, idx, v_new[:, None]),
            "n": slot["n"] + 1}


def sab_slot_append_v(slot: dict, v_new: torch.Tensor) -> dict:
    """Write one frame's V only, leaving the K field as it is: the t0 SAB
    discards its attention scores (``out = v``, turtle_arch.py:523, quirk Q1
    of SURVEY.md), so its K ring would only feed the next frame's equally
    dead attention; the t0 slot keeps a vestigial (B, NF, 8, 8) zero K
    field. IN PLACE like :func:`sab_slot_append`."""
    n_frames = slot["v"].shape[1]
    idx = (slot["n"] % n_frames).reshape(1)
    return {"k": slot["k"], "v": _ring_write(slot["v"], 1, idx,
                                             v_new[:, None]),
            "n": slot["n"] + 1}


def frame_valid_mask(n: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(n_frames,) bool: ring position i holds a real frame iff i < n."""
    return torch.arange(n_frames, device=n.device) < n


def token_valid_mask(n: torch.Tensor, n_frames: int,
                     block: int) -> torch.Tensor:
    """(n_frames * block,) bool — validity of per-frame token blocks."""
    idx = torch.arange(n_frames * block, device=n.device)
    return (idx // block) < n
