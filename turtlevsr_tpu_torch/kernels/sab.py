"""Attention probabilities of the StateAlignBlock (t1): scores, top-5, local
mask, clipped softmax and frame validity.

``sab_attn_probs`` launches the kernel of ``csrc/sab.cu`` on CUDA tensors (or
raises); on CPU tensors, and only there, it runs the plain version beside it.
The plain version rounds where the kernel rounds (the scores, to the map's
type, before the selection) and computes its rows in the accumulation type.
"""

from __future__ import annotations

import torch

from turtlevsr_tpu_torch.kernels import build
from turtlevsr_tpu_torch.kernels.ffn import (
    _KERNEL_DTYPES,
    _SMEM_LIMIT,
    _call,
    _check,
    _need_cuda,
)
from turtlevsr_tpu_torch.ops.attn_utils import (
    acc_dtype,
    clipped_softmax,
    local_window_mask,
    topk_keep,
)

K_TOP_MAX = 5  # KTOP_MAX of csrc/sab.cu
_PLAIN_ROWS = 1024  # query rows the plain version handles at a time


def sab_attn_probs_plain(q, k, temp, fvalid=None, *, grid_wq: int,
                         k_top: int = 5, n_local: int = 4):
    """Plain version of :func:`sab_attn_probs`, a block of query rows at a
    time (the fp32 rows of a whole frame at once would be several times the
    output)."""
    dt = q.dtype
    ad = acc_dtype(dt)
    b, hw, d = q.shape
    nf = k.shape[1]
    hq = hw // grid_wq
    tmp = temp.to(ad).reshape(())
    fv = None if fvalid is None else fvalid.to(ad).reshape(1, nf, 1, 1)
    ka = k.to(ad)
    out = torch.empty((b, nf, hw, hw), dtype=dt, device=q.device)
    for r0 in range(0, hw, _PLAIN_ROWS):
        rows = slice(r0, min(r0 + _PLAIN_ROWS, hw))
        s = torch.einsum("bqd,bnkd->bnqk", q[:, rows].to(ad), ka) * tmp
        s = s.to(dt).to(ad)  # the scores as the map's type holds them
        local = local_window_mask(hq, grid_wq, n_local, ad, q.device, rows)
        p = clipped_softmax(topk_keep(s, k_top) + s * local)
        out[:, :, rows] = (p if fv is None else p * fv).to(dt)
    return out


def _pick_rows(hw: int, d: int, is_bf16: bool, lib) -> int:
    """Query rows per block: 16, or 8 where the row buffer of 16 does not
    fit the block's shared memory."""
    need = 0
    for r in (16, 8):
        need = lib.turtle_sab_smem(hw, d, r, int(is_bf16))
        if need <= _SMEM_LIMIT:
            return r
    raise ValueError(
        f"sab_attn_probs: {hw} keys of width {d} need {need} bytes of "
        f"shared memory for 8 query rows, the card gives a block "
        f"{_SMEM_LIMIT}")


def _launch(q, k, temp, fvalid, grid_wq, k_top, n_local):
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError("sab_attn_probs: the kernel takes bfloat16 or "
                         f"float32, got {q.dtype}")
    b, hw, d = q.shape
    nf = k.shape[1]
    if d % 16:
        raise ValueError(f"sab_attn_probs: D must be a multiple of 16, got "
                         f"{d}")
    if not 1 <= k_top <= K_TOP_MAX:
        raise ValueError(f"sab_attn_probs: k_top must be 1..{K_TOP_MAX}")
    lib = build.load("sab")
    rows = _pick_rows(hw, d, q.dtype == torch.bfloat16, lib)
    out = torch.empty((b, nf, hw, hw), dtype=q.dtype, device=q.device)
    temp32 = temp.detach().to(device=q.device,
                              dtype=torch.float32).reshape(1).contiguous()
    fv32 = None if fvalid is None else fvalid.to(
        device=q.device, dtype=torch.float32).reshape(nf).contiguous()
    ptrs = [_check("q", q, q), _check("k", k, q, (b, nf, hw, d)),
            temp32.data_ptr(), None if fv32 is None else fv32.data_ptr(),
            out.data_ptr()]
    _call(lib.turtle_sab_launch, ptrs,
          [b, nf, hw, d, grid_wq, k_top, n_local, rows], q, "sab_attn_probs")
    sab_attn_probs.launches += 1
    return out


def sab_attn_probs(q, k, temp, fvalid=None, *, grid_wq: int, k_top: int = 5,
                   n_local: int = 4):
    """q (B, HW, D) and k (B, NF, HW, D), both l2-normalised, k as the ring
    stores it; temp: the temperature (any tensor of one element); fvalid:
    optional (NF,) validity of each frame; grid_wq: width of the (hq, wq)
    token grid that queries and keys share. Returns (B, NF, HW, HW)
    probabilities in q's type:

      s    = round_to_q_type((q . k^T) * temp)
      keep = the k_top largest entries of a row, first occurrence on ties
      comb = s * keep + s * local      (L1 grid distance <= n_local; an entry
                                        in both counts twice)
      out  = softmax over the nonzero entries of comb (zeros elsewhere, a row
             with nothing left gives zeros) * fvalid[frame]

    Replaces ``sab_fused_attn_probs`` in turtlevsr_tpu/kernels/sab.py
    (kernel: csrc/sab.cu; bound by operations at D >= 256, by bytes at
    D = 128)."""
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError("sab_attn_probs takes q (B, HW, D), k (B, NF, HW, D)")
    if grid_wq <= 0 or q.shape[1] % grid_wq:
        raise ValueError(f"grid_wq={grid_wq} must divide the {q.shape[1]} "
                         "query tokens")
    if q.shape[1] != k.shape[2]:
        # the local mask places queries and keys on one (hq, wq) grid
        raise ValueError(f"query/key token grids differ ({q.shape[1]} vs "
                         f"{k.shape[2]}); the local mask assumes one grid")
    if q.device.type == "cpu":
        return sab_attn_probs_plain(q, k, temp, fvalid, grid_wq=grid_wq,
                                    k_top=k_top, n_local=n_local)
    _need_cuda("sab_attn_probs", q)
    return _launch(q, k, temp, fvalid, grid_wq, k_top, n_local)


sab_attn_probs.launches = 0
