"""A run of cacheless Channel + gated-FFN blocks over one map in one launch.

``fused_channel_gffw_run`` launches the cooperative kernel of
``csrc/level.cu`` on CUDA tensors (or raises); on CPU tensors, and only
there, it runs the plain version beside it: a loop over the blocks' plain
route (statistics, the small softmax, the FFN pass). ``channel_gffw_run_split``
is the same loop through the split kernels (``fused_qkv_stats`` and
``fused_block_ffn``), the route a model without the ``channel_runs`` plan
takes block by block; the run kernel is held against it on the card.

A block of a run is a dict of kernel-layout, bias-free weights:

  ln1_w, ln1_b?   (C,)           norm1
  w_qkv, wd_qkv   (C, 3C), (3, 3, 3C)   q | k | v side by side
  temp            (heads,)       the attention's temperature
  wpo             (C, C)         project_out as a (C_in, C_out) matrix
  ln2_w, ln2_b?   (C,)           norm2
  w1, wd, w2      (C, 2E), (3, 3, 2E), (E, C)   the gated FFN
"""

from __future__ import annotations

import torch

from turtlevsr_tpu_torch.kernels import build
from turtlevsr_tpu_torch.kernels.ffn import (
    _call,
    _check,
    _check_map,
    _check_smem,
    _check_width,
    _need_cuda,
    _tiles,
    ffn_plain,
    fused_block_ffn,
    fused_qkv_stats,
    qkv_stats_plain,
)
from turtlevsr_tpu_torch.ops.attn_utils import acc_dtype, masked_softmax

_NORM_EPS = 1e-12  # torch.nn.functional.normalize default clamp
MAX_RUN = 10  # MAX_RUN of csrc/level.cu: blocks of a run per launch
_BLOCK_KEYS = ("ln1_w", "ln1_b", "w_qkv", "wd_qkv", "temp", "wpo", "ln2_w",
               "ln2_b", "w1", "wd", "w2")


def safe_norms(ss: torch.Tensor) -> torch.Tensor:
    """max(sqrt(ss), 1e-12): zero rows (nothing to normalise) stay finite."""
    return torch.sqrt(ss).clamp_min(_NORM_EPS)


def channel_po(gram, stats, temp, wpo, heads: int, dtype) -> torch.Tensor:
    """The per-batch matrix po' = blockdiag(attn^T) @ W_po of a cacheless
    channel-attention block, so that out @ W_po = v @ po'. gram (B, heads,
    ctok, ctok) = q_h^T k_h and stats (B, 2, C) = [sum q^2, sum k^2] come
    from the statistics pass; temp holds one temperature per head; wpo is
    (C_in, C_out). The softmax and po' are rounded to ``dtype``."""
    b = gram.shape[0]
    ctok = gram.shape[-1]
    c = heads * ctok
    ad = acc_dtype(dtype)
    nq = safe_norms(stats[:, 0].to(ad)).reshape(b, heads, ctok)
    nk = safe_norms(stats[:, 1].to(ad)).reshape(b, heads, ctok)
    scores = gram.to(ad) / (nq[..., None] * nk[..., None, :])
    attn = masked_softmax(scores * temp.to(ad).reshape(1, heads, 1, 1)).to(dtype)
    po_w = torch.einsum("bhcd,hce->bhde", attn.to(ad),
                        wpo.reshape(heads, ctok, c).to(ad))
    return po_w.reshape(b, c, c).to(dtype).contiguous()


def _run(x, blocks, heads, stats_fn, ffn_fn):
    for blk in blocks:
        v_map, gram, stats = stats_fn(
            x, ln_w=blk["ln1_w"], ln_b=blk.get("ln1_b"), w1=blk["w_qkv"],
            wd=blk["wd_qkv"], heads=heads)
        po_w = channel_po(gram, stats, blk["temp"], blk["wpo"], heads, x.dtype)
        x = ffn_fn(x, x2=v_map, po_w=po_w, ln_w=blk["ln2_w"],
                   ln_b=blk.get("ln2_b"), w1=blk["w1"], wd=blk["wd"],
                   w2=blk["w2"], mode="gate")
    return x


def channel_gffw_run_plain(x, blocks, heads: int):
    """Plain version of :func:`fused_channel_gffw_run`."""
    return _run(x, blocks, heads, qkv_stats_plain, ffn_plain)


def channel_gffw_run_split(x, blocks, heads: int):
    """The same run through the split kernels, two launches per block."""
    return _run(x, blocks, heads, fused_qkv_stats, fused_block_ffn)


def _launch(x, blocks, heads):
    _check_map("x", x)
    _check_width("fused_channel_gffw_run", x)
    b, h, w, c = x.shape
    if c % heads or c // heads > 64:
        raise ValueError("fused_channel_gffw_run takes C / heads <= 64, got "
                         f"C={c}, heads={heads}")
    if h * w * c >= 2 ** 31:
        raise ValueError("fused_channel_gffw_run: a map of one batch entry "
                         "must hold fewer than 2^31 elements")
    e, ch = blocks[0]["w2"].shape[0], blocks[0]["w1"].shape[1]
    if ch != 2 * e:
        raise ValueError(f"w1 must be (C, 2E) and w2 (E, C), got {ch}, {e}")
    shapes = dict(ln1_w=(c,), ln1_b=(c,), w_qkv=(c, 3 * c),
                  wd_qkv=(3, 3, 3 * c), temp=(heads,), wpo=(c, c), ln2_w=(c,),
                  ln2_b=(c,), w1=(c, ch), wd=(3, 3, ch), w2=(e, c))
    ctok = c // heads
    width = heads * ctok * ctok + 2 * c
    lib = build.load("level")
    _check_smem("fused_channel_gffw_run", lib.turtle_level_smem(
        c, heads, int(x.dtype == torch.bfloat16)))
    new = lambda *shape, dtype=x.dtype: torch.empty(  # noqa: E731
        shape, dtype=dtype, device=x.device)
    v, po = new(b, h, w, c), new(b, c, c)
    part = new(b, _tiles(h, w), width, dtype=torch.float32)
    tot = new(b, width, dtype=torch.float32)
    with torch.cuda.device(x.device):
        for i0 in range(0, len(blocks), MAX_RUN):
            run = blocks[i0:i0 + MAX_RUN]
            out = new(b, h, w, c)
            tmp = new(b, h, w, c) if len(run) > 1 else out
            ptrs = [_check("x", x, x), out.data_ptr(), tmp.data_ptr(),
                    v.data_ptr(), part.data_ptr(), tot.data_ptr(),
                    po.data_ptr()]
            for j, blk in enumerate(run):
                ptrs += [_check(f"blocks[{i0 + j}].{k}", blk.get(k), x,
                                shapes[k]) for k in _BLOCK_KEYS]
            ptrs += [None] * (len(_BLOCK_KEYS) * (MAX_RUN - len(run)))
            _call(lib.turtle_level_launch, ptrs,
                  [b, h, w, c, ch, e, heads, len(run)], x,
                  "fused_channel_gffw_run")
            fused_channel_gffw_run.launches += 1
            x = out
    return x


def fused_channel_gffw_run(x, blocks, heads: int):
    """``len(blocks)`` cacheless Channel + gated-FFN blocks over the map x
    (B, H, W, C) in one launch (one per 10 blocks); per block

      q, k, v = dw3x3(pw1(LN1 x));  attn_h = softmax(temp_h q_h^T k_h / norms)
      x' = x + v @ (blockdiag(attn)^T W_po);  x = x' + gate-FFN(LN2 x')

    ``blocks``: the dicts of the module note (no conv biases). The
    cooperative grid is sized by the occupancy, so that every thread block
    is resident at once.

    Replaces ``fused_channel_gffw_run`` in turtlevsr_tpu/kernels/level.py
    (kernel: csrc/level.cu; bound by operations like the statistics and FFN
    kernels whose device code it shares)."""
    if not blocks:
        raise ValueError("fused_channel_gffw_run needs at least one block")
    if x.device.type == "cpu":
        return channel_gffw_run_plain(x, blocks, heads)
    _need_cuda("fused_channel_gffw_run", x)
    return _launch(x, list(blocks), heads)


fused_channel_gffw_run.launches = 0
