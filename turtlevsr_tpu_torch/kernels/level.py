"""A run of cacheless Channel + gated-FFN blocks over one map in one launch.

``fused_channel_gffw_run`` launches a cooperative kernel on CUDA tensors (or
raises): ``csrc/level_wg.cu``, the Hopper body that runs the wgmma bodies of
rows 3 and 1 as phases of one persistent grid, for the runs its plan takes
(:func:`_level_plan`: every run of the shipped models), else
``csrc/level.cu``; on CPU tensors, and only there, it runs the plain version
beside it: a loop over the blocks' plain route (statistics, the small
softmax, the FFN pass). ``channel_gffw_run_split`` is the same loop through
the split kernels (``fused_qkv_stats`` and ``fused_block_ffn``), the route a
model without the ``channel_runs`` plan takes block by block; the run
kernels are held against it on the card.

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
    _AS,
    _F32,
    _F32_SHARED_HALO_MAX_C,
    _HS,
    _NPH,
    _P,
    _SMEM_LIMIT,
    _TILE,
    _XPAD,
    _call,
    _check,
    _check_map,
    _check_smem,
    _check_width,
    _f32_plan_error,
    _halo_scratch,
    _need_cuda,
    _sm_count,
    _SW_STAGE,
    _SW_TILE,
    _WG_ALIGN,
    _WG_HALO,
    _WG_HS,
    _WG_PIXELS,
    _WG_STAGE,
    _WG_XPAD,
    _sw_geometry,
    _sw_smem,
    _tiles,
    _wg_smem,
    ffn_plain,
    fused_block_ffn,
    fused_qkv_stats,
    qkv_stats_plain,
)
from turtlevsr_tpu_torch.ops.attn_utils import acc_dtype, masked_softmax

_NORM_EPS = 1e-12  # torch.nn.functional.normalize default clamp
MAX_RUN = 10  # blocks of a run per launch (MAX_RUN of csrc/level.cu)
_BLOCK_KEYS = ("ln1_w", "ln1_b", "w_qkv", "wd_qkv", "temp", "wpo", "ln2_w",
               "ln2_b", "w1", "wd", "w2")
# the Hopper body (csrc/level_wg.cu): the widths it takes
_LV_WG_WIDTHS = (128, 256, 512)


def _lv_smem(c: int) -> tuple[int, int, int]:
    """(bytes of shared memory, ring stages of the statistics phase, of the
    FFN phase) of csrc/level_wg.cu at width c: a region that holds either
    phase's ring and tiles (the statistics body's stages and its q and k
    tiles, 2 x 64 x 64 bf16; the FFN body's stages and its 64 x 72 bf16
    activation chunk), the fp32 hidden chunk (100 x 128) and the LN halo
    (100 rows of c + 8 bf16) that both bodies lay out alike, the two rings'
    mbarriers. Each phase keeps its own kernel's stages
    (kernels/ffn.py :func:`_sw_smem`, :func:`_wg_smem`). A card test holds
    it to the source."""
    s_stats, s_ffn = _sw_smem(c, False)[1], _wg_smem(c, True)[1]
    region = max(s_stats * _SW_STAGE + 2 * _SW_TILE,
                 s_ffn * _WG_STAGE + _WG_PIXELS * (64 + _WG_XPAD) * 2)
    smem = (_WG_ALIGN + region + _WG_HALO * _WG_HS * 4
            + _WG_HALO * (c + _WG_XPAD) * 2 + 16 * (s_stats + s_ffn))
    return smem, s_stats, s_ffn


LEVEL_F32_MAX_C = 512  # the widest float32 map csrc/level.cu takes
_SM_SMEM = 233472  # shared memory of one SM of an H100 (228 KB)
_BLOCK_RESERVED = 1024  # of it, reserved by the runtime for each block


def _level_f32_plan(b, h, w, c, heads, n_sm: int = 132):
    """The geometry of one float32 fused_channel_gffw_run launch, on
    csrc/level.cu, mirrored from its dispatch (dispatch_level<float>) and
    level_smem: C a multiple of 16 up to 512, C / heads <= 64; 8 x 8 tiles
    (``items``: B x tiles) walked by a cooperative grid of ``blocks``, the
    blocks that shared memory lets an SM hold (at most 2 up to C = 128, the
    launch bounds' count, else 1) on ``n_sm`` SMs, fewer if the registers
    bind; the LN halo of both tile phases in shared memory up to C = 256,
    else in a device-memory scratch of ``scratch`` float32 elements (one
    slice of 100 x (C + 8) a tile). ``smem``: the larger of the statistics
    tile's, the FFN tile's and the softmax's scratch (``level_smem``).
    Raises ValueError, naming the body and the limit, for a call it does not
    take."""
    name, body = "fused_channel_gffw_run", "csrc/level.cu"
    if c % 16 or not 16 <= c <= LEVEL_F32_MAX_C:
        raise _f32_plan_error(name, body, "maps of C a multiple of 16 up to "
                              f"{LEVEL_F32_MAX_C}", f"C={c}")
    if c % heads or c // heads > 64:
        raise _f32_plan_error(name, body, "C / heads <= 64",
                              f"C={c}, heads={heads}")
    dev = c > _F32_SHARED_HALO_MAX_C
    ctok = c // heads
    halo = _NPH * (c + _XPAD)
    shared_halo = 0 if dev else halo * _F32
    qkv = shared_halo + _NPH * _HS * 4 + 2 * _P * ctok * 4
    ffn = shared_halo + (_P * c + _P * _AS) * _F32 + _NPH * _HS * 4
    smem = max(qkv, ffn, (ctok * ctok + 2 * ctok) * 4)
    if smem > _SMEM_LIMIT:
        raise _f32_plan_error(name, body, f"calls whose shared memory fits "
                              f"{_SMEM_LIMIT} bytes", f"{smem}")
    items = b * _tiles(h, w)
    per_sm = max(1, min(2 if c <= 128 else 1,
                        _SM_SMEM // (smem + _BLOCK_RESERVED)))
    return dict(tile=_TILE, items=items, blocks=min(items, n_sm * per_sm),
                halo="device" if dev else "shared",
                scratch=items * halo if dev else 0, smem=smem)


def _level_plan(b, h, w, c, heads, e, ch, dtype, ln_b, n_sm: int = 132):
    """The body of one fused_channel_gffw_run launch, chosen by its shape:
    ("wg", geometry) for csrc/level_wg.cu (bf16, C = 128, 256 or 512, 64
    channels a head, E a multiple of 32 with w1 (C, 2E), and each LayerNorm
    with a bias in every block or in none: ``ln_b`` is the set of the
    blocks' (ln1_b present, ln2_b present) pairs), else ("tile", None) for
    csrc/level.cu (float32, other widths, head sizes or hidden widths, runs
    that mix the LayerNorm forms). A run carries no conv biases: its dicts
    have no such keys. The geometry is that of the statistics body on the
    same map (:func:`_sw_geometry`: one block an SM, n_sm of them at most,
    the partial rows of a batch entry), so that the run's phase (a) splits
    the map as the split route's row 3 launch does; its shared memory is
    :func:`_lv_smem`'s."""
    if (dtype != torch.bfloat16 or c not in _LV_WG_WIDTHS or c != 64 * heads
            or e % 32 or ch != 2 * e or len(ln_b) != 1):
        return "tile", None
    smem, s_stats, s_ffn = _lv_smem(c)
    return "wg", dict(_sw_geometry(b, h, w, c, False, n_sm), smem=smem,
                      stages=(s_stats, s_ffn))


def _stack(run, key):
    """Weight ``key`` of the run's blocks as one (N, ...) tensor, block i at
    [i] (None where the blocks have none): the layout csrc/level_wg.cu
    reads, the first axis along which the JAX kernel stacks its weights
    (turtlevsr_tpu/kernels/level.py, ``stack``)."""
    if run[0].get(key) is None:
        return None
    return torch.stack([blk[key] for blk in run])


def safe_norms(ss: torch.Tensor) -> torch.Tensor:
    """max(sqrt(ss), 1e-12): zero rows (nothing to normalise, such as an
    empty ring frame's) stay finite, and so do their gradients: the sqrt
    never sees a zero, whose derivative would give 0 * inf = NaN."""
    nonzero = ss > 0
    n = torch.sqrt(torch.where(nonzero, ss, torch.ones_like(ss)))
    return torch.where(nonzero, n, torch.zeros_like(n)).clamp_min(_NORM_EPS)


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
    b, h, w, c = x.shape
    halo = None  # float32's LN halo in device memory
    if x.dtype == torch.float32:  # raises before any launch if not taken
        halo = _halo_scratch(_level_f32_plan(b, h, w, c, heads,
                                             _sm_count(x.device)), x)
    _check_width("fused_channel_gffw_run", x)
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
    ptrs_of = [[_check(f"blocks[{i}].{k}", blk.get(k), x, shapes[k])
                for k in _BLOCK_KEYS] for i, blk in enumerate(blocks)]
    ctok = c // heads
    width = heads * ctok * ctok + 2 * c
    ln_b = {(blk.get("ln1_b") is not None, blk.get("ln2_b") is not None)
            for blk in blocks}
    body, geo = _level_plan(b, h, w, c, heads, e, ch, x.dtype, ln_b,
                            _sm_count(x.device))
    new = lambda *shape, dtype=x.dtype: torch.empty(  # noqa: E731
        shape, dtype=dtype, device=x.device)
    v, po = new(b, h, w, c), new(b, c, c)
    tot = new(b, width, dtype=torch.float32)
    if body == "wg":  # its shared memory fits by construction (_lv_smem)
        lib = build.load("level_wg")
        # zero at the first launch; each launch leaves it zero
        part = torch.zeros((b, geo["rows"], width), dtype=torch.float32,
                           device=x.device)
    else:
        lib = build.load("level")
        _check_smem("fused_channel_gffw_run", lib.turtle_level_smem(
            c, heads, int(x.dtype == torch.bfloat16)))
        part = new(b, _tiles(h, w), width, dtype=torch.float32)
    with torch.cuda.device(x.device):
        for i0 in range(0, len(blocks), MAX_RUN):
            run = blocks[i0:i0 + MAX_RUN]
            out = new(b, h, w, c)
            tmp = new(b, h, w, c) if len(run) > 1 else out
            ptrs = [_check("x", x, x), out.data_ptr(), tmp.data_ptr(),
                    v.data_ptr(), part.data_ptr(), tot.data_ptr(),
                    po.data_ptr()]
            if body == "wg":
                stacked = [_stack(run, k) for k in _BLOCK_KEYS]
                ptrs += [None if t is None else t.data_ptr() for t in stacked]
                _call(lib.turtle_level_wg_launch, ptrs,
                      [b, h, w, c, e, heads, len(run), geo["rows"],
                       geo["blocks"]], x, "fused_channel_gffw_run")
                fused_channel_gffw_run.launches_wg += 1
            else:
                for p in ptrs_of[i0:i0 + MAX_RUN]:
                    ptrs += p
                ptrs += [None] * (len(_BLOCK_KEYS) * (MAX_RUN - len(run)))
                ptrs.append(None if halo is None else halo.data_ptr())
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

    ``blocks``: the dicts of the module note (no conv biases). Two kernels,
    chosen by shape before the launch (:func:`_level_plan`):
    csrc/level_wg.cu for bf16 runs with 64 channels a head, C = 128, 256 or
    512 and E a multiple of 32 (the statistics and FFN wgmma bodies as
    phases of one persistent grid of one block an SM, the weights stacked
    once a call; ``fused_channel_gffw_run.launches_wg`` counts them),
    csrc/level.cu for every other run (the grid sized by the occupancy;
    float32 up to C = 512, the LN halo in a device-memory scratch at C =
    512: :func:`_level_f32_plan`). Either way a cooperative launch, every
    thread block resident at once.

    Replaces ``fused_channel_gffw_run`` in turtlevsr_tpu/kernels/level.py
    (bound by operations like the statistics and FFN kernels whose device
    code it shares)."""
    if not blocks:
        raise ValueError("fused_channel_gffw_run needs at least one block")
    if x.device.type == "cpu":
        return channel_gffw_run_plain(x, blocks, heads)
    _need_cuda("fused_channel_gffw_run", x)
    return _launch(x, list(blocks), heads)


fused_channel_gffw_run.launches = 0
fused_channel_gffw_run.launches_wg = 0  # those of them on csrc/level_wg.cu
