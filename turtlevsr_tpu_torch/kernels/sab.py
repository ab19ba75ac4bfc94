"""The attention of the StateAlignBlock (t1): its probabilities (scores,
top-5, local mask, clipped softmax, frame validity), the same probabilities
on given scores and a given mask, and their product with the window values,
stored slot by slot or straight as merged maps.

``sab_attn_probs`` launches the kernels of ``csrc/sab_wg.cu`` (bf16),
``csrc/sab_f32.cu`` (float32) or ``csrc/sab.cu``, ``sab_sparse_softmax``
that of ``csrc/sparse_wg.cu`` (bf16) or ``csrc/sab.cu``,
``sab_attn_v_slots`` and ``sab_attn_v_merge`` that of ``csrc/attn_v_f32.cu``
(float32) or ``csrc/attn_v.cu``, on
CUDA tensors (or they raise); on CPU tensors, and only there, each runs the
plain version beside it. The plain versions round where the kernels round
(the scores before the selection, the product once, to the map's type) and
compute in the accumulation type.
"""

from __future__ import annotations

import torch

from turtlevsr_tpu_torch.kernels import build
from turtlevsr_tpu_torch.kernels.ffn import (
    _KERNEL_DTYPES,
    _SMEM_LIMIT,
    _call,
    _check,
    _f32_plan_error,
    _fp_blocks,
    _fp_smem,
    _need_cuda,
)
from turtlevsr_tpu_torch.kernels.lattice import lattice_merge_plain
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


# sab.cu's block (sab_probs_kernel): the q tile (16 rows of D + 8) and a
# row buffer of HW scores (rounded up to 64, plus 8) for each of its query
# rows, mirrored from the source (a card test holds the two equal)
_TILE_QROWS, _TILE_XPAD = 16, 8


def _tile_smem(hw: int, d: int, rows: int, is_bf16: bool) -> int:
    """Bytes of shared memory of a sab.cu block that owns ``rows`` query
    rows of hw keys at width d."""
    stride = (hw + 63) // 64 * 64 + 8
    return (_TILE_QROWS * (d + _TILE_XPAD) + rows * stride) * (
        2 if is_bf16 else 4)


def _pick_rows(hw: int, d: int, is_bf16: bool) -> int:
    """Query rows per block of sab.cu: 16, or 8 where the row buffer of 16
    does not fit the block's shared memory."""
    need = 0
    for r in (16, 8):
        need = _tile_smem(hw, d, r, is_bf16)
        if need <= _SMEM_LIMIT:
            return r
    raise ValueError(
        f"sab_attn_probs: {hw} keys of width {d} need {need} bytes of "
        f"shared memory for 8 query rows, the card gives a block "
        f"{_SMEM_LIMIT}")


# the wgmma body (csrc/sab_wg.cu): query rows of a block, the largest
# local radius it takes, its ring stages (a TMA box of 128 rows (keys) x 64
# d each, up to _SB_MAX_STAGES) and the parts of its shared memory
# beside them (the q tile, the window slots, the candidate buffers),
# mirrored from the source (a card test holds the two equal)
_SB_ROWS, _SB_NL, _SB_MAX_STAGES = 128, 4, 8
_SB_BOX, _SB_ALIGN, _SB_CAND = 128 * 128, 1024, 8
_SB_SLOTS = (2 * _SB_NL + 1) ** 2
_SB_MAX_KEYS = 1 << 20  # sb_key_row's fp32 grid row is exact below 2^22


def _sb_smem(d: int) -> tuple[int, int]:
    """(bytes of shared memory, ring stages) of the probabilities' wgmma
    body at width d: the q tile (d / 64 boxes of 128 rows x 128 bytes), the
    window slots (128 rows x 81 bf16), the 256 consumer threads' buffers of
    8 top-5 candidates (4 bytes each), the q tile's mbarrier, then as many
    ring stages, with their two mbarriers, as fit."""
    rest = ((d // 64) * _SB_BOX + _SB_ROWS * _SB_SLOTS * 2
            + _SB_CAND * 256 * 4)
    stages = min(_SB_MAX_STAGES,
                 (_SMEM_LIMIT - _SB_ALIGN - rest - 8) // (_SB_BOX + 16))
    return _SB_ALIGN + stages * _SB_BOX + rest + 8 * (2 * stages + 1), stages


# the float32 body (csrc/sab_f32.cu): query rows of a block, keys of a key
# block, d of a chunk, the largest local radius it takes, the most keys; its
# shared memory (the d-major q and key chunks with rows padded by 4 floats,
# the score tile, the window slots), the same at every key count, mirrored
# from the source (a card test holds the two equal)
_SF_ROWS, _SF_KEYS, _SF_DC, _SF_NL = 64, 128, 16, 4
_SF_MAX_KEYS = 1 << 24
# the float32 body's grid (blocks of 64 query rows of one map and frame) from
# which it is the faster body where sab.cu's block holds the rows: an H100's
# SMs (PERF.md, row 7, float32; _sab_plan)
_SF_MIN_BLOCKS = 132


def _sf_smem() -> int:
    """Bytes of shared memory of the float32 body, whatever HW and D."""
    slots = (2 * _SF_NL + 1) ** 2
    return (_SF_DC * (_SF_ROWS + 4) + _SF_DC * (_SF_KEYS + 4)
            + _SF_ROWS * (_SF_KEYS + 4) + _SF_ROWS * slots) * 4


def _sab_plan(b, nf, hw, d, dtype, n_local: int = 4,
              grid_wq: int = 1) -> str:
    """The body of one sab_attn_probs call, chosen by its shape: "wg" for
    the wgmma body of csrc/sab_wg.cu (bf16, D a multiple of 64 up to 512, a
    local radius of at most 4), "f32" for csrc/sab_f32.cu (float32, D a
    multiple of 16, a local radius of at most 4, up to 2^24 keys: its
    shared memory does not grow with the keys), "tile" for sab.cu's
    sab_probs_kernel.

    float32 goes to sab_f32.cu where sab.cu's block of 8 query rows does not
    fit (every CHM level of a padded 1920x1080 frame: 8160 keys), and where
    its grid has at least one block of 64 rows an SM, _SF_MIN_BLOCKS: there
    it measured faster than sab.cu on an H100 (PERF.md, row 7; ms, sab_f32.cu
    against sab.cu, D = 512 / 256 / 128): a padded 720p frame's 3680 keys
    (232 / 232 / 174 blocks) 1.91 / 1.02 / 0.59 against 15.53 / 8.03 /
    3.38, 15 tiles of 320 (420 / 420 / 315) 0.56 / 0.34 / 0.20 against 1.26
    / 0.66 / 0.29. With fewer blocks sab.cu's blocks of 16 rows spread over
    more SMs and it stays: the harness's 256 x 256 (16 / 16 / 12 blocks)
    0.121 / 0.079 / 0.073 against 0.106 / 0.069 / 0.066, the train step's
    192 x 192 at batch 2 (24 / 24 / 18) 0.109 / 0.072 / 0.063 against 0.089
    / 0.068 / 0.045.

    One shape the wgmma body takes stays on sab.cu: D = 128 on the 20 x 20
    token grid of a 320 tile (dec1 of the tiled deblur path), where sab.cu
    measured faster on an H100 (PERF.md, row 7: the grid fills 3.1 of the
    body's 4 blocks of 128 rows and 4 key tiles, and at D = 128 the
    products no longer hide that). It is kept so that the wgmma body is the
    faster one at every shape of the paths that it takes."""
    if dtype == torch.float32:
        if (d % _SF_DC or not 0 <= n_local <= _SF_NL or hw > _SF_MAX_KEYS
                or grid_wq < 1 or hw % grid_wq):
            return "tile"
        blocks = -(-hw // _SF_ROWS) * nf * b
        return "f32" if (_tile_smem(hw, d, 8, False) > _SMEM_LIMIT
                         or blocks >= _SF_MIN_BLOCKS) else "tile"
    if (dtype != torch.bfloat16 or d % 64 or not 64 <= d <= 512
            or not 0 <= n_local <= _SB_NL or hw > _SB_MAX_KEYS
            or b * nf * hw >= 2 ** 31 or grid_wq < 1 or hw % grid_wq
            or (d == 128 and hw == 400)):
        return "tile"
    return "wg"


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
    body = _sab_plan(b, nf, hw, d, q.dtype, n_local, grid_wq)
    lib = build.load({"wg": "sab_wg", "f32": "sab_f32"}.get(body, "sab"))
    # the wgmma and float32 bodies' shared memory fits by construction
    # (_sb_smem, _sf_smem)
    rows = 0 if body != "tile" else _pick_rows(hw, d,
                                               q.dtype == torch.bfloat16)
    out = torch.empty((b, nf, hw, hw), dtype=q.dtype, device=q.device)
    temp32 = temp.detach().to(device=q.device,
                              dtype=torch.float32).reshape(1).contiguous()
    fv32 = None if fvalid is None else fvalid.to(
        device=q.device, dtype=torch.float32).reshape(nf).contiguous()
    ptrs = [_check("q", q, q), _check("k", k, q, (b, nf, hw, d)),
            temp32.data_ptr(), None if fv32 is None else fv32.data_ptr(),
            out.data_ptr()]
    if body == "wg":
        _call(lib.turtle_sab_wg_launch, ptrs,
              [b, nf, hw, d, grid_wq, k_top, n_local], q, "sab_attn_probs")
        sab_attn_probs.launches_wg += 1
    elif body == "f32":
        _call(lib.turtle_sab_f32_launch, ptrs,
              [b, nf, hw, d, grid_wq, k_top, n_local], q, "sab_attn_probs")
        sab_attn_probs.launches_f32 += 1
    else:
        _call(lib.turtle_sab_launch, ptrs,
              [b, nf, hw, d, grid_wq, k_top, n_local, rows], q,
              "sab_attn_probs")
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

    Replaces ``sab_fused_attn_probs`` in turtlevsr_tpu/kernels/sab.py;
    bound by operations at D >= 256, by bytes at D = 128 (bf16; float32 by
    operations at every width of the paths). Three kernels, chosen by shape
    before the launch (:func:`_sab_plan`): the wgmma body of
    csrc/sab_wg.cu for bf16 calls with D a multiple of 64 up to 512, a local
    radius of at most 4, but D = 128 on a 20 x 20 token grid
    (``sab_attn_probs.launches_wg`` counts them), the float32 body of
    csrc/sab_f32.cu, whose shared memory does not grow with HW, for the
    float32 calls of the plan's rule (``sab_attn_probs.launches_f32``),
    csrc/sab.cu's sab_probs_kernel for every other call; one launch either
    way."""
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
sab_attn_probs.launches_wg = 0  # those of them on the wgmma body (sab_wg.cu)
sab_attn_probs.launches_f32 = 0  # those on the float32 body (sab_f32.cu)


# ---------------------------------------------------------------------------
# row 12: the same probabilities on given scores and a given local mask
# ---------------------------------------------------------------------------


def sparse_softmax_plain(scores, local_mask, k_top: int = 5):
    """Plain version of :func:`sab_sparse_softmax`: the chain of
    :func:`sab_attn_probs_plain` after its scores, a block of rows at a
    time."""
    dt = scores.dtype
    ad = acc_dtype(dt)
    q = scores.shape[1]
    out = torch.empty_like(scores)
    for r0 in range(0, q, _PLAIN_ROWS):
        rows = slice(r0, min(r0 + _PLAIN_ROWS, q))
        s = scores[:, rows].to(ad)
        local = local_mask[rows].to(dt).to(ad)
        out[:, rows] = clipped_softmax(topk_keep(s, k_top) + s * local).to(dt)
    return out


def _sparse_rows(k: int, is_bf16: bool, lib) -> int:
    """Rows per block: 8, or fewer where 8 rows of k scores do not fit the
    block's shared memory."""
    need = 0
    for r in (8, 4, 2, 1):
        need = lib.turtle_sparse_softmax_smem(k, r, int(is_bf16))
        if need <= _SMEM_LIMIT:
            return r
    raise ValueError(f"sab_sparse_softmax: a row of {k} scores needs {need} "
                     f"bytes of shared memory, the card gives a block "
                     f"{_SMEM_LIMIT}")


# the streaming body (csrc/sparse_wg.cu): entries a block (one a warp) and
# its shared memory (the block's mask row, each warp's score row and its
# bits, a 32-bit word per 32 keys in pieces of 16 bytes), mirrored from the
# source (a card test holds the two equal)
_SPW_ENTRIES = 4


def _spw_smem(k: int) -> int:
    return 2 * k + _SPW_ENTRIES * (2 * k + -(-k // 128) * 16)


def _sparse_plan(bn: int, q: int, k: int, dtype):
    """The body of one sab_sparse_softmax call, chosen by its shape: ("wg",
    geometry) for the streaming body of csrc/sparse_wg.cu (bf16, rows of
    whole 16-byte pieces: K a multiple of 8, the block's rows within its
    shared memory), else ("tile", None) for sab.cu's sparse_softmax_kernel.
    The geometry: the grid (a block a query row and group of up to 4
    entries, one a warp; the query rows of a group run next to each other,
    so the mask is read from device memory about once a group) and the
    shared memory."""
    if dtype != torch.bfloat16 or k < 8 or k % 8 or _spw_smem(k) > _SMEM_LIMIT:
        return "tile", None
    return "wg", dict(entries=_SPW_ENTRIES,
                      grid=(q, -(-bn // _SPW_ENTRIES)), smem=_spw_smem(k))


def _sparse_launch(scores, local_mask, k_top):
    if scores.dtype not in _KERNEL_DTYPES:
        raise ValueError("sab_sparse_softmax: the kernel takes bfloat16 or "
                         f"float32, got {scores.dtype}")
    bn, q, k = scores.shape
    if bn > 65535:
        raise ValueError(f"sab_sparse_softmax: at most 65535 entries a "
                         f"launch, got {bn}")
    mask = local_mask.to(scores.dtype).contiguous()
    out = torch.empty_like(scores)
    ptrs = [_check("scores", scores, scores), _check("local_mask", mask, scores),
            out.data_ptr()]
    body, _ = _sparse_plan(bn, q, k, scores.dtype)
    if body == "wg":  # its shared memory fits by construction
        _call(build.load("sparse_wg").turtle_sparse_wg_launch, ptrs,
              [bn, q, k, k_top], scores, "sab_sparse_softmax")
        sab_sparse_softmax.launches_wg += 1
    else:
        lib = build.load("sab")
        rows = _sparse_rows(k, scores.dtype == torch.bfloat16, lib)
        _call(lib.turtle_sparse_softmax_launch, ptrs, [bn, q, k, k_top, rows],
              scores, "sab_sparse_softmax")
    sab_sparse_softmax.launches += 1
    return out


def sab_sparse_softmax(scores, local_mask, k_top: int = 5):
    """scores (BN, Q, K), local_mask (Q, K) taken in the scores' type.
    Returns (BN, Q, K) probabilities in the scores' type:

      keep = the k_top largest entries of a row, first occurrence on ties
             (with fewer than k_top keys, all of them: min(k_top, K), as the
             unfused chain's topk_keep; the Pallas kernel would mark key 0
             twice there, a shape its gate keeps away)
      comb = s * keep + s * local_mask
      out  = softmax over the nonzero entries of comb (zeros elsewhere, a
             row with nothing left gives zeros), float32 inside

    Row 7 (:func:`sab_attn_probs`) is this after its QK^T product, with the
    local mask taken from the token grid and the frame validity applied.
    Replaces ``sab_sparse_softmax`` in turtlevsr_tpu/kernels/sab.py (bound
    by bytes). Two kernels, chosen by shape before the launch
    (:func:`_sparse_plan`): the streaming body of csrc/sparse_wg.cu (each
    score and mask row read once in 16-byte pieces, the row kept on chip,
    the output written in 16-byte pieces) for bf16 rows of a multiple of 8
    keys (``launches_wg`` counts them), sab.cu's ``sparse_softmax_kernel``
    for the rest. Both give the same bits."""
    if scores.dim() != 3 or local_mask.shape != scores.shape[1:]:
        raise ValueError("sab_sparse_softmax takes scores (BN, Q, K) and a "
                         "local_mask (Q, K)")
    if not 1 <= k_top <= K_TOP_MAX:
        raise ValueError(f"sab_sparse_softmax: k_top must be 1..{K_TOP_MAX}")
    if scores.device.type == "cpu":
        return sparse_softmax_plain(scores, local_mask, k_top)
    _need_cuda("sab_sparse_softmax", scores)
    return _sparse_launch(scores, local_mask, k_top)


sab_sparse_softmax.launches = 0
sab_sparse_softmax.launches_wg = 0  # those of them on csrc/sparse_wg.cu


# ---------------------------------------------------------------------------
# attention @ values, slot-tiled or merged into maps
# ---------------------------------------------------------------------------

_MAX_V = 5  # AV_MAX_V of csrc/attn_v.cu


def _v_list(a, v):
    """v as the list of its NF tensors (B, HW, D): entry n = b * NF + i of a
    goes with v[i][b]. A single tensor is the list of one."""
    vs = list(v) if isinstance(v, (list, tuple)) else [v]
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError("a must be (BN, HW, HW) probabilities")
    bn, hw = a.shape[0], a.shape[1]
    if not vs or bn % len(vs):
        raise ValueError(f"{bn} entries of a do not divide over {len(vs)} "
                         "value tensors")
    for vi in vs:
        if vi.dim() != 3 or tuple(vi.shape) != (bn // len(vs), hw,
                                                vs[0].shape[2]):
            raise ValueError(
                f"each v must be ({bn // len(vs)}, {hw}, D), got "
                f"{tuple(vi.shape)}")
    return vs


def _attn_v_tokens(a, vs):
    """(BN, HW, D) = a @ v in the accumulation type, rounded once."""
    ad = acc_dtype(a.dtype)
    bn, hw = a.shape[0], a.shape[1]
    v_all = torch.stack([vi.to(ad) for vi in vs], dim=1).reshape(bn, hw, -1)
    return torch.einsum("nqk,nkd->nqd", a.to(ad), v_all).to(a.dtype)


def attn_v_slots_plain(a, v, c_slot: int):
    """Plain version of :func:`sab_attn_v_slots`."""
    tok = _attn_v_tokens(a, _v_list(a, v))
    bn, hw, d = tok.shape
    return tok.reshape(bn, hw, d // c_slot, c_slot).permute(
        0, 2, 1, 3).contiguous()


def attn_v_merge_plain(a, v, ws: int, h: int, w: int, out=None):
    """Plain version of :func:`sab_attn_v_merge`."""
    maps = lattice_merge_plain(_attn_v_tokens(a, _v_list(a, v)), ws, h, w)
    if out is None:
        return maps.contiguous()
    out.copy_(maps)
    return out


def _attn_v_f32_geometry(bn: int, hw: int, d: int) -> dict:
    """The launch of one float32 attention @ v call on csrc/attn_v_f32.cu,
    mirrored from turtle_attn_v_f32_launch: the product M = HW queries by N
    = D columns over K = HW keys a batch entry on f32_tile.cuh's "wide"
    tile (128 x 128; no other configuration of the product measured faster
    at dec3's, dec2's and dec1's whole frame, NVIDIA H100, PERF.md row 11);
    its blocks and shared memory. Raises ValueError, naming the body and its
    forms, for a call it does not take."""
    if not 1 <= bn <= 65535 or hw < 1 or d < 8 or d % 8:
        raise _f32_plan_error("sab_attn_v_merge", "csrc/attn_v_f32.cu",
                              "up to 65535 entries, D a multiple of 8",
                              f"BN={bn}, D={d}")
    return dict(kind="wide", blocks=_fp_blocks(bn, hw, d, "wide"),
                smem=_fp_smem("wide"))


def _attn_v_plan(bn: int, hw: int, d: int, dtype):
    """The body of one attention @ v call: ("f32", geometry) for the float32
    body of csrc/attn_v_f32.cu (every float32 call: f32_tile.cuh's product,
    :func:`_attn_v_f32_geometry`), else ("tile", None) for csrc/attn_v.cu
    (bf16). attn_v.cu's float tile takes a float32 call only where a caller
    forces it (chip_smoke.py's tile_ms, the card tests' yardstick; ROADMAP
    Queue 7 item 2 queues its removal)."""
    if dtype == torch.float32:
        return "f32", _attn_v_f32_geometry(bn, hw, d)
    return "tile", None


def _attn_v_launch(what, a, vs, out, c, merge, ws, hh, ww) -> bool:
    """Launch attention @ v into ``out`` on the body :func:`_attn_v_plan`
    gives; whether it was the float32 body (the wrapper's counter)."""
    if a.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{what}: the kernel takes bfloat16 or float32, "
                         f"got {a.dtype}")
    bn, hw = a.shape[0], a.shape[1]
    d = vs[0].shape[2]
    if len(vs) > _MAX_V:
        raise ValueError(f"{what} takes up to {_MAX_V} value tensors, got "
                         f"{len(vs)}")
    if c < 8 or c % 8 or d % c:
        raise ValueError(f"{what}: the slot width must be a multiple of 8 "
                         f"that divides D={d}, got {c}")
    if bn > 65535:
        raise ValueError(f"{what}: at most 65535 entries a launch, got {bn}")
    es = a.element_size()
    v_ptrs, v_bs = [], []
    for i, vi in enumerate(vs):
        if vi.device != a.device or vi.dtype != a.dtype:
            raise ValueError(f"v[{i}]: expected {a.dtype} on {a.device}, got "
                             f"{vi.dtype} on {vi.device}")
        # a ring position is a view: rows contiguous, its own batch stride
        if (vi.stride(2) != 1 or vi.stride(1) != d or vi.data_ptr() % 16
                or (vi.stride(0) * es) % 16):
            raise ValueError(f"v[{i}] must have contiguous (HW, D) entries "
                             "at 16-byte boundaries")
        v_ptrs.append(vi.data_ptr())
        v_bs.append(vi.stride(0) if vi.shape[0] > 1 else hw * d)
    if max([hw * hw] + v_bs) >= 2 ** 31:
        raise ValueError(f"{what}: batch strides must stay below 2^31")
    pad = _MAX_V - len(vs)
    ptrs = [_check("a", a, a), _check("out", out, a), *v_ptrs, *[None] * pad]
    ints = [bn, len(vs), hw, d, c, int(merge), ws, hh, ww, hw * hw, *v_bs,
            *[0] * pad]
    body, geo = _attn_v_plan(bn, hw, d, a.dtype)
    if body == "f32":
        _call(build.load("attn_v_f32").turtle_attn_v_f32_launch, ptrs, ints,
              a, what)
    else:
        _call(build.load("attn_v").turtle_attn_v_launch, ptrs, ints, a, what)
    return body == "f32"


def sab_attn_v_slots(a, v, c_slot: int):
    """Slot-tiled attention @ values: a (BN, HW, HW) probabilities, v
    (BN, HW, D) window values in the lattice layout, D = S * c_slot (feature
    order (p1, p2, c)), or a list of NF tensors (B, HW, D) with BN = B * NF
    (entry b * NF + i reads v[i][b], each where it lies). Returns
    (BN, S, HW, c_slot) with out[:, s] = a @ v[..., s * c_slot:(s + 1) *
    c_slot]: fp32 sums, one rounding to a's type.

    Replaces ``sab_attn_v_slots`` in turtlevsr_tpu/kernels/sab.py (kernel:
    csrc/attn_v.cu, the `slots` epilogue; bound by bytes at a chunk of
    tiles, by operations at the whole frame); float32 on csrc/attn_v_f32.cu
    (:func:`_attn_v_plan`, ``sab_attn_v_slots.launches_f32``)."""
    vs = _v_list(a, v)
    if vs[0].shape[2] % c_slot:
        raise ValueError(f"c_slot={c_slot} must divide D={vs[0].shape[2]}")
    if a.device.type == "cpu":
        return attn_v_slots_plain(a, vs, c_slot)
    _need_cuda("sab_attn_v_slots", a)
    bn, hw, d = a.shape[0], a.shape[1], vs[0].shape[2]
    out = torch.empty((bn, d // c_slot, hw, c_slot), dtype=a.dtype,
                      device=a.device)
    f32 = _attn_v_launch("sab_attn_v_slots", a, vs, out, c_slot, False, 1,
                         1, hw)
    sab_attn_v_slots.launches += 1
    sab_attn_v_slots.launches_f32 += f32
    return out


sab_attn_v_slots.launches = 0
sab_attn_v_slots.launches_f32 = 0  # those on the float32 body, attn_v_f32.cu


def sab_attn_v_merge(a, v, ws: int, h: int, w: int, out=None):
    """Attention @ window values followed by the lattice un-split, in one
    pass: a (BN, HW, HW), v (BN, HW, ws * ws * C) or a list as for
    :func:`sab_attn_v_slots` -> maps (BN, h, w, C); HW = (h / ws) * (w / ws).
    Element (q = (i, j), d = (p1, p2, c)) of a @ v lands at map position
    (p1 * h / ws + i, p2 * w / ws + j, c). ``out``: an optional contiguous
    (BN, h, w, C) tensor to write into.

    Replaces ``sab_attn_v_merge`` in turtlevsr_tpu/kernels/sab.py (kernel:
    csrc/attn_v.cu, the `merge` epilogue; bound by bytes at a chunk of
    tiles, by operations at the whole frame); float32 on csrc/attn_v_f32.cu
    (f32_tile.cuh's product, the merge as its store; :func:`_attn_v_plan`,
    ``sab_attn_v_merge.launches_f32``)."""
    vs = _v_list(a, v)
    bn, hw, d = a.shape[0], a.shape[1], vs[0].shape[2]
    if ws < 1 or h % ws or w % ws or (h // ws) * (w // ws) != hw or d % (
            ws * ws):
        raise ValueError(f"the window {ws} and the map {h} x {w} do not give "
                         f"{hw} tokens of width {d}")
    c = d // (ws * ws)
    if out is not None and (tuple(out.shape) != (bn, h, w, c)
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({bn}, {h}, {w}, {c}) "
                         "tensor")
    if a.device.type == "cpu":
        return attn_v_merge_plain(a, vs, ws, h, w, out)
    _need_cuda("sab_attn_v_merge", a)
    if out is None:
        out = torch.empty((bn, h, w, c), dtype=a.dtype, device=a.device)
    f32 = _attn_v_launch("sab_attn_v_merge", a, vs, out, c, True, ws,
                         h // ws, w // ws)
    sab_attn_v_merge.launches += 1
    sab_attn_v_merge.launches_f32 += f32
    return out


sab_attn_v_merge.launches = 0
sab_attn_v_merge.launches_f32 = 0  # those on the float32 body, attn_v_f32.cu
