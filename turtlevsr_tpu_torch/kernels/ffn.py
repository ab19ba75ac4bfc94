"""The five conv-FFN kernels of the serving path and their plain versions.

Each public function takes NHWC maps and the weight layouts of the JAX
package's ``kernels/ffn.py`` (w1 (C, CH), wd (3, 3, CH), w2 (E, C), conv
weight (3, 3, Cin, Cout)). On a CUDA tensor it launches the hand-written
kernel of ``csrc/`` (or raises); on a CPU tensor, and only there, it runs the
plain PyTorch version beside it. The plain versions repeat the kernels'
arithmetic: sums in the accumulation type (fp32, fp64 for fp64 maps) and a
rounding to the map's type wherever the kernel rounds (x', LN output, the
activation, the chained FFW's input), so in float64 they equal the JAX
package's reference chains and in bf16 they differ from the kernels only by
the order of fp32 sums.

Every wrapper counts its kernel launches in ``<wrapper>.launches``
(``turtlevsr_tpu_torch.kernels.launch_counts`` reads them all);
``fused_block_ffn.launches_no_dw`` counts those of them that ran the branch
without a depthwise stage (``fused_block_ffn.launches_pw`` those of these on
the body of csrc/ffn_pw.cu), ``fused_block_ffn.launches_wg`` those on the
wgmma body of csrc/ffn_wg.cu, ``fused_block_ffn.launches_c64`` those on the
C = 64 body of csrc/ffn_c64.cu; ``fused_qkv_stats.launches_wg`` and
``fused_chm_stats.launches_wg`` those of the statistics on the wgmma body of
csrc/stats_wg.cuh (qkv_wg.cu, chm_wg.cu); ``fused_ln_split_proj.launches_wg``
and ``.launches_c64`` those of the split projection on the wgmma body of
csrc/split_wg.cu and on the C = 64 body of csrc/split_c64.cu.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from turtlevsr_tpu_torch.kernels import build
from turtlevsr_tpu_torch.ops.attn_utils import acc_dtype
from turtlevsr_tpu_torch.ops.norm import LN_EPS

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_SMEM_LIMIT = 232448  # dynamic shared memory a block can have on sm_90
_TILE = 8
_MAX_C = 512  # the widest map the chain kernels take


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _ln_acc(x, w, b):
    """Channel LN of values already in the accumulation type (w None: no
    LayerNorm, x as it is)."""
    if w is None:
        return x
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    inv = 1.0 / torch.sqrt(var + LN_EPS)
    if b is None:
        return x * inv * w.to(x.dtype)
    return (x - mu) * inv * w.to(x.dtype) + b.to(x.dtype)


def _rt(v, dtype):
    """The value v takes when stored as ``dtype`` and read back."""
    return v.to(dtype).to(v.dtype)


def records(*tensors) -> bool:
    """Whether autograd records an operation on these tensors (None
    entries are skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _dw_acc(h, wd, bd):
    """Depthwise 3x3, zero padding of the hidden map, as nine shifted
    multiply-adds in h's type (taps in row-major order, then the bias),
    accumulated in place; each product in one reused buffer when autograd
    does not record. Adds its multiply-accumulates to ``_dw_acc.macs``,
    which ``cli/bench.py``'s MAC count reads (FlopCounterMode sees no
    elementwise product)."""
    b, hh, ww, ch = h.shape
    _dw_acc.macs += 9 * h.numel()
    hp = F.pad(h, (0, 0, 1, 1, 1, 1))
    out = torch.zeros_like(h)
    prod = None if records(h, wd) else torch.empty_like(h)
    for ty in range(3):
        for tx in range(3):
            tap = hp[:, ty:ty + hh, tx:tx + ww, :]
            w = wd[ty, tx].to(h.dtype)
            out.add_(tap * w if prod is None else torch.mul(tap, w, out=prod))
    if bd is not None:
        out.add_(bd.to(h.dtype))
    return out


_dw_acc.macs = 0


def _gelu(v):
    return F.gelu(v, approximate="none")


def _chain_acc(xn, w1, b1, wd, bd):
    """dw3x3(pw1(xn) + b1) + bd in the accumulation type."""
    h = xn @ w1.to(xn.dtype)
    if b1 is not None:
        h = h + b1.to(h.dtype)
    if wd is not None:
        h = _dw_acc(h, wd, bd)
    return h


def _x2_maps(x2):
    """x2 as the list of its (B, H, W, C) maps: a map, a stacked
    (B, M, H, W, C) tensor (M maps, no copies) or a list of either."""
    if x2 is None:
        return []
    entries = list(x2) if isinstance(x2, (list, tuple)) else [x2]
    maps = []
    for e in entries:
        maps += [e[:, j] for j in range(e.shape[1])] if e.dim() == 5 else [e]
    return maps


def _po_list(po_w, n_maps: int):
    """po_w as one matrix per map (None: the maps are added as they are)."""
    if po_w is None:
        return None
    pos = list(po_w) if isinstance(po_w, (list, tuple)) else [po_w]
    if len(pos) != n_maps:
        raise ValueError(f"po_w must hold one matrix per x2 map: {len(pos)} "
                         f"matrices, {n_maps} maps")
    return pos


def ffn_plain(x, *, x2=None, po_w=None, po_b=None, ln_w, ln_b=None, w1,
              b1=None, wd=None, bd=None, w2, b2=None, scale=None,
              mode: str, ffw2=None):
    """Plain version of :func:`fused_block_ffn`."""
    dt = x.dtype
    ad = acc_dtype(dt)
    xa = x.to(ad)
    maps = _x2_maps(x2)
    pos = _po_list(po_w, len(maps))
    for j, m in enumerate(maps):
        a2 = m.to(ad)
        if pos is not None:
            pw = pos[j].to(ad)
            a2 = _rt(torch.einsum("bhwc,bce->bhwe", a2, pw) if pw.dim() == 3
                     else a2 @ pw, dt)
            if po_b is not None and j == 0:
                a2 = _rt(a2 + po_b.to(ad), dt)
        xa = xa + a2  # one sum in the accumulation type over all the maps
    if maps:
        xa = _rt(xa, dt)
    xn = _rt(_ln_acc(xa, ln_w, ln_b), dt)
    h = _chain_acc(xn, w1, b1, wd, bd)
    if mode == "gate":
        a, b = h.chunk(2, dim=-1)
        act = _gelu(a) * b
    elif mode == "gelu":
        act = _gelu(h)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    out = _rt(act, dt) @ w2.to(ad)
    if b2 is not None:
        out = out + b2.to(ad)
    if scale is not None:
        out = out * scale.to(ad)
    out = out + xa
    if ffw2 is not None:
        y = _rt(out, dt)
        yn = _rt(_ln_acc(y, ffw2["ln_w"], ffw2.get("ln_b")), dt)
        h2 = yn @ ffw2["w1"].to(ad) + ffw2["b1"].to(ad)
        o2 = _rt(_gelu(h2), dt) @ ffw2["w2"].to(ad)
        out = (o2 + ffw2["b2"].to(ad)) * ffw2["scale"].to(ad) + y
    return out.to(dt)


def qkv_stats_plain(x, *, ln_w, ln_b=None, w1, b1=None, wd, bd=None,
                    heads: int):
    """Plain version of :func:`fused_qkv_stats`."""
    dt = x.dtype
    ad = acc_dtype(dt)
    b, h, w, c = x.shape
    ctok = c // heads
    xn = _rt(_ln_acc(x.to(ad), ln_w, ln_b), dt)
    q, k, v = _rt(_chain_acc(xn, w1, b1, wd, bd), dt).split(c, dim=-1)
    # Gram and norms in at least fp32 (fp64 stays fp64), as float32 tensors
    # for the serving types like the kernel's output
    qh = q.reshape(b, h * w, heads, ctok)
    kh = k.reshape(b, h * w, heads, ctok)
    gram = torch.einsum("blhc,blhd->bhcd", qh, kh)
    sq = q.square().sum(dim=(1, 2))
    sk = k.square().sum(dim=(1, 2))
    return v.to(dt), gram, torch.stack([sq, sk], dim=1)


def split_proj_plain(x, *, ln_w=None, ln_b=None, w1, b1=None, wd, bd=None,
                     n_out: int):
    """Plain version of :func:`fused_ln_split_proj`."""
    dt = x.dtype
    ad = acc_dtype(dt)
    xn = _rt(_ln_acc(x.to(ad), ln_w, ln_b), dt)
    maps = _chain_acc(xn, w1, b1, wd, bd).to(dt)
    return tuple(m.contiguous() for m in maps.chunk(n_out, dim=-1))


def chm_stats_plain(x, x_sp, *, ln_w, ln_b=None, w_qkv, wd_qkv, w_kv, wd_kv,
                    heads: int):
    """Plain version of :func:`fused_chm_stats`."""
    dt = x.dtype
    ad = acc_dtype(dt)
    b, h, w, c = x.shape
    nf = x_sp.shape[1]
    ctok = c // heads
    xn = _rt(_ln_acc(x.to(ad), ln_w, ln_b), dt)
    q, k, v = _rt(_chain_acc(xn, w_qkv, None, wd_qkv, None), dt).split(
        c, dim=-1)
    frames = x_sp.reshape(b * nf, h, w, c).to(ad)  # no LayerNorm
    kh, vh = _rt(_chain_acc(frames, w_kv, None, wd_kv, None), dt).split(
        c, dim=-1)
    qh = q.reshape(b, h * w, heads, ctok)
    g = torch.einsum("blhc,blhd->bhcd", qh, k.reshape(b, h * w, heads, ctok))
    gh = torch.einsum("blhc,bnlhd->bnhcd", qh,
                      kh.reshape(b, nf, h * w, heads, ctok))
    stats = torch.cat([
        q.square().sum(dim=(1, 2))[:, None], k.square().sum(dim=(1, 2))[:, None],
        kh.reshape(b, nf, h, w, c).square().sum(dim=(2, 3))], dim=1)
    return (v.to(dt), vh.reshape(b, nf, h, w, c).to(dt), g, gh, stats)


def conv3x3_plain(x, weight, bias=None, *, ln_w=None, ln_b=None):
    """Plain version of :func:`fused_conv3x3`: nine shifted matrix products
    in the accumulation type (no library convolution, whose float32 path may
    run in TF32); with ``ln_w`` on LN(x) rounded to the map's type, the
    border being zero padding of LN(x)."""
    dt = x.dtype
    ad = acc_dtype(dt)
    b, h, w, cin = x.shape
    xa = x.to(ad)
    if ln_w is not None:
        xa = _rt(_ln_acc(xa, ln_w, ln_b), dt)
    xp = F.pad(xa, (0, 0, 1, 1, 1, 1))
    out = None
    for ty in range(3):
        for tx in range(3):
            t = xp[:, ty:ty + h, tx:tx + w, :] @ weight[ty, tx].to(ad)
            out = t if out is None else out + t
    if bias is not None:
        out = out + bias.to(ad)
    return out.to(dt)


# ---------------------------------------------------------------------------
# launch helpers
# ---------------------------------------------------------------------------


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check(name: str, t, ref: torch.Tensor, shape=None):
    """A kernel operand: same device and type as the map, contiguous,
    16-byte aligned and of the expected shape. Returns its address (None
    stays a null pointer)."""
    if t is None:
        return None
    if t.device != ref.device or t.dtype != ref.dtype:
        raise ValueError(
            f"{name}: expected {ref.dtype} on {ref.device}, got {t.dtype} on "
            f"{t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start at a 16-byte boundary (the "
                         "kernels read it in 16-byte pieces)")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t.data_ptr()


def _check_map(name: str, x: torch.Tensor):
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: the kernels take bfloat16 or float32 "
                         f"maps, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (B, H, W, C) map")


def _check_width(name: str, x: torch.Tensor):
    """The chain kernels take C % 16 == 0 up to 512, in bfloat16 and in
    float32 (each float32 body's own limits are its plan's:
    :func:`_ffn_f32_plan` and the others below it)."""
    c = x.shape[-1]
    if c % 16 or c > _MAX_C:
        raise ValueError(f"{name}: C must be a multiple of 16 up to {_MAX_C}"
                         f", got {c}")


def _need_cuda(name: str, x: torch.Tensor):
    if not x.is_cuda:
        raise RuntimeError(
            f"{name}: the kernel runs on CUDA tensors only (got a tensor on "
            f"{x.device})")


def _call(fn, ptrs, ints, x: torch.Tensor, what: str):
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    iarr = (ctypes.c_int * len(ints))(*ints)
    rc = fn(arr, iarr, int(x.dtype == torch.bfloat16), _stream(x))
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with code {rc} "
                           f"(-1: shape not taken; else a CUDA error)")


def _tiles(h: int, w: int) -> int:
    return ((h + _TILE - 1) // _TILE) * ((w + _TILE - 1) // _TILE)


def _check_smem(what: str, need: int):
    if need > _SMEM_LIMIT:
        raise ValueError(f"{what}: needs {need} bytes of shared memory, the "
                         f"card gives a block {_SMEM_LIMIT}")


# ---------------------------------------------------------------------------
# float32: the mma.sync bodies of rows 1, 3, 4, 5 (with LayerNorm) and 6
# ---------------------------------------------------------------------------

# csrc/common.cuh's tile: the 10 x 10 halo of an 8 x 8 tile, the row pad of
# its maps, the strides of the fp32 hidden chunk and of the activation chunk
_NPH, _P, _XPAD, _HS, _AS = 100, 64, 8, 72, 72
# F32_SHARED_HALO_MAX_C of csrc/common.cuh: in float32 at wider maps the LN
# halo (100 rows of C + 8 floats, 208,000 bytes at C = 512) does not fit in
# shared memory beside the chunk buffers and lives in a device-memory scratch
# of one slice a tile, which the wrapper allocates
_F32_SHARED_HALO_MAX_C = 256
_F32 = 4  # bytes of a float32 element


def _f32_plan_error(name: str, body: str, what: str, got: str):
    return ValueError(f"{name}: {body} takes float32 {what}, got {got}")


def _f32_geometry(name, body, b, h, w, c, halo_free_smem):
    """The common part of the float32 plans: one 8 x 8 tile a block; the LN
    halo in shared memory up to C = 256 (its bytes added to the rest's),
    else in a device-memory scratch of ``scratch`` float32 elements."""
    if c % 16 or not 16 <= c <= _MAX_C:
        raise _f32_plan_error(name, body, f"maps of C a multiple of 16 up "
                              f"to {_MAX_C}", f"C={c}")
    dev = c > _F32_SHARED_HALO_MAX_C
    n_tiles = b * _tiles(h, w)
    halo = _NPH * (c + _XPAD)
    smem = halo_free_smem + (0 if dev else halo * _F32)
    if smem > _SMEM_LIMIT:
        raise _f32_plan_error(name, body, f"calls whose shared memory fits "
                              f"{_SMEM_LIMIT} bytes", f"{smem}")
    return dict(tile=_TILE, blocks=n_tiles, halo="device" if dev else "shared",
                scratch=n_tiles * halo if dev else 0, smem=smem)


def _ffn_f32_plan(b, h, w, c, n_x2, f):
    """The geometry of one float32 fused_block_ffn call, on csrc/ffn.cu,
    mirrored from its dispatch (dispatch_ffn<float>) and ffn_tile_smem:
    every form up to C = 256 (the chained FFW up to C = 128, F <= 2C a
    multiple of 16, at most one x2 map; lists of up to 5 x2 maps), single
    maps at C = 512 with the LN halo in device memory. f: the chained FFW's
    hidden width (0: none). Raises ValueError, naming the body and the
    limit, for a call it does not take."""
    name, body = "fused_block_ffn", "csrc/ffn.cu"
    if f and (c > 128 or f > 2 * c or f % 16 or n_x2 > 1):
        raise _f32_plan_error(name, body, "the chained FFW at C <= 128, F <= "
                              "2C a multiple of 16, at most one x2 map",
                              f"C={c}, F={f}, {n_x2} maps")
    if n_x2 > 1 and c > _F32_SHARED_HALO_MAX_C:
        raise _f32_plan_error(name, body, "lists of x2 maps up to C = "
                              f"{_F32_SHARED_HALO_MAX_C}", f"C={c}")
    rest = ((_P * c + _P * _AS) * _F32 + _NPH * _HS * 4
            + (_P * (f + _XPAD) * _F32 if f else 0))
    acc = _NPH * c * 4 if n_x2 > 1 else 0  # the lists' sum borrows `rest`
    return _f32_geometry(name, body, b, h, w, c, max(rest, acc))


def _qkv_f32_plan(b, h, w, c, heads):
    """The geometry of one float32 fused_qkv_stats call, on
    csrc/qkv_stats.cu (qkv_tile_smem): C up to 512, the LN halo in device
    memory at C = 512, C / heads <= 64. Raises ValueError, naming the body
    and the limit, for a call it does not take."""
    name, body = "fused_qkv_stats", "csrc/qkv_stats.cu"
    if c % heads or c // heads > 64:
        raise _f32_plan_error(name, body, "C / heads <= 64",
                              f"C={c}, heads={heads}")
    return _f32_geometry(name, body, b, h, w, c,
                         _NPH * _HS * 4 + 2 * _P * (c // heads) * 4)


def _chm_f32_plan(b, h, w, c, heads, nf):
    """The geometry of one float32 fused_chm_stats call, on
    csrc/chm_stats.cu (turtle_chm_stats_smem): C up to 512, the LN halo in
    device memory at C = 512, C / heads <= 64, at least one aligned frame.
    Raises ValueError, naming the body and the limit, for a call it does not
    take."""
    name, body = "fused_chm_stats", "csrc/chm_stats.cu"
    if c % heads or c // heads > 64 or nf < 1:
        raise _f32_plan_error(name, body, "C / heads <= 64 and NF >= 1",
                              f"C={c}, heads={heads}, NF={nf}")
    return _f32_geometry(name, body, b, h, w, c,
                         _NPH * _HS * 4 + _P * (c + c // heads) * 4)


def _split_f32_plan(b, h, w, c):
    """The geometry of one float32 fused_ln_split_proj call, on
    csrc/split_proj.cu (turtle_split_proj_smem): C up to 512, the LN halo in
    device memory at C = 512. Raises ValueError, naming the body and the
    limit, for a call it does not take."""
    return _f32_geometry("fused_ln_split_proj", "csrc/split_proj.cu", b, h,
                         w, c, _NPH * _HS * 4)


# csrc/conv3x3.cu's float32 tile (GeoF32: 8 x 8 pixels by 64 channels, two
# stages of 32 rows of K; a gathered A stage has rows of 32 + 8)
_CV_BN, _CV_KC, _CV_STAGES_F32 = 64, 32, 2


def _conv_f32_plan(b, h, w, cin, cout, ln: bool):
    """The geometry of one float32 fused_conv3x3 call, on csrc/conv3x3.cu's
    mma.sync body (choose_plan<float>, conv_smem of GeoF32): the halo tile
    (100 rows of Cin + 8) beside two weight stages (32 x 72 each) where it
    fits, else (no LayerNorm, or Cin not a multiple of 16) the gathered A
    stages; with the LayerNorm Cin a multiple of 16 up to 512, 226,432 bytes
    at Cin = 512. Raises ValueError, naming the body and the limit, for a
    call it does not take."""
    name, body = "fused_conv3x3", "csrc/conv3x3.cu"
    if ln and (cin % 16 or not 16 <= cin <= _MAX_C):
        raise _f32_plan_error(name + " with LayerNorm", body, "Cin a multiple"
                              f" of 16 up to {_MAX_C}", f"Cin={cin}")
    bs = _CV_BN + _XPAD
    weights, out = _CV_STAGES_F32 * _CV_KC * bs, _P * bs
    halo = max((_NPH * (cin + _XPAD) + weights) * _F32, out * _F32)
    gather = max((_CV_STAGES_F32 * _P * (_CV_KC + _XPAD) + weights) * _F32,
                 out * _F32)
    tiled = cin % 16 == 0 and halo <= _SMEM_LIMIT
    if ln and not tiled:
        raise _f32_plan_error(name + " with LayerNorm", body, "calls whose "
                              f"shared memory fits {_SMEM_LIMIT} bytes",
                              f"{halo}")
    return dict(tile=(_TILE, _TILE), blocks=b * _tiles(h, w)
                * -(-cout // _CV_BN), smem=halo if tiled else gather)


def _halo_scratch(geo, x: torch.Tensor):
    """The device-memory LN halo of a float32 plan, None where the halo lives
    in shared memory (the caller holds it until the launch is queued; the
    allocator orders its reuse on the stream)."""
    if not geo["scratch"]:
        return None
    return torch.empty(geo["scratch"], dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# row 1: the fused conv-FFN half
# ---------------------------------------------------------------------------


_MAX_X2 = 5  # MAX_X2 of csrc/common.cuh


def _x2_operands(x, x2, po_w):
    """Addresses and batch strides (in elements) of the x2 maps, and their
    projection matrices stacked as one (M, B, C, C) or (M, C, C) tensor. A
    stacked (B, M, H, W, C) entry is read in place, map by map."""
    b, h, w, c = x.shape
    entries = ([] if x2 is None else
               list(x2) if isinstance(x2, (list, tuple)) else [x2])
    ptrs, strides = [], []
    for i, e in enumerate(entries):
        m = e.shape[1] if e.dim() == 5 else 1
        want = (b, m, h, w, c) if e.dim() == 5 else (b, h, w, c)
        base = _check(f"x2[{i}]", e, x, want)
        step = h * w * c
        ptrs += [base + j * step * e.element_size() for j in range(m)]
        strides += [m * step] * m
    pos = _po_list(po_w, len(ptrs))
    if len(ptrs) > _MAX_X2:
        raise ValueError(f"fused_block_ffn takes up to {_MAX_X2} x2 maps, "
                         f"got {len(ptrs)}")
    if len(ptrs) > 1 and pos is None:
        raise ValueError("several x2 maps need their po_w matrices")
    po, batched = None, False
    if pos is not None:
        batched = pos[0].dim() == 3
        for i, pw in enumerate(pos):
            _check(f"po_w[{i}]", pw, x, (b, c, c) if batched else (c, c))
        po = pos[0] if len(pos) == 1 else torch.stack(pos)
    pad = _MAX_X2 - len(ptrs)
    return (ptrs + [None] * pad, strides + [0] * pad, len(ptrs), po, batched)


# the wgmma body (csrc/ffn_wg.cu): its widths (lists of maps at the first
# two, the chained FFW at the first), its ring stages (WG_STAGE bytes each,
# up to WG_MAX_STAGES) and the parts of its shared memory beside them,
# mirrored from the source (a card test holds the two equal)
_WG_WIDTHS = (128, 256, 512)
_WG_LIST_WIDTHS = (128, 256)
_WG_FFW2_WIDTH = 128
_WG_STAGE, _WG_MAX_STAGES, _WG_ALIGN = 16384, 8, 1024
_WG_HALO, _WG_HS, _WG_PIXELS, _WG_XPAD = 100, 128, 64, 8


def _wg_smem(c: int, gate: bool) -> tuple[int, int]:
    """(bytes of shared memory, ring stages) of the wgmma body at width c:
    the LN(x') halo (100 rows of c + 8 bf16), the fp32 hidden chunk (100 x
    128), the activation chunk (64 pixels x 64 (gate) or 128 columns + 8,
    bf16), then as many ring stages, with their two mbarriers, as fit. The
    lists and the chained FFW take no more: a list stages each map's halo
    tile (100 x c bf16) in the hidden chunk's space before pw1, the chained
    FFW keeps y and LN2(y) (64 x (c + 8)) in the halo's space and its
    activation (64 x (2 c + 8)) in the hidden chunk's after the last
    chunk."""
    aw = 64 if gate else 128
    rest = (_WG_HALO * (c + _WG_XPAD) * 2 + _WG_HALO * _WG_HS * 4
            + _WG_PIXELS * (aw + _WG_XPAD) * 2)
    stages = min(_WG_MAX_STAGES,
                 (_SMEM_LIMIT - _WG_ALIGN - rest) // (_WG_STAGE + 16))
    return _WG_ALIGN + stages * _WG_STAGE + rest + 16 * stages, stages


# the C = 64 body (csrc/ffn_c64.cu): its output tile (16 rows x 8 columns,
# a halo of 18 x 10), ring slots (_C64_SLOT bytes each, 2 to
# _C64_MAX_STAGES) and the parts of its shared memory beside them, mirrored
# from the source (a card test holds the two equal)
_C64_TH, _C64_TW = 16, 8
_C64_SLOT, _C64_MAX_STAGES, _C64_MAX_MAPS = 23552, 4, 4
_C64_PANEL, _C64_NPH, _C64_HS, _C64_P = 8192, 180, 64, 128


def _c64_smem(ch: int, e: int, gate: bool, n_po: int, f: int
              ) -> tuple[int, int]:
    """(bytes of shared memory, ring slots) of the C = 64 body: the LN(x')
    halo (a slot's bytes), w1 (64 x ch), w2 (e x 64), the n_po po matrices,
    f_w1 and f_w2 (64 x f, f x 64), the fp32 hidden chunk (180 x 64), the
    activation chunk (128 pixels x 32 (gate) or 64 columns + 8, bf16), wd (9
    x ch), then as many ring slots, each with its mbarrier, as fit (0: fewer
    than two, the body does not take the call)."""
    aw = 32 if gate else 64
    rest = (_C64_SLOT + 128 * ch + 128 * e + n_po * _C64_PANEL + 256 * f
            + _C64_NPH * _C64_HS * 4 + _C64_P * (aw + _WG_XPAD) * 2 + 18 * ch)
    if rest + _WG_ALIGN >= _SMEM_LIMIT:
        return _WG_ALIGN + rest, 0
    stages = min(_C64_MAX_STAGES,
                 (_SMEM_LIMIT - _WG_ALIGN - rest) // (_C64_SLOT + 8))
    return _WG_ALIGN + stages * _C64_SLOT + rest + 8 * stages, stages


def _c64_tiles(h: int, w: int) -> int:
    return -(-h // _C64_TH) * -(-w // _C64_TW)


def _c64_walk(b: int, n_tiles: int, blocks: int) -> list[range]:
    """The persistent grid's walk: block g takes items [g T / G, (g + 1) T /
    G) of the T = b * n_tiles (batch entry, tile) items, entry-major (the
    kernel's it0, it1)."""
    total = b * n_tiles
    return [range(g * total // blocks, (g + 1) * total // blocks)
            for g in range(blocks)]


def _c64_form(c, ch, e, mode, n_x2, has_po, f) -> bool:
    """Whether a bf16 depthwise call has a form of the C = 64 body: no x2
    map (gate or gelu); one map or a list of up to _C64_MAX_MAPS with a po
    each, in gate mode; the chained FFW in gelu mode, no x2, f = 2 C."""
    gate = mode == "gate"
    if (c != 64 or mode not in ("gate", "gelu")
            or ch != (2 * e if gate else e) or e % (32 if gate else 64)):
        return False
    if f:
        return not gate and n_x2 == 0 and f == 2 * c
    return n_x2 == 0 or (has_po and gate and n_x2 <= _C64_MAX_MAPS)


# the body without a depthwise stage (csrc/ffn_pw.cu): its widths, its
# tile of pixels, its ring stages (_PW_STAGE bytes each, up to
# _PW_MAX_STAGES) and the parts of its shared memory beside them, mirrored
# from the source (a card test holds the two equal)
_PW_WIDTHS = (128, 256)
_PW_TP, _PW_STAGE, _PW_MAX_STAGES = 128, 16384, 8


def _pw_smem(c: int) -> tuple[int, int]:
    """(bytes of shared memory, ring stages) of the body without a depthwise
    stage at width c: the tiles of x and x2 (128 pixels x c bf16 each), four
    mbarriers, then as many ring stages, with their two mbarriers, as
    fit."""
    tiles = 2 * _PW_TP * c * 2
    stages = min(_PW_MAX_STAGES,
                 (_SMEM_LIMIT - _WG_ALIGN - tiles - 32) // (_PW_STAGE + 16))
    return _WG_ALIGN + tiles + stages * _PW_STAGE + 16 * stages + 32, stages


def _pw_form(c, ch, e, mode, n_x2, has_po, f) -> bool:
    """Whether a bf16 call without a depthwise stage has the form of
    csrc/ffn_pw.cu: the pointwise FFW (gelu, F = E = 2C, no chained FFW) at
    C = 128 or 256, with no x2 map or one with its po."""
    return (mode == "gelu" and c in _PW_WIDTHS and e == 2 * c and ch == e
            and not f and n_x2 == int(has_po))


def _ffn_plan(b, h, w, c, ch, e, mode, n_x2, has_po, po_batched, f, has_dw,
              dtype, n_sm: int = 132):
    """The body of one fused_block_ffn call, chosen by its shape: ("wg",
    geometry) for the wgmma body of csrc/ffn_wg.cu, ("c64", geometry) for
    the C = 64 body of csrc/ffn_c64.cu, ("pw", geometry) for the body
    without a depthwise stage of csrc/ffn_pw.cu, else ("tile", None) for the
    mma.sync body of csrc/ffn.cu. f: the chained FFW's hidden width (0:
    none). The wgmma body takes the bf16 calls with a depthwise stage, C in
    128 / 256 / 512 and E a multiple of 32 in three forms: at most one x2
    map; a list of x2 maps (gate, C = 128 or 256: the causal history
    model's call at dec3 and dec2); the chained FFW (gelu, no x2, C = 128,
    f = 2 C: enc2's ReducedAttn+FFW blocks). The C = 64 body takes the bf16
    depthwise calls at C = 64 in its forms (:func:`_c64_form`: the
    refinement's halves, dec1's Channel and CHM halves, enc1's
    ReducedAttn+FFW blocks; each measured faster there than on csrc/ffn.cu,
    PERF.md row 1). The body of
    csrc/ffn_pw.cu takes the bf16 calls without a depthwise stage in its
    form (:func:`_pw_form`: gopro_enc3_ffw's FFW passes at enc3). Everything
    else goes to csrc/ffn.cu: every float32 call (float32 serving; its
    limits are :func:`_ffn_f32_plan`'s), other widths and forms; its shared
    memory refuses bf16 lists at C = 512 (no path has them). The geometry: the
    output tiles, their count, the activation columns of a chunk, the ring
    stages and the shared memory; for the persistent bodies (C = 64, no
    depthwise stage) also the grid's blocks (one an SM, n_sm of them at
    most)."""
    del po_batched  # every body takes a shared or a per-batch matrix
    if dtype != torch.bfloat16:
        return "tile", None
    if not has_dw:
        if not _pw_form(c, ch, e, mode, n_x2, has_po, f):
            return "tile", None
        smem, stages = _pw_smem(c)
        n_tiles = b * -(-(h * w) // _PW_TP)
        return "pw", dict(tile=_PW_TP, tiles=n_tiles,
                          blocks=min(n_tiles, n_sm), chunk=64, stages=stages,
                          smem=smem)
    if c == 64:
        smem, stages = _c64_smem(ch, e, mode == "gate",
                                 n_x2 if has_po else 0, f)
        if not _c64_form(c, ch, e, mode, n_x2, has_po, f) or stages < 2:
            return "tile", None
        n_tiles = b * _c64_tiles(h, w)
        return "c64", dict(tile=(_C64_TH, _C64_TW), tiles=n_tiles,
                           blocks=min(n_tiles, n_sm),
                           chunk=32 if mode == "gate" else 64, stages=stages,
                           smem=smem)
    if (mode not in ("gate", "gelu")
            or c not in _WG_WIDTHS or e % 32
            or ch != (2 * e if mode == "gate" else e)
            or (has_po and n_x2 < 1)
            or (n_x2 > 1 and (mode != "gate" or c not in _WG_LIST_WIDTHS))
            or (f and (mode != "gelu" or n_x2 or c != _WG_FFW2_WIDTH
                       or f != 2 * c))):
        return "tile", None
    smem, stages = _wg_smem(c, mode == "gate")
    return "wg", dict(tile=_TILE, blocks=b * _tiles(h, w),
                      chunk=64 if mode == "gate" else 128, stages=stages,
                      smem=smem)


def _ffn_launch(x, x2, po_w, po_b, ln_w, ln_b, w1, b1, wd, bd, w2, b2, scale,
                mode, ffw2):
    _check_map("x", x)
    b, h, w, c = x.shape
    ch = w1.shape[1]
    e = ch // 2 if mode == "gate" else ch
    if mode not in ("gate", "gelu"):
        raise ValueError(f"unknown mode {mode!r}")
    if wd is None and bd is not None:
        raise ValueError("bd needs wd")
    _check_width("fused_block_ffn", x)
    if po_w is not None and x2 is None:
        raise ValueError("po_w needs x2")
    x2_ptrs, x2_strides, n_x2, po, po_batched = _x2_operands(x, x2, po_w)
    f = 0
    fp = [None] * 7
    if ffw2 is not None:
        f = ffw2["w1"].shape[1]
        if c > 128 or f > 2 * c or f % 16:
            raise ValueError("the chained FFW takes C <= 128 and F <= 2C, "
                             "F a multiple of 16")
        fp = [_check("ffw2.ln_w", ffw2["ln_w"], x, (c,)),
              _check("ffw2.ln_b", ffw2.get("ln_b"), x, (c,)),
              _check("ffw2.w1", ffw2["w1"], x, (c, f)),
              _check("ffw2.b1", ffw2["b1"], x, (f,)),
              _check("ffw2.w2", ffw2["w2"], x, (f, c)),
              _check("ffw2.b2", ffw2["b2"], x, (c,)),
              _check("ffw2.scale", ffw2["scale"], x, (c,))]
    halo = None  # float32's LN halo in device memory
    if x.dtype == torch.float32:  # raises before any launch if not taken
        halo = _halo_scratch(_ffn_f32_plan(b, h, w, c, n_x2, f), x)
    out = torch.empty_like(x)
    ptrs = [
        _check("x", x, x), _check("po_w", po, x),
        _check("po_b", po_b, x, (c,)), _check("ln_w", ln_w, x, (c,)),
        _check("ln_b", ln_b, x, (c,)), _check("w1", w1, x, (c, ch)),
        _check("b1", b1, x, (ch,)), _check("wd", wd, x, (3, 3, ch)),
        _check("bd", bd, x, (ch,)), _check("w2", w2, x, (e, c)),
        _check("b2", b2, x, (c,)), _check("scale", scale, x, (c,)),
        *fp, out.data_ptr(), *x2_ptrs]
    body, geo = _ffn_plan(b, h, w, c, ch, e, mode, n_x2, po is not None,
                          po_batched, f, wd is not None, x.dtype,
                          _sm_count(x.device))
    ints = [b, h, w, c, ch, e, f, int(mode == "gate"), int(po_batched), n_x2,
            *x2_strides]
    if body == "wg":  # its shared memory fits by construction (_wg_smem)
        _call(build.load("ffn_wg").turtle_ffn_wg_launch, ptrs, ints, x,
              "fused_block_ffn")
        fused_block_ffn.launches_wg += 1
    elif body == "c64":  # likewise (_c64_smem)
        _call(build.load("ffn_c64").turtle_ffn_c64_launch, ptrs,
              ints + [geo["blocks"]], x, "fused_block_ffn")
        fused_block_ffn.launches_c64 += 1
    elif body == "pw":  # likewise (_pw_smem)
        _call(build.load("ffn_pw").turtle_ffn_pw_launch, ptrs,
              ints + [geo["blocks"]], x, "fused_block_ffn")
        fused_block_ffn.launches_pw += 1
    else:
        lib = build.load("ffn")
        _check_smem("fused_block_ffn", lib.turtle_ffn_smem(
            c, f, int(ffw2 is not None), int(x.dtype == torch.bfloat16), n_x2))
        _call(lib.turtle_ffn_launch, ptrs + [_check("halo", halo, x)], ints,
              x, "fused_block_ffn")
    fused_block_ffn.launches += 1
    fused_block_ffn.launches_no_dw += wd is None
    return out


def fused_block_ffn(x, *, x2=None, po_w=None, po_b=None, ln_w, ln_b=None,
                    w1, b1=None, wd=None, bd=None, w2, b2=None, scale=None,
                    mode: str, ffw2=None):
    """out = x' + scale * (pw2(act(dw3x3(pw1(LN x') + b1) + bd)) + b2) with
    x' = x + sum_j x2_j @ po_w_j (+ po_b once), in one pass over the map.

    Replaces ``fused_block_ffn`` of turtlevsr_tpu/kernels/ffn.py, both its
    dw branch and (``wd=None``: no depthwise stage) its no-dw branch; on an
    H100 bound by operations at C >= 128 and by bytes at C = 64. Four
    kernels, chosen by shape before the launch (:func:`_ffn_plan`): the
    wgmma body of csrc/ffn_wg.cu for bf16 calls with a depthwise stage,
    C = 128, 256 or 512 and a hidden width E that is a multiple of 32 (at
    most one x2 map; or a list of maps in gate mode at C = 128, 256; or
    ``ffw2`` in gelu mode at C = 128 with F = 2C, no x2;
    ``fused_block_ffn.launches_wg`` counts them); the C = 64 body of
    csrc/ffn_c64.cu (a persistent grid, the weights resident in shared
    memory, halo tiles of 16 x 8 outputs by TMA, wgmma) for bf16 calls with
    a depthwise stage at C = 64 in the serving forms (no x2 map, or one or a
    list of up to 4 with a po each in gate mode, or ``ffw2`` in gelu mode
    with F = 2C; ``fused_block_ffn.launches_c64`` counts them); the body of
    csrc/ffn_pw.cu (a persistent grid over tiles of 128 pixels, the weights
    through a TMA ring, wgmma, no halo) for bf16 calls without a depthwise
    stage in gelu mode, C = 128 or 256, F = 2C, no x2 map or one with its
    po (``fused_block_ffn.launches_pw`` counts them); the mma.sync body of
    csrc/ffn.cu for every other call (float32 serving up to C = 512, other
    forms). A call is one launch either way.
    x2: optional second addend map (the attention branch); po_w (C, C) or
    per batch (B, C, C) and po_b: optional projection applied to x2 in the
    kernel. x2 may also be a list of up to 5 maps, an entry being a map or
    a stacked (B, M, H, W, C) tensor whose M maps are read in place; po_w is
    then a list of one matrix per map (the value maps of the causal history
    model with their attention folded into the matrices). Each product is
    rounded to the map's type, the sum over the maps runs in fp32. mode: 'gate' (gelu(a) * b on the
    halves of the hidden axis, w2 (CH/2, C)) or 'gelu' (w2 (CH, C)). ffw2:
    optional dict {ln_w, ln_b?, w1 (C, F), b1, w2 (F, C), b2, scale}: a
    pointwise FFW chained on the output y, rounded to the map's type first.
    """
    if x.device.type == "cpu":
        return ffn_plain(x, x2=x2, po_w=po_w, po_b=po_b, ln_w=ln_w,
                         ln_b=ln_b, w1=w1, b1=b1, wd=wd, bd=bd, w2=w2, b2=b2,
                         scale=scale, mode=mode, ffw2=ffw2)
    _need_cuda("fused_block_ffn", x)
    return _ffn_launch(x, x2, po_w, po_b, ln_w, ln_b, w1, b1, wd, bd, w2, b2,
                       scale, mode, ffw2)


fused_block_ffn.launches = 0
fused_block_ffn.launches_no_dw = 0  # those of them without a depthwise stage
fused_block_ffn.launches_wg = 0  # those of them on the wgmma body (ffn_wg.cu)
fused_block_ffn.launches_c64 = 0  # those of them on the C = 64 body (ffn_c64.cu)
fused_block_ffn.launches_pw = 0  # those without dw on the body of ffn_pw.cu


# ---------------------------------------------------------------------------
# row 3: q/k/v chains + channel-attention statistics
# ---------------------------------------------------------------------------

_REDUCE_GROUPS = 64


def _reduce_rows(part: torch.Tensor, what: str) -> torch.Tensor:
    """(B, rows, width) partial rows -> (B, width): the fixed-order sum of
    the rows (one a tile, or one a block of the persistent grid), in two
    passes."""
    b, rows, width = part.shape
    lib = build.load("qkv_stats")
    while rows > 1:
        per = -(-rows // _REDUCE_GROUPS) if rows > _REDUCE_GROUPS else rows
        groups = -(-rows // per)
        nxt = torch.empty((b, groups, width), dtype=torch.float32,
                          device=part.device)
        rc = lib.turtle_reduce_rows(part.data_ptr(), nxt.data_ptr(), b, rows,
                                    per, width, _stream(part))
        if rc != 0:
            raise RuntimeError(f"{what}: reduction launch failed with code "
                               f"{rc}")
        part, rows = nxt, groups
    return part[:, 0]


# the wgmma body of the statistics (csrc/stats_wg.cuh): the widths the plans
# send to it, its ring stages (_SW_STAGE bytes each, up to _SW_MAX_STAGES) and
# the parts of its shared memory beside them, mirrored from the source (a
# card test holds the two equal)
_QKV_WG_WIDTHS = (64, 128, 256, 512)
_CHM_WG_WIDTHS = (64, 128, 256)
_SW_STAGE, _SW_MAX_STAGES, _SW_TILE = 16384, 8, 8192


def _sw_smem(c: int, chm: bool) -> tuple[int, int]:
    """(bytes of shared memory, ring stages) of the statistics' wgmma body
    at width c: the q tiles (one, or one a head for row 6) and k tiles (one,
    two for row 6) of 64 pixels x 64 bf16, the fp32 hidden chunk (100 x 128),
    the LN halo (100 rows of c + 8 bf16), then as many ring stages, with
    their two mbarriers, as fit."""
    tiles = (c // 64 + 2) if chm else 2
    rest = (tiles * _SW_TILE + _WG_HALO * _WG_HS * 4
            + _WG_HALO * (c + _WG_XPAD) * 2)
    stages = min(_SW_MAX_STAGES,
                 (_SMEM_LIMIT - _WG_ALIGN - rest) // (_SW_STAGE + 16))
    return _WG_ALIGN + stages * _SW_STAGE + rest + 16 * stages, stages


def _sw_rows(b: int, n_tiles: int, blocks: int) -> int:
    """Partial rows a batch entry gets from the persistent grid: block g
    walks items [g T / G, (g + 1) T / G) of the T = b * n_tiles (entry,
    tile) items and owns one row of each entry its range meets (the
    kernel's sw_first_block); the most any entry gets (the others' last
    rows stay zero)."""
    total = b * n_tiles

    def block_of(i):
        return ((i + 1) * blocks - 1) // total

    return max(block_of((e + 1) * n_tiles - 1) - block_of(e * n_tiles) + 1
               for e in range(b))


def _sw_geometry(b, h, w, c, chm, n_sm):
    smem, stages = _sw_smem(c, chm)
    n_tiles = _tiles(h, w)
    blocks = min(b * n_tiles, n_sm)
    return dict(tile=_TILE, blocks=blocks,
                rows=_sw_rows(b, n_tiles, blocks), stages=stages, smem=smem)


def _qkv_plan(b, h, w, c, heads, has_bias, dtype, n_sm: int = 132):
    """The body of one fused_qkv_stats call, chosen by its shape: ("wg",
    geometry) for the wgmma body of csrc/qkv_wg.cu (bf16, C in 64 / 128 /
    256 / 512, 64 channels a head, no b1 or bd: the shipped form),
    else ("tile", None) for the mma.sync body of csrc/qkv_stats.cu. The
    geometry: 8 x 8 tiles, the persistent grid (one block an SM, n_sm of
    them at most), the partial rows of a batch entry, the ring stages and
    the shared memory."""
    if (dtype != torch.bfloat16 or has_bias or c not in _QKV_WG_WIDTHS
            or c != 64 * heads):
        return "tile", None
    return "wg", _sw_geometry(b, h, w, c, False, n_sm)


def _chm_plan(b, h, w, c, heads, dtype, n_sm: int = 132):
    """The body of one fused_chm_stats call: ("wg", geometry) for the wgmma
    body of csrc/chm_wg.cu (bf16, C in 64 / 128 / 256, 64 channels a head),
    else ("tile", None) for csrc/chm_stats.cu; as :func:`_qkv_plan`."""
    if dtype != torch.bfloat16 or c not in _CHM_WG_WIDTHS or c != 64 * heads:
        return "tile", None
    return "wg", _sw_geometry(b, h, w, c, True, n_sm)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _qkv_stats_launch(x, ln_w, ln_b, w1, b1, wd, bd, heads):
    _check_map("x", x)
    b, h, w, c = x.shape
    _check_width("fused_qkv_stats", x)
    if c % heads or c // heads > 64:
        raise ValueError("fused_qkv_stats takes C / heads <= 64, got "
                         f"C={c}, heads={heads}")
    ctok = c // heads
    width = heads * ctok * ctok + 2 * c
    v = torch.empty_like(x)
    ptrs = [_check("x", x, x), _check("ln_w", ln_w, x, (c,)),
            _check("ln_b", ln_b, x, (c,)), _check("w1", w1, x, (c, 3 * c)),
            _check("b1", b1, x, (3 * c,)), _check("wd", wd, x, (3, 3, 3 * c)),
            _check("bd", bd, x, (3 * c,)), v.data_ptr()]
    body, geo = _qkv_plan(b, h, w, c, heads, b1 is not None or bd is not None,
                          x.dtype, _sm_count(x.device))
    halo = None  # float32's LN halo in device memory
    if x.dtype == torch.float32:  # raises before any launch if not taken
        halo = _halo_scratch(_qkv_f32_plan(b, h, w, c, heads), x)
    if body == "wg":  # its shared memory fits by construction (_sw_smem)
        part = torch.zeros((b, geo["rows"], width), dtype=torch.float32,
                           device=x.device)
        _call(build.load("qkv_wg").turtle_qkv_wg_launch,
              ptrs[:4] + [ptrs[5], v.data_ptr(), part.data_ptr()],
              [b, h, w, c, heads, geo["rows"], geo["blocks"]], x,
              "fused_qkv_stats")
        fused_qkv_stats.launches_wg += 1
    else:
        part = torch.empty((b, _tiles(h, w), width), dtype=torch.float32,
                           device=x.device)
        lib = build.load("qkv_stats")
        _check_smem("fused_qkv_stats", lib.turtle_qkv_stats_smem(
            c, heads, int(x.dtype == torch.bfloat16)))
        _call(lib.turtle_qkv_stats_launch,
              ptrs + [part.data_ptr(), _check("halo", halo, x)],
              [b, h, w, c, heads], x, "fused_qkv_stats")
    tot = _reduce_rows(part, "fused_qkv_stats")
    fused_qkv_stats.launches += 1
    gram = tot[:, :heads * ctok * ctok].reshape(b, heads, ctok, ctok)
    stats = tot[:, heads * ctok * ctok:].reshape(b, 2, c)
    return v, gram, stats


def fused_qkv_stats(x, *, ln_w, ln_b=None, w1, b1=None, wd, bd=None,
                    heads: int):
    """LN + the q/k/v chains dw3x3(pw1(LN x)) of channel attention from one
    read of x; returns (v map (B, H, W, C), Gram (B, heads, ctok, ctok) fp32
    with gram[b, h] = q_h^T k_h over all pixels, stats (B, 2, C) fp32 =
    [sum q^2, sum k^2] per channel). w1 (C, 3C), wd (3, 3, 3C) hold q, k, v
    side by side.

    Replaces ``fused_qkv_stats`` in turtlevsr_tpu/kernels/ffn.py; bound by
    operations on an H100. Two kernels, chosen by shape before the launch
    (:func:`_qkv_plan`): the wgmma body of csrc/qkv_wg.cu for bf16 calls with
    64 channels a head, C = 64, 128, 256 or 512 and no b1 or bd
    (``fused_qkv_stats.launches_wg`` counts them), csrc/qkv_stats.cu for
    every other call; either way one launch and a fixed-order sum of partial
    rows, bitwise repeatable. Only the per-head diagonal blocks of that
    kernel's (C, C) Gram are computed: the attention reads nothing else."""
    if x.device.type == "cpu":
        return qkv_stats_plain(x, ln_w=ln_w, ln_b=ln_b, w1=w1, b1=b1, wd=wd,
                               bd=bd, heads=heads)
    _need_cuda("fused_qkv_stats", x)
    return _qkv_stats_launch(x, ln_w, ln_b, w1, b1, wd, bd, heads)


fused_qkv_stats.launches = 0
fused_qkv_stats.launches_wg = 0  # those of them on the wgmma body (qkv_wg.cu)


# ---------------------------------------------------------------------------
# row 4: N projection chains from one read
# ---------------------------------------------------------------------------


# the wgmma body of the split projection (csrc/split_wg.cu): the widths the
# plan sends to it (C = 64 has a body of its own, csrc/split_c64.cu: the
# 8 x 8 tiles of split_wg.cu measured slower than split_proj.cu there on an
# H100, PERF.md row 4); its ring stages and the parts of its shared memory
# beside them, mirrored from the source (a card test holds the two equal)
_SPLIT_WG_WIDTHS = (128, 256, 512)


def _spw_smem(c: int) -> tuple[int, int]:
    """(bytes of shared memory, ring stages) of the split projection's wgmma
    body at width c: the fp32 hidden chunk (100 x 128), the LN halo (100
    rows of c + 8 bf16), at c <= 256 the next tile's staged halo of x (100
    rows of c bf16), then as many ring stages, with their two mbarriers, as
    fit."""
    rest = (_WG_HALO * _WG_HS * 4 + _WG_HALO * (c + _WG_XPAD) * 2
            + (_WG_HALO * c * 2 if c <= 256 else 0))
    stages = min(_SW_MAX_STAGES,
                 (_SMEM_LIMIT - _WG_ALIGN - rest) // (_SW_STAGE + 16))
    return _WG_ALIGN + stages * _SW_STAGE + rest + 16 * stages, stages


def _sc_smem(n_out: int) -> tuple[int, int]:
    """(bytes of shared memory, ring slots) of the split projection's C = 64
    body (csrc/split_c64.cu): the LN halo (a slot's bytes), w1 (64 x 64
    n_out), two fp32 hidden chunks (180 x 64 each), wd (9 x 64 n_out), then
    as many ring slots of ffn_c64.cu's size, each with its mbarrier, as fit
    (up to _C64_MAX_STAGES); mirrored from the source (a card test holds the
    two equal)."""
    rest = (_C64_SLOT + n_out * _C64_PANEL + 2 * _C64_NPH * _C64_HS * 4
            + 18 * 64 * n_out)
    stages = min(_C64_MAX_STAGES,
                 (_SMEM_LIMIT - _WG_ALIGN - rest) // (_C64_SLOT + 8))
    return _WG_ALIGN + stages * _C64_SLOT + rest + 8 * stages, stages


def _split_plan(b, h, w, c, e, n_out, has_ln, has_bias, dtype,
                n_sm: int = 132):
    """The body of one fused_ln_split_proj call, chosen by its shape: ("wg",
    geometry) for the wgmma body of csrc/split_wg.cu (bf16, LayerNorm, no b1
    or bd, E = C in _SPLIT_WG_WIDTHS, n_out * E a multiple of 128: the
    latent FHR q, k, v and the SAB q, k at dec3 and dec2), ("c64",
    geometry) for the C = 64 body of csrc/split_c64.cu (bf16, LayerNorm, no
    b1 or bd, E = C = 64: dec1's SAB q, k), else ("tile", None) for the
    mma.sync body of csrc/split_proj.cu. The geometry: the output tiles (8 x
    8; 16 x 8 at C = 64), the persistent grid (one block an SM, n_sm of them
    at most), the ring stages and the shared memory; for the wgmma body also
    the 128-column passes of a tile, for the C = 64 body the tiles'
    count."""
    if (dtype != torch.bfloat16 or not has_ln or has_bias or e != c
            or not 1 <= n_out <= 4):
        return "tile", None
    if c == 64:
        smem, stages = _sc_smem(n_out)
        n_tiles = b * _c64_tiles(h, w)
        return "c64", dict(tile=(_C64_TH, _C64_TW), tiles=n_tiles,
                           blocks=min(n_tiles, n_sm), stages=stages,
                           smem=smem)
    if c not in _SPLIT_WG_WIDTHS or (n_out * e) % 128:
        return "tile", None
    smem, stages = _spw_smem(c)
    return "wg", dict(tile=_TILE, blocks=min(b * _tiles(h, w), n_sm),
                      passes=n_out * e // 128, stages=stages, smem=smem)


def _split_proj_launch(x, ln_w, ln_b, w1, b1, wd, bd, n_out):
    _check_map("x", x)
    b, h, w, c = x.shape
    ch = w1.shape[1]
    _check_width("fused_ln_split_proj", x)
    if ln_w is None and ln_b is not None:
        raise ValueError("ln_b needs ln_w")
    if ch % n_out or not 1 <= n_out <= 4:
        raise ValueError("fused_ln_split_proj takes 1..4 maps of equal "
                         "width")
    e = ch // n_out
    outs = [torch.empty((b, h, w, e), dtype=x.dtype, device=x.device)
            for _ in range(n_out)]
    ptrs = [_check("x", x, x), _check("ln_w", ln_w, x, (c,)),
            _check("ln_b", ln_b, x, (c,)), _check("w1", w1, x, (c, ch)),
            _check("b1", b1, x, (ch,)), _check("wd", wd, x, (3, 3, ch)),
            _check("bd", bd, x, (ch,)),
            *[o.data_ptr() for o in outs], *[None] * (4 - n_out)]
    body, geo = _split_plan(b, h, w, c, e, n_out, ln_w is not None,
                            b1 is not None or bd is not None, x.dtype,
                            _sm_count(x.device))
    halo = None  # float32's LN halo in device memory
    if x.dtype == torch.float32:  # raises before any launch if not taken
        halo = _halo_scratch(_split_f32_plan(b, h, w, c), x)
    if body == "wg":  # its shared memory fits by construction (_spw_smem)
        _call(build.load("split_wg").turtle_split_wg_launch,
              ptrs[:4] + ptrs[5:6] + ptrs[7:],
              [b, h, w, c, e, n_out, geo["blocks"]], x, "fused_ln_split_proj")
        fused_ln_split_proj.launches_wg += 1
    elif body == "c64":  # likewise (_sc_smem)
        _call(build.load("split_c64").turtle_split_c64_launch,
              ptrs[:4] + ptrs[5:6] + ptrs[7:],
              [b, h, w, c, e, n_out, geo["blocks"]], x, "fused_ln_split_proj")
        fused_ln_split_proj.launches_c64 += 1
    else:
        lib = build.load("split_proj")
        _check_smem("fused_ln_split_proj", lib.turtle_split_proj_smem(
            c, int(x.dtype == torch.bfloat16)))
        _call(lib.turtle_split_proj_launch, ptrs + [_check("halo", halo, x)],
              [b, h, w, c, e, n_out], x, "fused_ln_split_proj")
    fused_ln_split_proj.launches += 1
    return tuple(outs)


def fused_ln_split_proj(x, *, ln_w=None, ln_b=None, w1, b1=None, wd, bd=None,
                        n_out: int):
    """n_out chains dw3x3(pw1(LN x)) from one read of x, each its own
    (B, H, W, E) map; w1 (C, n_out * E), wd (3, 3, n_out * E) hold the chains
    side by side. Without ``ln_w`` the chains run on x itself.

    Replaces ``fused_ln_split_proj`` in turtlevsr_tpu/kernels/ffn.py; bound
    by operations on an H100 at C >= 256, by bytes at C <= 128. Three
    kernels, chosen by shape before the launch (:func:`_split_plan`): the
    wgmma body of csrc/split_wg.cu for bf16 calls with LayerNorm, no b1 or bd
    and E = C = 128, 256 or 512 (``fused_ln_split_proj.launches_wg`` counts
    them), the C = 64 body of csrc/split_c64.cu for those at E = C = 64
    (``fused_ln_split_proj.launches_c64``), csrc/split_proj.cu for every
    other call; one launch either way."""
    if x.device.type == "cpu":
        return split_proj_plain(x, ln_w=ln_w, ln_b=ln_b, w1=w1, b1=b1, wd=wd,
                                bd=bd, n_out=n_out)
    _need_cuda("fused_ln_split_proj", x)
    return _split_proj_launch(x, ln_w, ln_b, w1, b1, wd, bd, n_out)


fused_ln_split_proj.launches = 0
fused_ln_split_proj.launches_wg = 0  # those of them on the wgmma body (split_wg.cu)
fused_ln_split_proj.launches_c64 = 0  # those on the C = 64 body (split_c64.cu)


# ---------------------------------------------------------------------------
# row 5: dense 3x3 convolution
# ---------------------------------------------------------------------------


def _conv3x3_launch(x, weight, bias, ln_w, ln_b):
    _check_map("x", x)
    b, h, w, cin = x.shape
    if weight.dim() != 4 or tuple(weight.shape[:3]) != (3, 3, cin):
        raise ValueError(f"weight must be (3, 3, {cin}, Cout), got "
                         f"{tuple(weight.shape)}")
    cout = weight.shape[3]
    if ln_w is None and ln_b is not None:
        raise ValueError("ln_b needs ln_w")
    if ln_w is not None:
        _check_width("fused_conv3x3 with LayerNorm", x)
    if x.dtype == torch.float32:  # raises before any launch if not taken
        _conv_f32_plan(b, h, w, cin, cout, ln_w is not None)
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    ptrs = [_check("x", x, x), _check("weight", weight, x),
            _check("bias", bias, x, (cout,)), out.data_ptr(),
            _check("ln_w", ln_w, x, (cin,)), _check("ln_b", ln_b, x, (cin,))]
    lib = build.load("conv3x3")
    _check_smem("fused_conv3x3", lib.turtle_conv3x3_smem(
        cin, int(x.dtype == torch.bfloat16)))
    _call(lib.turtle_conv3x3_launch, ptrs, [b, h, w, cin, cout], x,
          "fused_conv3x3")
    fused_conv3x3.launches += 1
    return out


def fused_conv3x3(x, weight, bias=None, *, ln_w=None, ln_b=None):
    """3x3 stride-1 pad-1 dense conv on an NHWC map; weight
    (3, 3, Cin, Cout). With ``ln_w`` (and ``ln_b``) the conv runs on the
    channel LayerNorm of x, zero-padded after the LayerNorm.

    Replaces ``fused_conv3x3`` in turtlevsr_tpu/kernels/ffn.py (kernel:
    csrc/conv3x3.cu; bound by operations at the wide levels, by bytes at
    the 3-channel ends)."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias, ln_w=ln_w, ln_b=ln_b)
    _need_cuda("fused_conv3x3", x)
    return _conv3x3_launch(x, weight, bias, ln_w, ln_b)


fused_conv3x3.launches = 0


# ---------------------------------------------------------------------------
# row 6: the causal history model's projections and statistics
# ---------------------------------------------------------------------------


def _chm_stats_launch(x, x_sp, ln_w, ln_b, w_qkv, wd_qkv, w_kv, wd_kv, heads):
    _check_map("x", x)
    b, h, w, c = x.shape
    _check_width("fused_chm_stats", x)
    if x_sp.dim() != 5 or x_sp.shape[1] < 1:
        raise ValueError("x_sp must be (B, NF, H, W, C) with NF >= 1")
    nf = x_sp.shape[1]
    if c % heads or c // heads > 64:
        raise ValueError("fused_chm_stats takes C / heads <= 64, got "
                         f"C={c}, heads={heads}")
    ctok = c // heads
    n_g = heads * ctok * ctok
    width = (nf + 1) * n_g + (nf + 2) * c
    v = torch.empty_like(x)
    vh = torch.empty_like(x_sp)
    ptrs = [_check("x", x, x), _check("x_sp", x_sp, x, (b, nf, h, w, c)),
            _check("ln_w", ln_w, x, (c,)), _check("ln_b", ln_b, x, (c,)),
            _check("w_qkv", w_qkv, x, (c, 3 * c)),
            _check("wd_qkv", wd_qkv, x, (3, 3, 3 * c)),
            _check("w_kv", w_kv, x, (c, 2 * c)),
            _check("wd_kv", wd_kv, x, (3, 3, 2 * c)),
            v.data_ptr(), vh.data_ptr()]
    body, geo = _chm_plan(b, h, w, c, heads, x.dtype, _sm_count(x.device))
    halo = None  # float32's LN halo in device memory
    if x.dtype == torch.float32:  # raises before any launch if not taken
        halo = _halo_scratch(_chm_f32_plan(b, h, w, c, heads, nf), x)
    if body == "wg":  # its shared memory fits by construction (_sw_smem)
        part = torch.zeros((b, geo["rows"], width), dtype=torch.float32,
                           device=x.device)
        _call(build.load("chm_wg").turtle_chm_wg_launch,
              ptrs + [part.data_ptr()],
              [b, h, w, c, heads, nf, geo["rows"], geo["blocks"]], x,
              "fused_chm_stats")
        fused_chm_stats.launches_wg += 1
    else:
        part = torch.empty((b, _tiles(h, w), width), dtype=torch.float32,
                           device=x.device)
        lib = build.load("chm_stats")
        _check_smem("fused_chm_stats", lib.turtle_chm_stats_smem(
            c, heads, int(x.dtype == torch.bfloat16)))
        _call(lib.turtle_chm_stats_launch,
              ptrs + [part.data_ptr(), _check("halo", halo, x)],
              [b, h, w, c, heads, nf], x, "fused_chm_stats")
    tot = _reduce_rows(part, "fused_chm_stats")
    fused_chm_stats.launches += 1
    g = tot[:, :n_g].reshape(b, heads, ctok, ctok)
    gh = tot[:, n_g:(nf + 1) * n_g].reshape(b, nf, heads, ctok, ctok)
    stats = tot[:, (nf + 1) * n_g:].reshape(b, nf + 2, c)
    return v, vh, g, gh, stats


def fused_chm_stats(x, x_sp, *, ln_w, ln_b=None, w_qkv, wd_qkv, w_kv, wd_kv,
                    heads: int):
    """One pass over the current map x (B, H, W, C) and the NF aligned frames
    x_sp (B, NF, H, W, C): q, k, v = dw3x3(pw1(LN x)) through w_qkv (C, 3C),
    wd_qkv (3, 3, 3C); kh_n, vh_n = dw3x3(pw1(x_sp[n])) through w_kv (C, 2C),
    wd_kv (3, 3, 2C), without LayerNorm. Returns (v (B, H, W, C),
    vh (B, NF, H, W, C), g (B, heads, ctok, ctok) fp32 = q_h^T k_h,
    gh (B, NF, heads, ctok, ctok) fp32 = q_h^T kh_n,h, stats (B, NF + 2, C)
    fp32 = the per-channel sums of q^2, k^2 and each kh_n^2). No biases.

    Replaces ``fused_chm_stats`` in turtlevsr_tpu/kernels/ffn.py; bound by
    operations on an H100. Two kernels, chosen by shape (:func:`_chm_plan`):
    the wgmma body of csrc/chm_wg.cu for bf16 calls with 64 channels a head
    and C = 64, 128 or 256 (``fused_chm_stats.launches_wg`` counts them),
    csrc/chm_stats.cu for every other call. Only the per-head diagonal blocks
    of that kernel's (C, C) Grams are computed."""
    if x.device.type == "cpu":
        return chm_stats_plain(x, x_sp, ln_w=ln_w, ln_b=ln_b, w_qkv=w_qkv,
                               wd_qkv=wd_qkv, w_kv=w_kv, wd_kv=wd_kv,
                               heads=heads)
    _need_cuda("fused_chm_stats", x)
    return _chm_stats_launch(x, x_sp, ln_w, ln_b, w_qkv, wd_qkv, w_kv, wd_kv,
                             heads)


fused_chm_stats.launches = 0
fused_chm_stats.launches_wg = 0  # those of them on the wgmma body (chm_wg.cu)
