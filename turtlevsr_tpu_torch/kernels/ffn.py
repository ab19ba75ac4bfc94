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
without a depthwise stage.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from turtlevsr_tpu_torch.kernels import build
from turtlevsr_tpu_torch.ops.attn_utils import acc_dtype
from turtlevsr_tpu_torch.ops.norm import LN_EPS

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_SMEM_LIMIT = 232448  # dynamic shared memory a block can have on sm_90
_TILE = 8


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


def _dw_acc(h, wd, bd):
    """Depthwise 3x3, zero padding of the hidden map, as nine shifted
    multiply-adds in h's type (taps in row-major order, then the bias)."""
    b, hh, ww, ch = h.shape
    hp = F.pad(h, (0, 0, 1, 1, 1, 1))
    out = torch.zeros_like(h)
    for ty in range(3):
        for tx in range(3):
            out = out + hp[:, ty:ty + hh, tx:tx + ww, :] * wd[ty, tx].to(h.dtype)
    if bd is not None:
        out = out + bd.to(h.dtype)
    return out


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
    """The chain kernels take C % 16 == 0 up to 512 in bfloat16 and up to
    128 in float32 (the type of the tight comparisons, not of serving)."""
    c = x.shape[-1]
    top = 512 if x.dtype == torch.bfloat16 else 128
    if c % 16 or c > top:
        raise ValueError(f"{name}: C must be a multiple of 16 up to {top} "
                         f"for {x.dtype}, got {c}")


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
    out = torch.empty_like(x)
    ptrs = [
        _check("x", x, x), _check("po_w", po, x),
        _check("po_b", po_b, x, (c,)), _check("ln_w", ln_w, x, (c,)),
        _check("ln_b", ln_b, x, (c,)), _check("w1", w1, x, (c, ch)),
        _check("b1", b1, x, (ch,)), _check("wd", wd, x, (3, 3, ch)),
        _check("bd", bd, x, (ch,)), _check("w2", w2, x, (e, c)),
        _check("b2", b2, x, (c,)), _check("scale", scale, x, (c,)),
        *fp, out.data_ptr(), *x2_ptrs]
    lib = build.load("ffn")
    _check_smem("fused_block_ffn", lib.turtle_ffn_smem(
        c, f, int(ffw2 is not None), int(x.dtype == torch.bfloat16), n_x2))
    _call(lib.turtle_ffn_launch, ptrs,
          [b, h, w, c, ch, e, f, int(mode == "gate"), int(po_batched), n_x2,
           *x2_strides], x, "fused_block_ffn")
    fused_block_ffn.launches += 1
    fused_block_ffn.launches_no_dw += wd is None
    return out


def fused_block_ffn(x, *, x2=None, po_w=None, po_b=None, ln_w, ln_b=None,
                    w1, b1=None, wd=None, bd=None, w2, b2=None, scale=None,
                    mode: str, ffw2=None):
    """out = x' + scale * (pw2(act(dw3x3(pw1(LN x') + b1) + bd)) + b2) with
    x' = x + sum_j x2_j @ po_w_j (+ po_b once), in one pass over the map.

    Replaces ``fused_block_ffn`` of turtlevsr_tpu/kernels/ffn.py, both its
    dw branch and (``wd=None``: no depthwise stage) its no-dw branch (kernel:
    csrc/ffn.cu; on an H100 bound by operations at C >= 128 and by bytes at
    C = 64, see the note there).
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


# ---------------------------------------------------------------------------
# row 3: q/k/v chains + channel-attention statistics
# ---------------------------------------------------------------------------

_REDUCE_GROUPS = 64


def _reduce_rows(part: torch.Tensor, what: str) -> torch.Tensor:
    """(B, n_tiles, width) partial rows -> (B, width): the fixed-order sum
    of the tiles' rows, in two passes."""
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


def _qkv_stats_launch(x, ln_w, ln_b, w1, b1, wd, bd, heads):
    _check_map("x", x)
    b, h, w, c = x.shape
    _check_width("fused_qkv_stats", x)
    if c % heads or c // heads > 64:
        raise ValueError("fused_qkv_stats takes C / heads <= 64, got "
                         f"C={c}, heads={heads}")
    ctok = c // heads
    width = heads * ctok * ctok + 2 * c
    n_tiles = _tiles(h, w)
    v = torch.empty_like(x)
    part = torch.empty((b, n_tiles, width), dtype=torch.float32,
                       device=x.device)
    ptrs = [_check("x", x, x), _check("ln_w", ln_w, x, (c,)),
            _check("ln_b", ln_b, x, (c,)), _check("w1", w1, x, (c, 3 * c)),
            _check("b1", b1, x, (3 * c,)), _check("wd", wd, x, (3, 3, 3 * c)),
            _check("bd", bd, x, (3 * c,)), v.data_ptr(), part.data_ptr()]
    lib = build.load("qkv_stats")
    _check_smem("fused_qkv_stats", lib.turtle_qkv_stats_smem(
        c, heads, int(x.dtype == torch.bfloat16)))
    _call(lib.turtle_qkv_stats_launch, ptrs, [b, h, w, c, heads], x,
          "fused_qkv_stats")
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

    Replaces ``fused_qkv_stats`` in turtlevsr_tpu/kernels/ffn.py (kernel:
    csrc/qkv_stats.cu; bound by operations on an H100). Only the per-head
    diagonal blocks of that kernel's (C, C) Gram are computed: the attention
    reads nothing else."""
    if x.device.type == "cpu":
        return qkv_stats_plain(x, ln_w=ln_w, ln_b=ln_b, w1=w1, b1=b1, wd=wd,
                               bd=bd, heads=heads)
    _need_cuda("fused_qkv_stats", x)
    return _qkv_stats_launch(x, ln_w, ln_b, w1, b1, wd, bd, heads)


fused_qkv_stats.launches = 0


# ---------------------------------------------------------------------------
# row 4: N projection chains from one read
# ---------------------------------------------------------------------------


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
    lib = build.load("split_proj")
    _check_smem("fused_ln_split_proj", lib.turtle_split_proj_smem(
        c, int(x.dtype == torch.bfloat16)))
    _call(lib.turtle_split_proj_launch, ptrs, [b, h, w, c, e, n_out], x,
          "fused_ln_split_proj")
    fused_ln_split_proj.launches += 1
    return tuple(outs)


def fused_ln_split_proj(x, *, ln_w=None, ln_b=None, w1, b1=None, wd, bd=None,
                        n_out: int):
    """n_out chains dw3x3(pw1(LN x)) from one read of x, each its own
    (B, H, W, E) map; w1 (C, n_out * E), wd (3, 3, n_out * E) hold the chains
    side by side. Without ``ln_w`` the chains run on x itself.

    Replaces ``fused_ln_split_proj`` in turtlevsr_tpu/kernels/ffn.py (kernel:
    csrc/split_proj.cu; bound by operations on an H100)."""
    if x.device.type == "cpu":
        return split_proj_plain(x, ln_w=ln_w, ln_b=ln_b, w1=w1, b1=b1, wd=wd,
                                bd=bd, n_out=n_out)
    _need_cuda("fused_ln_split_proj", x)
    return _split_proj_launch(x, ln_w, ln_b, w1, b1, wd, bd, n_out)


fused_ln_split_proj.launches = 0


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
    n_tiles = _tiles(h, w)
    v = torch.empty_like(x)
    vh = torch.empty_like(x_sp)
    part = torch.empty((b, n_tiles, width), dtype=torch.float32,
                       device=x.device)
    ptrs = [_check("x", x, x), _check("x_sp", x_sp, x, (b, nf, h, w, c)),
            _check("ln_w", ln_w, x, (c,)), _check("ln_b", ln_b, x, (c,)),
            _check("w_qkv", w_qkv, x, (c, 3 * c)),
            _check("wd_qkv", wd_qkv, x, (3, 3, 3 * c)),
            _check("w_kv", w_kv, x, (c, 2 * c)),
            _check("wd_kv", wd_kv, x, (3, 3, 2 * c)),
            v.data_ptr(), vh.data_ptr(), part.data_ptr()]
    lib = build.load("chm_stats")
    _check_smem("fused_chm_stats", lib.turtle_chm_stats_smem(
        c, heads, int(x.dtype == torch.bfloat16)))
    _call(lib.turtle_chm_stats_launch, ptrs, [b, h, w, c, heads, nf], x,
          "fused_chm_stats")
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

    Replaces ``fused_chm_stats`` in turtlevsr_tpu/kernels/ffn.py (kernel:
    csrc/chm_stats.cu; bound by operations on an H100). Only the per-head
    diagonal blocks of that kernel's (C, C) Grams are computed."""
    if x.device.type == "cpu":
        return chm_stats_plain(x, x_sp, ln_w=ln_w, ln_b=ln_b, w_qkv=w_qkv,
                               wd_qkv=wd_qkv, w_kv=w_kv, wd_kv=wd_kv,
                               heads=heads)
    _need_cuda("fused_chm_stats", x)
    return _chm_stats_launch(x, x_sp, ln_w, ln_b, w_qkv, wd_qkv, w_kv, wd_kv,
                             heads)


fused_chm_stats.launches = 0
