"""The four conv-FFN kernels of the serving path and their plain versions.

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

Every wrapper counts its kernel launches in ``<wrapper>.launches``.
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
    """Channel LN of values already in the accumulation type."""
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


def ffn_plain(x, *, x2=None, po_w=None, po_b=None, ln_w, ln_b=None, w1,
              b1=None, wd=None, bd=None, w2, b2=None, scale=None,
              mode: str, ffw2=None):
    """Plain version of :func:`fused_block_ffn`."""
    dt = x.dtype
    ad = acc_dtype(dt)
    xa = x.to(ad)
    if x2 is not None:
        a2 = x2.to(ad)
        if po_w is not None:
            pw = po_w.to(ad)
            a2 = _rt(torch.einsum("bhwc,bce->bhwe", a2, pw) if pw.dim() == 3
                     else a2 @ pw, dt)
            if po_b is not None:
                a2 = _rt(a2 + po_b.to(ad), dt)
        xa = _rt(xa + a2, dt)
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


def split_proj_plain(x, *, ln_w, ln_b=None, w1, b1=None, wd, bd=None,
                     n_out: int):
    """Plain version of :func:`fused_ln_split_proj`."""
    dt = x.dtype
    ad = acc_dtype(dt)
    xn = _rt(_ln_acc(x.to(ad), ln_w, ln_b), dt)
    maps = _chain_acc(xn, w1, b1, wd, bd).to(dt)
    return tuple(m.contiguous() for m in maps.chunk(n_out, dim=-1))


def conv3x3_plain(x, weight, bias=None):
    """Plain version of :func:`fused_conv3x3`: nine shifted matrix products
    in the accumulation type (no library convolution, whose float32 path may
    run in TF32)."""
    dt = x.dtype
    ad = acc_dtype(dt)
    b, h, w, cin = x.shape
    xp = F.pad(x.to(ad), (0, 0, 1, 1, 1, 1))
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
    po_batched = po_w is not None and po_w.dim() == 3
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
        _check("x", x, x), _check("x2", x2, x, x.shape),
        _check("po_w", po_w, x, (b, c, c) if po_batched else (c, c)),
        _check("po_b", po_b, x, (c,)), _check("ln_w", ln_w, x, (c,)),
        _check("ln_b", ln_b, x, (c,)), _check("w1", w1, x, (c, ch)),
        _check("b1", b1, x, (ch,)), _check("wd", wd, x, (3, 3, ch)),
        _check("bd", bd, x, (ch,)), _check("w2", w2, x, (e, c)),
        _check("b2", b2, x, (c,)), _check("scale", scale, x, (c,)),
        *fp, out.data_ptr()]
    lib = build.load("ffn")
    _check_smem("fused_block_ffn", lib.turtle_ffn_smem(
        c, f, int(ffw2 is not None), int(x.dtype == torch.bfloat16)))
    _call(lib.turtle_ffn_launch, ptrs,
          [b, h, w, c, ch, e, f, int(mode == "gate"), int(po_batched)], x,
          "fused_block_ffn")
    fused_block_ffn.launches += 1
    return out


def fused_block_ffn(x, *, x2=None, po_w=None, po_b=None, ln_w, ln_b=None,
                    w1, b1=None, wd=None, bd=None, w2, b2=None, scale=None,
                    mode: str, ffw2=None):
    """out = x' + scale * (pw2(act(dw3x3(pw1(LN x') + b1) + bd)) + b2) with
    x' = x + x2 @ po_w (+ po_b), in one pass over the map.

    Replaces ``fused_block_ffn`` of turtlevsr_tpu/kernels/ffn.py, both its
    dw branch and (``wd=None``: no depthwise stage) its no-dw branch (kernel:
    csrc/ffn.cu; on an H100 bound by operations at C >= 128 and by bytes at
    C = 64, see the note there).
    x2: optional second addend map (the attention branch); po_w (C, C) or
    per batch (B, C, C) and po_b: optional projection applied to x2 in the
    kernel. mode: 'gate' (gelu(a) * b on the
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


# ---------------------------------------------------------------------------
# row 3: q/k/v chains + channel-attention statistics
# ---------------------------------------------------------------------------

_REDUCE_GROUPS = 64


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
    # fixed-order sum of the tiles' partial rows, in two passes
    rows = n_tiles
    while rows > 1:
        per = -(-rows // _REDUCE_GROUPS) if rows > _REDUCE_GROUPS else rows
        groups = -(-rows // per)
        nxt = torch.empty((b, groups, width), dtype=torch.float32,
                          device=x.device)
        rc = lib.turtle_reduce_rows(part.data_ptr(), nxt.data_ptr(), b, rows,
                                    per, width, _stream(x))
        if rc != 0:
            raise RuntimeError(f"fused_qkv_stats: reduction launch failed "
                               f"with code {rc}")
        part, rows = nxt, groups
    fused_qkv_stats.launches += 1
    tot = part[:, 0]
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


def fused_ln_split_proj(x, *, ln_w, ln_b=None, w1, b1=None, wd, bd=None,
                        n_out: int):
    """n_out chains dw3x3(pw1(LN x)) from one read of x, each its own
    (B, H, W, E) map; w1 (C, n_out * E), wd (3, 3, n_out * E) hold the chains
    side by side.

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


def _conv3x3_launch(x, weight, bias):
    _check_map("x", x)
    b, h, w, cin = x.shape
    if weight.dim() != 4 or tuple(weight.shape[:3]) != (3, 3, cin):
        raise ValueError(f"weight must be (3, 3, {cin}, Cout), got "
                         f"{tuple(weight.shape)}")
    cout = weight.shape[3]
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    ptrs = [_check("x", x, x), _check("weight", weight, x),
            _check("bias", bias, x, (cout,)), out.data_ptr()]
    lib = build.load("conv3x3")
    _check_smem("fused_conv3x3", lib.turtle_conv3x3_smem(
        cin, int(x.dtype == torch.bfloat16)))
    _call(lib.turtle_conv3x3_launch, ptrs, [b, h, w, cin, cout], x,
          "fused_conv3x3")
    fused_conv3x3.launches += 1
    return out


def fused_conv3x3(x, weight, bias=None):
    """3x3 stride-1 pad-1 dense conv on an NHWC map; weight
    (3, 3, Cin, Cout).

    Replaces ``fused_conv3x3`` in turtlevsr_tpu/kernels/ffn.py without its
    LayerNorm prologue (kernel: csrc/conv3x3.cu; bound by operations at the
    wide levels, by bytes at the 3-channel ends)."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias)
    _need_cuda("fused_conv3x3", x)
    return _conv3x3_launch(x, weight, bias)


fused_conv3x3.launches = 0


def launch_counts() -> dict:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {"ffn": fused_block_ffn.launches,
            "qkv_stats": fused_qkv_stats.launches,
            "split_proj": fused_ln_split_proj.launches,
            "conv3x3": fused_conv3x3.launches}


def reset_launch_counts() -> None:
    for fn in (fused_block_ffn, fused_qkv_stats, fused_ln_split_proj,
               fused_conv3x3):
        fn.launches = 0
