"""Port vs JAX package: the four fused functions of kernels/ffn.py.

On the CPU the port's wrappers run their plain versions (a CUDA kernel has
no interpret mode; the kernels themselves are held against these plain
versions on the card by chip_smoke.py). Each is compared here with the JAX
package's plain twin in kernels/vjp.py in float64, and at one small float32
shape with the Pallas kernel itself in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (
    CONV_KERNEL_SHAPES,
    FFN_KERNEL_CASES,
    QKV_KERNEL_SHAPES,
    SPLIT_KERNEL_SHAPES,
    Maker,
    chain_kernel_case,
    close,
    ffn_kernel_case,
    t,
)
from turtlevsr_tpu.kernels import ffn as jffn
from turtlevsr_tpu.kernels import vjp as jvjp
from turtlevsr_tpu_torch import kernels as KP
from turtlevsr_tpu_torch.kernels import ffn as K
from turtlevsr_tpu_torch.kernels import lattice as L
from turtlevsr_tpu_torch.kernels import sab as S

torch.set_num_threads(1)
# float64 against the plain twin: the same formula, sums in another order
ATOL64 = 1e-9
# float32 against the Pallas kernel in interpret mode: fp32 sums in another
# order and its polynomial erf (about 2 ulp) against torch's erf, values of
# order 10; the JAX package's own kernel tests use 2e-6 on smaller values
ATOL32 = 2e-5

FFN_MODES = {
    # name: (mode, pair, po, scale, ffw2)
    "gate_pair_po_batched": ("gate", True, "batched", False, False),
    "gate_pair_no_po": ("gate", True, None, False, False),
    "gate_no_pair": ("gate", False, None, False, False),
    "gelu_scale": ("gelu", False, None, True, False),
    "gelu_ffw2": ("gelu", False, None, True, True),
}


def _ffn_inputs(rng, mode_name, biases, b=2, h=8, w=16, c=8, e=10):
    mode, pair, po, scale, ffw2 = FFN_MODES[mode_name]
    ch = 2 * e if mode == "gate" else e
    r = rng.standard_normal
    p = dict(ln_w=1 + 0.2 * r(c), ln_b=r(c), w1=r((c, ch)) / np.sqrt(c),
             wd=0.3 * r((3, 3, ch)), w2=r((e, c)) / np.sqrt(e))
    if biases:
        p.update(b1=r(ch), bd=r(ch), b2=r(c))
    if scale:
        p["scale"] = r(c)
    if pair:
        p["x2"] = r((b, h, w, c))
    if po == "batched":
        p["po_w"] = r((b, c, c)) / np.sqrt(c)
        if biases:
            p["po_b"] = r(c)
    if ffw2:
        f = 2 * c
        p["ffw2"] = dict(ln_w=1 + 0.2 * r(c), ln_b=r(c),
                         w1=r((c, f)) / np.sqrt(c), b1=r(f),
                         w2=r((f, c)) / np.sqrt(f), b2=r(c), scale=r(c))
    return r((b, h, w, c)), p, mode


def _tree(p, conv):
    return {k: ({kk: conv(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else conv(v)) for k, v in p.items()}


@pytest.mark.parametrize("biases", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("mode_name", list(FFN_MODES))
def test_ffn_matches_plain_twin_float64(mode_name, biases):
    rng = np.random.RandomState(0)
    # 9x13: not a multiple of the kernels' 8x8 tile, borders on every side
    x, p, mode = _ffn_inputs(rng, mode_name, biases, h=9, w=13)
    got = K.fused_block_ffn(t(x), mode=mode, **_tree(p, t))
    assert got.dtype == torch.float64
    jp, jx = dict(p), x
    if "po_w" in p:
        # the twin casts the per-batch po product to float32 (a CPU
        # work-around of the JAX package): hold the port to it at float32's
        # bar, then at the float64 bar with that one product done in numpy
        close(got, jvjp._ffn_xla(jnp.asarray(x), _tree(p, jnp.asarray), mode,
                                 True, "with_bias"), 5e-6)
        jx = x + np.einsum("bhwc,bce->bhwe", p["x2"], p["po_w"]) + p.get(
            "po_b", 0.0)
        jp = {k: v for k, v in p.items() if k not in ("x2", "po_w", "po_b")}
    want = jvjp._ffn_xla(jnp.asarray(jx), _tree(jp, jnp.asarray), mode, True,
                         "with_bias")
    close(got, want, ATOL64)


@pytest.mark.parametrize("mode_name", list(FFN_MODES))
def test_ffn_matches_pallas_interpret_float32(mode_name):
    rng = np.random.RandomState(1)
    x, p, mode = _ffn_inputs(rng, mode_name, True)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    want = jffn.fused_block_ffn(f32(x), mode=mode, interpret=True,
                                **_tree(p, f32))
    got = K.fused_block_ffn(t(x, torch.float32), mode=mode,
                            **_tree(p, lambda a: t(a, torch.float32)))
    assert got.dtype == torch.float32
    close(got, want, ATOL32)


def test_ffn_bias_free_layer_norm():
    rng = np.random.RandomState(2)
    x, p, mode = _ffn_inputs(rng, "gate_no_pair", False)
    del p["ln_b"]
    want = jvjp._ffn_xla(jnp.asarray(x), _tree(p, jnp.asarray), mode, True,
                         "bias_free")
    close(K.fused_block_ffn(t(x), mode=mode, **_tree(p, t)), want, ATOL64)


def test_ffn_border_hidden_map_is_zero_padded_after_bias():
    """The hidden map is zero-padded AFTER pw1 and its bias: a halo pixel
    outside the image contributes 0, not pw1(LN 0) + b1. With a large b1 a
    wrong border shows at the edge pixels only."""
    rng = np.random.RandomState(3)
    x, p, mode = _ffn_inputs(rng, "gelu_scale", True, b=1, h=6, w=7)
    p["b1"] = p["b1"] + 5.0
    want = np.asarray(jvjp._ffn_xla(jnp.asarray(x), _tree(p, jnp.asarray),
                                    mode, True, "with_bias"))
    got = K.fused_block_ffn(t(x), mode=mode, **_tree(p, t)).numpy()
    close(got, want, ATOL64)
    # the wrong rule (bias carried into the padding) differs at the border
    # and nowhere else
    xn = K._ln_acc(t(x), t(p["ln_w"]), t(p["ln_b"]))
    hid = xn @ t(p["w1"]) + t(p["b1"])
    hp = torch.nn.functional.pad(hid, (0, 0, 1, 1, 1, 1)) + 0.0
    hp[:, 0] = hp[:, -1] = t(p["b1"])
    hp[:, :, 0] = hp[:, :, -1] = t(p["b1"])
    dw = sum(hp[:, i:i + 6, j:j + 7] * t(p["wd"])[i, j]
             for i in range(3) for j in range(3)) + t(p["bd"])
    wrong = ((K._gelu(dw) @ t(p["w2"]) + t(p["b2"])) * t(p["scale"])
             + t(x)).numpy()
    assert np.abs(wrong - want)[:, 1:-1, 1:-1].max() < ATOL64
    assert np.abs(wrong - want)[:, 0].max() > 1e-3


def test_ffn_bfloat16_rounds_where_the_kernel_rounds():
    """bf16 maps: fp32 sums, outputs within a few bf16 ulps of the float64
    result of the same inputs."""
    rng = np.random.RandomState(4)
    x, p, mode = _ffn_inputs(rng, "gelu_ffw2", True)
    bf = lambda a: t(a, torch.bfloat16)  # noqa: E731
    got = K.fused_block_ffn(bf(x), mode=mode, **_tree(p, bf))
    assert got.dtype == torch.bfloat16
    p64 = _tree(_tree(p, bf), lambda a: a.double())
    want = K.fused_block_ffn(bf(x).double(), mode=mode, **p64)
    # every bf16 rounding point (x', LN, act, y, ...) is 2^-9 relative
    scale = want.abs().max().item()
    close(got.double(), want.numpy(), atol=scale * 2 ** -5)


def _chain_inputs(rng, c, ch, biases, b=2, h=8, w=16):
    r = rng.standard_normal
    p = dict(ln_w=1 + 0.2 * r(c), ln_b=r(c), w1=r((c, ch)) / np.sqrt(c),
             wd=0.3 * r((3, 3, ch)))
    if biases:
        p.update(b1=r(ch), bd=r(ch))
    return r((b, h, w, c)), p


def _projs(p, n, conv):
    e = p["w1"].shape[1] // n
    out = []
    for i in range(n):
        sl = slice(i * e, (i + 1) * e)
        d = dict(w1=conv(p["w1"][:, sl]), wd=conv(p["wd"][:, :, sl]))
        if "b1" in p:
            d.update(b1=conv(p["b1"][sl]), bd=conv(p["bd"][sl]))
        out.append(d)
    return out


def _check_qkv(got, want, c, heads, hw, atol):
    """The statistics are float32 sums of hw terms on the JAX side: beside
    the absolute bar they get float32's relative one (about sqrt(hw) ulp)."""
    v, gram, stats = got
    wv, wg, ws = want
    ctok = c // heads
    close(v, wv, atol)
    wg = np.asarray(wg, np.float64)
    for hd in range(heads):  # the port returns only the per-head blocks
        sl = slice(hd * ctok, (hd + 1) * ctok)
        close(gram[:, hd], wg[:, sl, sl], atol * hw, rtol=1e-5)
    ws = np.asarray(ws, np.float64)
    close(stats[:, 0], ws[:, 0, :c], atol * hw, rtol=1e-5)
    close(stats[:, 1], ws[:, 0, c:], atol * hw, rtol=1e-5)


@pytest.mark.parametrize("biases", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("heads", [1, 2])
def test_qkv_stats_matches_plain_twin(heads, biases):
    rng = np.random.RandomState(5)
    c = 8
    x, p = _chain_inputs(rng, c, 3 * c, biases, h=9, w=13)
    jp = {"projs": _projs(p, 3, jnp.asarray), "ln_w": jnp.asarray(p["ln_w"]),
          "ln_b": jnp.asarray(p["ln_b"])}
    # the twin sums its Gram in float32 (its operands are cast): compare
    # the map at the float64 bar and the statistics at float32's
    want = jvjp._qkv_stats_xla(jnp.asarray(x), jp, "with_bias")
    got = K.fused_qkv_stats(t(x), heads=heads, **_tree(p, t))
    assert got[1].shape == (2, heads, c // heads, c // heads)
    close(got[0], want[0], ATOL64)
    _check_qkv((got[0].float(), got[1], got[2]), want, c, heads, 9 * 13, 2e-6)
    # and exactly, against float64 sums of the twin's own q, k maps
    q, k, _ = jvjp._split_proj_xla(jnp.asarray(x), jp, "with_bias")
    q, k = np.asarray(q).reshape(2, -1, c), np.asarray(k).reshape(2, -1, c)
    close(got[2][:, 0], (q * q).sum(1), ATOL64)
    close(got[2][:, 1], (k * k).sum(1), ATOL64)
    ctok = c // heads
    for hd in range(heads):
        sl = slice(hd * ctok, (hd + 1) * ctok)
        close(got[1][:, hd], np.einsum("blc,bld->bcd", q[..., sl], k[..., sl]),
              ATOL64)


def test_qkv_stats_matches_pallas_interpret_float32():
    rng = np.random.RandomState(6)
    c, heads = 8, 2
    x, p = _chain_inputs(rng, c, 3 * c, False)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    want = jffn.fused_qkv_stats(f32(x), _projs(p, 3, f32), ln_w=f32(p["ln_w"]),
                                ln_b=f32(p["ln_b"]), interpret=True)
    got = K.fused_qkv_stats(t(x, torch.float32), heads=heads,
                            **_tree(p, lambda a: t(a, torch.float32)))
    assert got[1].dtype == torch.float32
    _check_qkv(got, want, c, heads, 8 * 16, ATOL32)


@pytest.mark.parametrize("biases", [False, True], ids=["nobias", "bias"])
def test_split_proj_matches_plain_twin(biases):
    rng = np.random.RandomState(7)
    c, n = 8, 3
    x, p = _chain_inputs(rng, c, n * c, biases, h=9, w=13)
    jp = {"projs": _projs(p, n, jnp.asarray), "ln_w": jnp.asarray(p["ln_w"]),
          "ln_b": jnp.asarray(p["ln_b"])}
    want = jvjp._split_proj_xla(jnp.asarray(x), jp, "with_bias")
    got = K.fused_ln_split_proj(t(x), n_out=n, **_tree(p, t))
    assert len(got) == n
    for g, w_ in zip(got, want):
        assert g.is_contiguous() and g.shape == (2, 9, 13, c)
        close(g, w_, ATOL64)


def test_split_proj_matches_pallas_interpret_float32():
    rng = np.random.RandomState(8)
    c, n = 8, 3
    x, p = _chain_inputs(rng, c, n * c, False)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    want = jffn.fused_ln_split_proj(f32(x), _projs(p, n, f32),
                                    ln_w=f32(p["ln_w"]), ln_b=f32(p["ln_b"]),
                                    interpret=True)
    got = K.fused_ln_split_proj(t(x, torch.float32), n_out=n,
                                **_tree(p, lambda a: t(a, torch.float32)))
    for g, w_ in zip(got, want):
        close(g, w_, ATOL32)


@pytest.mark.parametrize("cin,cout,bias", [(3, 8, False), (8, 3, True),
                                           (8, 16, False)])
def test_conv3x3_matches_plain_twin(cin, cout, bias):
    rng = np.random.RandomState(9)
    x = rng.standard_normal((2, 9, 13, cin))
    w = rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)
    bb = rng.standard_normal(cout) if bias else None
    jp = {"weight": jnp.asarray(w)}
    if bias:
        jp["bias"] = jnp.asarray(bb)
    want = jvjp._conv3_xla(jnp.asarray(x), jp)
    got = K.fused_conv3x3(t(x), t(w), None if bb is None else t(bb))
    close(got, want, ATOL64)


def test_conv3x3_matches_pallas_interpret_float32():
    rng = np.random.RandomState(10)
    x = rng.standard_normal((1, 8, 16, 8))
    w = rng.standard_normal((3, 3, 8, 16)) / np.sqrt(72)
    bb = rng.standard_normal(16)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    want = jffn.fused_conv3x3(f32(x), f32(w), f32(bb), interpret=True)
    got = K.fused_conv3x3(t(x, torch.float32), t(w, torch.float32),
                          t(bb, torch.float32))
    close(got, want, ATOL32)


def test_launch_counters_do_not_count_plain_runs():
    KP.reset_launch_counts()
    rng = np.random.RandomState(11)
    x, p, mode = _ffn_inputs(rng, "gate_no_pair", False)
    K.fused_block_ffn(t(x), mode=mode, **_tree(p, t))
    K.fused_conv3x3(t(x), t(rng.standard_normal((3, 3, 8, 4))))
    assert KP.launch_counts() == {
        "ffn": 0, "qkv_stats": 0, "split_proj": 0, "conv3x3": 0,
        "chm_stats": 0, "sab": 0, "lattice_merge": 0, "lattice_split": 0,
        "attn_v_slots": 0, "attn_v_merge": 0, "level_run": 0, "ffn_no_dw": 0,
        "ffn_wg": 0, "ffn_c64": 0, "ffn_pw": 0, "qkv_wg": 0, "split_wg": 0,
        "split_c64": 0, "chm_wg": 0, "sab_wg": 0, "level_wg": 0,
        "two_stage": 0, "two_stage_wg": 0, "sab_sparse_softmax": 0,
        "sparse_wg": 0}


def _no_dw(p):
    return {k: v for k, v in p.items() if k not in ("wd", "bd")}


@pytest.mark.parametrize("biases", [False, True], ids=["nobias", "bias"])
def test_ffn_without_depthwise_stage_matches_plain_twin(biases):
    """The no-dw branch (the pointwise FFW of a block on its own)."""
    rng = np.random.RandomState(12)
    x, p, mode = _ffn_inputs(rng, "gelu_scale", biases, h=9, w=13)
    p = _no_dw(p)
    want = jvjp._ffn_xla(jnp.asarray(x), _tree(p, jnp.asarray), mode, True,
                         "with_bias")
    close(K.fused_block_ffn(t(x), mode=mode, **_tree(p, t)), want, ATOL64)


def test_ffn_without_depthwise_stage_matches_pallas_interpret_float32():
    rng = np.random.RandomState(13)
    x, p, mode = _ffn_inputs(rng, "gelu_scale", True, b=1)
    p = _no_dw(p)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    want = jffn.fused_block_ffn(f32(x), mode=mode, interpret=True,
                                **_tree(p, f32))
    got = K.fused_block_ffn(t(x, torch.float32), mode=mode,
                            **_tree(p, lambda a: t(a, torch.float32)))
    close(got, want, ATOL32)


# ---------------------------------------------------------------------------
# The cases at which the card tests hold the kernels against the plain
# versions (tests/test_torch_port_cuda.py): here the plain versions against
# the JAX package at the same cases, and the wrappers' refusals, which are
# raised before any kernel is built.
# ---------------------------------------------------------------------------


def _np64(tree):
    """Tensors (and dicts of them) as float64 numpy arrays; None dropped."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _np64(v)
        elif torch.is_tensor(v):
            out[k] = v.double().numpy()
    return out


@pytest.mark.parametrize("case", list(FFN_KERNEL_CASES))
def test_ffn_plain_matches_twin_at_the_card_cases(case):
    x, kw = ffn_kernel_case(case, Maker(0, torch.float64))
    got = K.fused_block_ffn(x, **kw)
    p, jx = _np64(kw), x.numpy()
    if "po_w" in p:  # the product the twin would cast to float32, in numpy
        eq = "bhwc,bce->bhwe" if p["po_w"].ndim == 3 else "bhwc,ce->bhwe"
        jx = jx + np.einsum(eq, p["x2"], p["po_w"]) + p.get("po_b", 0.0)
        p = {k: v for k, v in p.items() if k not in ("x2", "po_w", "po_b")}
    want = jvjp._ffn_xla(jnp.asarray(jx), _tree(p, jnp.asarray), kw["mode"],
                         True, "with_bias" if "ln_b" in p else "bias_free")
    close(got, want, ATOL64)


@pytest.mark.parametrize("dtype,ulps", [(torch.float32, 2.0 ** -18),
                                        (torch.bfloat16, 2.0 ** -5)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(FFN_KERNEL_CASES))
def test_ffn_plain_serving_types_at_the_card_cases(case, dtype, ulps):
    """The plain version in a serving type against itself in float64 on the
    same (already rounded) inputs: every rounding point is half an ulp of
    the map's type, 2^-9 for bfloat16 and 2^-24 for float32, and a handful of
    them chain; the bar is relative to the largest output."""
    x, kw = ffn_kernel_case(case, Maker(0, dtype))
    got = K.fused_block_ffn(x, **kw)
    assert got.dtype == dtype
    kw64 = {k: ({kk: vv.double() for kk, vv in v.items()}
                if isinstance(v, dict) else v.double() if torch.is_tensor(v)
                else v) for k, v in kw.items()}
    want = K.fused_block_ffn(x.double(), **kw64)
    close(got.double(), want.numpy(), atol=want.abs().max().item() * ulps)


@pytest.mark.parametrize("shape", QKV_KERNEL_SHAPES, ids=str)
def test_qkv_stats_plain_matches_twin_at_the_card_cases(shape):
    b, h, w, c, heads, biases = shape
    x, kw = chain_kernel_case(Maker(1, torch.float64), b, h, w, c, 3 * c,
                              biases)
    p = _np64(kw)
    jp = {"projs": _projs(p, 3, jnp.asarray), "ln_w": jnp.asarray(p["ln_w"]),
          "ln_b": jnp.asarray(p["ln_b"])}
    v, gram, stats = K.fused_qkv_stats(x, heads=heads, **kw)
    q, k, wv = (np.asarray(a) for a in jvjp._split_proj_xla(
        jnp.asarray(x.numpy()), jp, "with_bias"))
    close(v, wv, ATOL64)
    q, k = q.reshape(b, -1, c), k.reshape(b, -1, c)
    # sums of h * w terms of order one
    close(stats[:, 0], (q * q).sum(1), ATOL64 * h * w)
    close(stats[:, 1], (k * k).sum(1), ATOL64 * h * w)
    ctok = c // heads
    for hd in range(heads):
        sl = slice(hd * ctok, (hd + 1) * ctok)
        close(gram[:, hd], np.einsum("blc,bld->bcd", q[..., sl], k[..., sl]),
              ATOL64 * h * w)


@pytest.mark.parametrize("shape", SPLIT_KERNEL_SHAPES, ids=str)
def test_split_proj_plain_matches_twin_at_the_card_cases(shape):
    b, h, w, c, e, n, biases = shape
    x, kw = chain_kernel_case(Maker(2, torch.float64), b, h, w, c, n * e,
                              biases, ln_bias=biases)
    p = _np64(kw)
    jp = {"projs": _projs(p, n, jnp.asarray), "ln_w": jnp.asarray(p["ln_w"])}
    if biases:
        jp["ln_b"] = jnp.asarray(p["ln_b"])
    want = jvjp._split_proj_xla(jnp.asarray(x.numpy()), jp,
                                "with_bias" if biases else "bias_free")
    got = K.fused_ln_split_proj(x, n_out=n, **kw)
    assert len(got) == n
    for g, w_ in zip(got, want):
        close(g, w_, ATOL64)


# the card tests' ragged conv cases whose plain product stays small on the
# CPU: the 3-channel gather, the narrow and middle N tiles, Cout that no N
# tile divides (tests/test_torch_port_cuda.py runs all of them on the card)
CONV_RAGGED_CPU_SHAPES = [(2, 37, 53, cin, cout, bias)
                          for cin in (3, 16, 64) for cout in (3, 8, 32, 72)
                          for bias in (False, True)]


@pytest.mark.parametrize("shape", CONV_KERNEL_SHAPES + CONV_RAGGED_CPU_SHAPES,
                         ids=str)
def test_conv3x3_plain_matches_twin_at_the_card_cases(shape):
    b, h, w, cin, cout, bias = shape
    m = Maker(3, torch.float64)
    x, wt = m(b, h, w, cin), m(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    bb = m(cout) if bias else None
    jp = {"weight": jnp.asarray(wt.numpy())}
    if bias:
        jp["bias"] = jnp.asarray(bb.numpy())
    close(K.fused_conv3x3(x, wt, bb),
          jvjp._conv3_xla(jnp.asarray(x.numpy()), jp), ATOL64)


def _refusals():
    m = Maker(4, torch.float32)
    x = m(1, 8, 8, 16)
    ffn = dict(x2=None, po_w=None, po_b=None, ln_w=m(16), ln_b=None,
               w1=m(16, 32), b1=None, wd=m(3, 3, 32), bd=None, w2=m(32, 16),
               b2=None, scale=None, mode="gelu", ffw2=None)
    chain = dict(ln_w=m(16), ln_b=None, w1=m(16, 48), b1=None,
                 wd=m(3, 3, 48), bd=None)
    chm = dict(ln_w=m(16), ln_b=None, w_qkv=m(16, 48), wd_qkv=m(3, 3, 48),
               w_kv=m(16, 32), wd_kv=m(3, 3, 32))

    def ffn_with(x_=x, **over):
        return lambda: K._ffn_launch(x_, **{**ffn, **over})

    return {
        "ffn_float64_map": (ffn_with(x.double()), "bfloat16 or float32"),
        "ffn_map_not_contiguous": (ffn_with(x.transpose(1, 2)), "contiguous"),
        "ffn_unknown_mode": (ffn_with(mode="relu"), "unknown mode"),
        "ffn_bd_without_wd": (ffn_with(wd=None, bd=m(32)), "bd needs wd"),
        "ffn_po_without_x2": (ffn_with(po_w=m(16, 16)), "po_w needs x2"),
        "ffn_width_not_16n": (ffn_with(m(1, 8, 8, 24)), "multiple of 16"),
        # float32 takes every width up to 512 since its bodies keep the LN
        # halo in device memory above 256; lists of maps only up to 256
        "ffn_float32_wide": (
            ffn_with(m(1, 8, 8, 512), x2=[m(1, 2, 8, 8, 512)],
                     po_w=[m(512, 512), m(512, 512)]),
            "lists of x2 maps up to C = 256"),
        "ffn_weight_of_other_type": (ffn_with(w2=m(32, 16).bfloat16()),
                                     "expected torch.float32"),
        "ffn_weight_shape": (ffn_with(wd=m(3, 3, 16)), "expected shape"),
        "ffn_chained_ffw_too_wide": (
            ffn_with(ffw2=dict(w1=m(16, 48))), "chained FFW"),
        "qkv_heads_do_not_divide": (
            lambda: K._qkv_stats_launch(x, heads=3, **chain), "C / heads"),
        "qkv_float32_wide": (
            lambda: K._qkv_stats_launch(m(1, 8, 8, 528), heads=11, **chain),
            "up to 512"),
        "split_width_not_16n": (
            lambda: K._split_proj_launch(m(1, 8, 8, 24), n_out=1, **chain),
            "multiple of 16"),
        "split_unequal_maps": (
            lambda: K._split_proj_launch(x, n_out=5, **chain), "1..4 maps"),
        "conv_weight_shape": (
            lambda: K._conv3x3_launch(x, m(3, 3, 8, 4), None, None, None),
            "weight must"),
        "conv_bias_shape": (
            lambda: K._conv3x3_launch(x, m(3, 3, 16, 4), m(3), None, None),
            "expected shape"),
        "conv_ln_width_not_16n": (
            lambda: K._conv3x3_launch(m(1, 8, 8, 24), m(3, 3, 24, 4), None,
                                      m(24), None), "multiple of 16"),
        "conv_ln_b_without_ln_w": (
            lambda: K._conv3x3_launch(x, m(3, 3, 16, 4), None, None, m(16)),
            "ln_b needs ln_w"),
        "ffn_six_maps": (
            ffn_with(x2=[m(1, 6, 8, 8, 16)],
                     po_w=[m(16, 16) for _ in range(6)]), "up to 5"),
        "ffn_maps_without_matrices": (
            ffn_with(x2=[m(1, 8, 8, 16), m(1, 8, 8, 16)]),
            "need their po_w"),
        "ffn_matrices_do_not_match_maps": (
            ffn_with(x2=[m(1, 2, 8, 8, 16)], po_w=[m(16, 16)]),
            "one matrix per x2 map"),
        "ffn_stacked_maps_shape": (
            ffn_with(x2=[m(1, 2, 8, 9, 16)],
                     po_w=[m(16, 16), m(16, 16)]), "expected shape"),
        "chm_heads_do_not_divide": (
            lambda: K._chm_stats_launch(x, m(1, 2, 8, 8, 16), heads=3, **chm),
            "C / heads"),
        "chm_frames_shape": (
            lambda: K._chm_stats_launch(x, m(1, 2, 8, 9, 16), heads=2, **chm),
            "expected shape"),
        "chm_frames_not_stacked": (
            lambda: K._chm_stats_launch(x, x, heads=2, **chm), "NF >= 1"),
        "chm_float32_wide": (
            lambda: K._chm_stats_launch(m(1, 8, 8, 528), m(1, 1, 8, 8, 528),
                                        heads=11, **chm), "up to 512"),
        "sab_width_not_16n": (
            lambda: S._launch(m(1, 8, 24), m(1, 1, 8, 24), m(1), None, 4, 5,
                              4), "multiple of 16"),
        "sab_k_top_too_large": (
            lambda: S._launch(m(1, 8, 16), m(1, 1, 8, 16), m(1), None, 4, 6,
                              4), "k_top must be"),
        "sab_float64": (
            lambda: S._launch(m(1, 8, 16).double(), m(1, 1, 8, 16).double(),
                              m(1), None, 4, 5, 4), "bfloat16 or float32"),
        "lattice_channels_not_16_bytes": (
            lambda: L._launch(m(1, 4, 4, 2), (1, 4, 8), 1, 2, 2, 2, 2, False),
            "multiple of 8"),
        "lattice_float64": (
            lambda: L._launch(m(1, 4, 4, 8).double(), (1, 4, 32), 1, 2, 2, 2,
                              8, False), "bfloat16 or float32"),
    }


@pytest.mark.parametrize("name", list(_refusals()))
def test_launch_code_refuses_before_it_builds(name, monkeypatch):
    """What a kernel does not take is refused by the wrapper's launch code
    with the reason, before a library is built or loaded."""
    def no_build(lib):
        raise AssertionError(f"reached the build of {lib}")

    monkeypatch.setattr(K.build, "load", no_build)
    KP.reset_launch_counts()
    call, reason = _refusals()[name]
    with pytest.raises(ValueError, match=reason):
        call()
    assert not any(KP.launch_counts().values())
