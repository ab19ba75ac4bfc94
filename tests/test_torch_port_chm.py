"""Port vs JAX package: the routing half of the causal history model (CHM):
the statistics pass, the conv with its LayerNorm prologue, the FFN pass with
lists of maps, and the CHM block as a whole over cache-threaded frames. On
the CPU the port's wrappers run their plain versions; the Pallas kernels run
in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (
    CHM_KERNEL_SHAPES,
    CONV_LN_KERNEL_SHAPES,
    FFN_LIST_CASES,
    Maker,
    chm_kernel_case,
    close,
    ffn_list_case,
    numpy_tree_like,
    t,
    to_jnp,
)
from turtlevsr_tpu.core import cache as jcache
from turtlevsr_tpu.kernels import ffn as jffn
from turtlevsr_tpu.kernels import vjp as jvjp
from turtlevsr_tpu.models import blocks as JB
from turtlevsr_tpu_torch.core import cache as tcache
from turtlevsr_tpu_torch.io.torch_convert import load_jax_params
from turtlevsr_tpu_torch.kernels import ffn as K
from turtlevsr_tpu_torch.models import blocks as TB

torch.set_num_threads(1)
ATOL64 = 1e-9  # the bar of tests/test_model_parity.py
# float32 against a Pallas kernel in interpret mode: fp32 sums in another
# order, values of order 10 (the bar of tests/test_torch_port_kernels.py)
ATOL32 = 3e-5
# float32, the CHM block against the fused route in interpret mode: some 15
# chained roundings, a softmax over Grams of 512 pixels
ATOL32_BLOCK = 2e-4


def _chm_inputs(rng, b, h, w, c, nf, ln_bias):
    r = rng.standard_normal
    p = dict(ln_w=1 + 0.2 * r(c), ln_b=r(c) if ln_bias else None,
             w_qkv=r((c, 3 * c)) / np.sqrt(c), wd_qkv=0.3 * r((3, 3, 3 * c)),
             w_kv=r((c, 2 * c)) / np.sqrt(c), wd_kv=0.3 * r((3, 3, 2 * c)))
    return r((b, h, w, c)), r((b, nf, h, w, c)), p


def _jax_chm_stats(x, x_sp, p, dtype, interpret):
    """fused_chm_stats of the JAX package (its Pallas kernel in interpret
    mode, or its plain twin) on numpy inputs; the per-head diagonal blocks
    of its (C, C) Grams are cut out by the caller."""
    c = x.shape[-1]
    j = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    qkv = [dict(w1=j(p["w_qkv"][:, i * c:(i + 1) * c]),
                wd=j(p["wd_qkv"][:, :, i * c:(i + 1) * c])) for i in range(3)]
    kv = [dict(w1=j(p["w_kv"][:, i * c:(i + 1) * c]),
               wd=j(p["wd_kv"][:, :, i * c:(i + 1) * c])) for i in range(2)]
    ln = dict(ln_w=j(p["ln_w"]))
    if p["ln_b"] is not None:
        ln["ln_b"] = j(p["ln_b"])
    if interpret:
        return jffn.fused_chm_stats(j(x), j(x_sp), qkv, kv, interpret=True,
                                    **ln)
    # the unfused chain of chm_apply (blocks.py:916-947) in float64: the
    # package's plain twin of the kernel casts q, k, kh to float32 before
    # the Grams, so the Grams are contracted here from its float64 maps
    mode = "with_bias" if p["ln_b"] is not None else "bias_free"
    q, k, v = jvjp._split_proj_xla(j(x), {"projs": qkv, **ln}, mode)
    b, nf = x_sp.shape[:2]
    xs = j(x_sp).reshape((b * nf,) + x_sp.shape[2:])
    kh, vh = jvjp._split_proj_xla(xs, {"projs": kv}, "none")
    q, k = (np.asarray(a, np.float64).reshape(b, -1, c) for a in (q, k))
    kh = np.asarray(kh, np.float64).reshape(b, nf, -1, c)
    s = np.zeros((b, nf + 2, 8, c))
    s[:, 0, 0], s[:, 1, 0] = (q * q).sum(1), (k * k).sum(1)
    s[:, 2:, 0] = (kh * kh).sum(2)
    return (v, np.asarray(vh).reshape(x_sp.shape),
            np.einsum("blc,bld->bcd", q, k),
            np.einsum("blc,bnld->bncd", q, kh), s)


def _check_chm_stats(got, want, heads, atol):
    v, vh, g, gh, stats = got
    wv, wvh, wg, wgh, ws = (np.asarray(a, np.float64) for a in want)
    c = v.shape[-1]
    ctok = c // heads
    close(v, wv, atol)
    close(vh, wvh, atol)
    px = v.shape[1] * v.shape[2]  # the statistics are sums over the pixels
    for h in range(heads):
        blk = slice(h * ctok, (h + 1) * ctok)
        close(g[:, h] / px, wg[:, blk, blk] / px, atol)
        close(gh[:, :, h] / px, wgh[:, :, blk, blk] / px, atol)
    close(stats / px, ws[:, :, 0] / px, atol)


@pytest.mark.parametrize("ln_bias", [True, False], ids=["WithBias", "BiasFree"])
@pytest.mark.parametrize("heads,nf", [(1, 1), (2, 2), (4, 3), (2, 4)])
def test_chm_stats_matches_unfused_chain_float64(heads, nf, ln_bias):
    x, x_sp, p = _chm_inputs(np.random.RandomState(0), 2, 9, 11, 8, nf,
                             ln_bias)
    got = K.fused_chm_stats(t(x), t(x_sp), heads=heads,
                            **{k: None if a is None else t(a)
                               for k, a in p.items()})
    assert got[1].shape == (2, nf, 9, 11, 8)
    assert got[3].shape == (2, nf, heads, 8 // heads, 8 // heads)
    assert got[4].shape == (2, nf + 2, 8)
    _check_chm_stats(got, _jax_chm_stats(x, x_sp, p, jnp.float64, False),
                     heads, ATOL64)


@pytest.mark.parametrize("heads,nf,ln_bias", [(1, 1, True), (2, 3, False),
                                              (4, 4, True)])
def test_chm_stats_matches_pallas_interpret_float32(heads, nf, ln_bias):
    x, x_sp, p = _chm_inputs(np.random.RandomState(1), 1, 8, 16, 8, nf,
                             ln_bias)
    f = lambda a: None if a is None else t(a, torch.float32)  # noqa: E731
    got = K.fused_chm_stats(f(x), f(x_sp), heads=heads,
                            **{k: f(a) for k, a in p.items()})
    assert got[0].dtype == torch.float32
    _check_chm_stats(got, _jax_chm_stats(x, x_sp, p, jnp.float32, True),
                     heads, ATOL32)


@pytest.mark.parametrize("shape", CHM_KERNEL_SHAPES, ids=str)
def test_chm_stats_plain_matches_twin_at_the_card_cases(shape):
    b, h, w, c, heads, nf, ln_bias = shape
    x, x_sp, kw = chm_kernel_case(Maker(8, torch.float64), *shape)
    p = {k: None if a is None else a.numpy() for k, a in kw.items()
         if k != "heads"}
    got = K.chm_stats_plain(x, x_sp, **kw)
    _check_chm_stats(got, _jax_chm_stats(x.numpy(), x_sp.numpy(), p,
                                         jnp.float64, False), heads, ATOL64)


def test_chm_stats_bfloat16_rounds_q_k_before_the_grams():
    """The statistics are taken of q, k, kh as a written bfloat16 map would
    hold them, in fp32; v and vh come back in bfloat16."""
    x, x_sp, kw = chm_kernel_case(Maker(2, torch.bfloat16), 1, 8, 8, 16, 2, 2,
                                  True)
    v, vh, g, gh, stats = K.fused_chm_stats(x, x_sp, **kw)
    assert v.dtype == vh.dtype == torch.bfloat16
    assert g.dtype == gh.dtype == stats.dtype == torch.float32
    wide = {k: a.float() if torch.is_tensor(a) else a for k, a in kw.items()}
    xn = K._ln_acc(x.float(), wide["ln_w"], wide["ln_b"]).bfloat16().float()
    qkv = K._chain_acc(xn, wide["w_qkv"], None, wide["wd_qkv"], None)
    q = qkv[..., :16].bfloat16().float()
    close(stats[:, 0], q.square().sum(dim=(1, 2)).numpy(), 1e-3)
    kh = K._chain_acc(x_sp[0].float(), wide["w_kv"], None, wide["wd_kv"],
                      None)[..., :16].bfloat16().float()
    close(stats[0, 2:], kh.square().sum(dim=(1, 2)).numpy(), 1e-3)


# ---------------------------------------------------------------------------
# row 5 with its LayerNorm prologue, row 4 without one, row 1 with lists
# ---------------------------------------------------------------------------


def _conv_ln_np(x, w, bias, ln_w, ln_b):
    """LN over channels, zero padding AFTER it, nine taps, in numpy."""
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    xn = ((x - mu) if ln_b is not None else x) / np.sqrt(var + 1e-5) * ln_w
    if ln_b is not None:
        xn = xn + ln_b
    b, h, ww, _ = x.shape
    xp = np.pad(xn, ((0, 0), (1, 1), (1, 1), (0, 0)))
    out = sum(xp[:, ty:ty + h, tx:tx + ww] @ w[ty, tx]
              for ty in range(3) for tx in range(3))
    return out if bias is None else out + bias


@pytest.mark.parametrize("shape", CONV_LN_KERNEL_SHAPES, ids=str)
def test_conv3x3_with_layernorm_float64(shape):
    b, h, w, cin, cout, bias, ln_bias = shape
    m = Maker(3, torch.float64)
    x, wt = m(b, h, w, cin), m(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    bb = m(cout) if bias else None
    ln_w, ln_b = m(cin), m(cin) if ln_bias else None
    got = K.fused_conv3x3(x, wt, bb, ln_w=ln_w, ln_b=ln_b)
    n = lambda a: None if a is None else a.numpy()  # noqa: E731
    close(got, _conv_ln_np(n(x), n(wt), n(bb), n(ln_w), n(ln_b)), ATOL64)


@pytest.mark.parametrize("ln_bias", [True, False], ids=["WithBias", "BiasFree"])
def test_conv3x3_with_layernorm_matches_pallas_interpret_float32(ln_bias):
    rng = np.random.RandomState(4)
    x = rng.standard_normal((1, 8, 16, 8))
    w = rng.standard_normal((3, 3, 8, 8)) / np.sqrt(72)
    ln_w = 1 + 0.2 * rng.standard_normal(8)
    ln_b = rng.standard_normal(8) if ln_bias else None
    f32 = lambda a: None if a is None else jnp.asarray(  # noqa: E731
        a, jnp.float32)
    want = jffn.fused_conv3x3(f32(x), f32(w), None, ln_w=f32(ln_w),
                              ln_b=f32(ln_b), interpret=True)
    tf = lambda a: None if a is None else t(a, torch.float32)  # noqa: E731
    got = K.fused_conv3x3(tf(x), tf(w), None, ln_w=tf(ln_w), ln_b=tf(ln_b))
    close(got, want, ATOL32)


def test_conv3x3_layernorm_border_is_zero_padding_of_the_normed_map():
    """LN of a zero-padded x would put ln_b on the border; the border here
    is zero AFTER the LayerNorm."""
    x = torch.zeros(1, 4, 4, 4, dtype=torch.float64)
    w = torch.ones(3, 3, 4, 1, dtype=torch.float64)
    ln_w, ln_b = torch.ones(4, dtype=torch.float64), torch.full(
        (4,), 2.0, dtype=torch.float64)
    out = K.fused_conv3x3(x, w, ln_w=ln_w, ln_b=ln_b)[0, :, :, 0]
    assert out[0, 0] == 4 * 4 * 2.0 and out[1, 1] == 9 * 4 * 2.0


def test_split_proj_without_layernorm_matches_twin_float64():
    """The kv embedding of the unfolded CHM route: chains on x itself."""
    rng = np.random.RandomState(5)
    x = rng.standard_normal((2, 7, 9, 8))
    w1, wd = rng.standard_normal((8, 16)), rng.standard_normal((3, 3, 16))
    b1, bd = rng.standard_normal(16), rng.standard_normal(16)
    projs = [dict(w1=jnp.asarray(w1[:, i * 8:(i + 1) * 8]),
                  wd=jnp.asarray(wd[:, :, i * 8:(i + 1) * 8]),
                  b1=jnp.asarray(b1[i * 8:(i + 1) * 8]),
                  bd=jnp.asarray(bd[i * 8:(i + 1) * 8])) for i in range(2)]
    want = jvjp._split_proj_xla(jnp.asarray(x), {"projs": projs}, "none")
    got = K.fused_ln_split_proj(t(x), w1=t(w1), b1=t(b1), wd=t(wd), bd=t(bd),
                                n_out=2)
    for g, w_ in zip(got, want):
        close(g, w_, ATOL64)


def _ffn_list_np(x, kw):
    """x' = x + sum_j x2_j @ po_j (+ po_b once), then the gate chain, in
    numpy float64 (per-batch products done batch by batch)."""
    maps = []
    for e in kw["x2"]:
        maps += [e[:, j] for j in range(e.shape[1])] if e.ndim == 5 else [e]
    xs = x.copy()
    for j, (m, po) in enumerate(zip(maps, kw["po_w"])):
        prod = (np.einsum("bhwc,bce->bhwe", m, po) if po.ndim == 3
                else m @ po)
        if j == 0 and kw.get("po_b") is not None:
            prod = prod + kw["po_b"]
        xs = xs + prod
    rest = {k: (None if v is None else t(v)) if k != "mode" else v
            for k, v in kw.items() if k not in ("x2", "po_w", "po_b")}
    return K.ffn_plain(t(xs), **rest).numpy()


@pytest.mark.parametrize("case", list(FFN_LIST_CASES))
def test_ffn_with_lists_matches_numpy_sum_float64(case):
    x, kw = ffn_list_case(case, Maker(5, torch.float64))
    got = K.fused_block_ffn(x, **kw)
    as_np = {k: ([a.numpy() for a in v] if isinstance(v, list)
                 else v.numpy() if torch.is_tensor(v) else v)
             for k, v in kw.items()}
    close(got, _ffn_list_np(x.numpy(), as_np), ATOL64)


@pytest.mark.parametrize("batched", [True, False], ids=["po_batched",
                                                        "po_shared"])
def test_ffn_with_lists_matches_pallas_interpret_float32(batched):
    """The JAX kernel with the same lists: a stacked (B, M, H, W, C) entry
    plus a single map, one matrix per map, po_b added once."""
    rng = np.random.RandomState(6)
    r = rng.standard_normal
    b, h, w, c, e, m = 2, 8, 16, 8, 10, 3
    p = dict(ln_w=1 + 0.2 * r(c), ln_b=r(c), w1=r((c, 2 * e)) / np.sqrt(c),
             wd=0.3 * r((3, 3, 2 * e)), w2=r((e, c)) / np.sqrt(e), po_b=r(c))
    x, stack, single = r((b, h, w, c)), r((b, m, h, w, c)), r((b, h, w, c))
    pos = [r((b, c, c) if batched else (c, c)) / np.sqrt(c)
           for _ in range(m + 1)]
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    want = jffn.fused_block_ffn(
        f32(x), x2=[f32(stack), f32(single)], po_w=[f32(a) for a in pos],
        mode="gate", interpret=True, **{k: f32(a) for k, a in p.items()})
    tf = lambda a: t(a, torch.float32)  # noqa: E731
    got = K.fused_block_ffn(
        tf(x), x2=[tf(stack), tf(single)], po_w=[tf(a) for a in pos],
        mode="gate", **{k: tf(a) for k, a in p.items()})
    close(got, want, ATOL32)


def test_ffn_with_lists_bfloat16_rounds_each_product_and_sums_in_fp32():
    x, kw = ffn_list_case("stack3_single_batched", Maker(7, torch.bfloat16))
    got = K.fused_block_ffn(x, **kw)
    assert got.dtype == torch.bfloat16
    acc = x.float()
    maps = [kw["x2"][0][:, j] for j in range(3)] + [kw["x2"][1]]
    for j, (m, po) in enumerate(zip(maps, kw["po_w"])):
        a2 = torch.einsum("bhwc,bce->bhwe", m.float(),
                          po.float()).bfloat16().float()
        if j == 0:
            a2 = (a2 + kw["po_b"].float()).bfloat16().float()
        acc = acc + a2
    rest = {k: v for k, v in kw.items() if k not in ("x2", "po_w", "po_b")}
    want = K.ffn_plain(acc.bfloat16(), **rest)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the CHM block as a whole
# ---------------------------------------------------------------------------


def _chm_pair(seed, kernels, heads=2, bias=False, ln_bias=True, dim=8,
              patch=2, ring=3):
    common = dict(attn_type="CHM", ffw_type="GFFW", dim=dim, num_heads=heads,
                  ffn_expansion_factor=2.5, bias=bias, layernorm_bias=ln_bias,
                  num_frames_tocache=ring, scale_patchsize=patch)
    jspec = JB.BlockSpec(kernels=kernels, **common)
    tspec = TB.BlockSpec(**common)
    rng = np.random.RandomState(seed)
    tree = numpy_tree_like(
        JB.attn_block_init(jax.random.PRNGKey(0), jspec), rng)
    block = TB.TurtleAttnBlock(tspec).double().eval()
    load_jax_params(block, tree)
    return jspec, tree, block, rng


def _slots(b, h, w, c, ws, ring, jd, td):
    hw = (h // ws) * (w // ws)
    return (jcache.sab_slot_init(b, ring, hw, 2 * c, hw, ws * ws * c, jd),
            tcache.sab_slot_init(b, ring, hw, 2 * c, hw, ws * ws * c, td,
                                 device="cpu"))


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("heads", [1, 2, 4])
def test_chm_block_five_frames_float64(heads, bias):
    """CHM + GFFW over 5 cache-threaded frames with a 3-frame ring: empty,
    filling, full, wrapped. bias=True takes the unfolded route."""
    jspec, tree, block, rng = _chm_pair(0, "xla", heads=heads, bias=bias)
    b, h, w, c = 2, 8, 12, 8
    jslot, tslot = _slots(b, h, w, c, 4, 3, jnp.float64, torch.float64)
    jp = to_jnp(tree, jnp.float64)
    for i in range(5):
        x = rng.standard_normal((b, h, w, c))
        want, jslot = JB.attn_block_apply(jp, jnp.asarray(x), jspec, jslot)
        with torch.inference_mode():
            got, tslot = block(t(x), tslot)
        close(got, want, ATOL64)
        close(tslot["k"], jslot["k"], ATOL64)
        close(tslot["v"], jslot["v"], ATOL64)
        assert int(tslot["n"]) == int(jslot["n"]) == i + 1


@pytest.mark.parametrize("ln_bias", [True, False], ids=["WithBias", "BiasFree"])
def test_chm_block_without_a_slot_and_window_of_two(ln_bias):
    """No cache slot: the current frame alone is aligned and routed."""
    jspec, tree, block, rng = _chm_pair(1, "xla", ln_bias=ln_bias, patch=1)
    x = rng.standard_normal((1, 6, 10, 8))
    want, slot = JB.attn_block_apply(to_jnp(tree, jnp.float64),
                                     jnp.asarray(x), jspec, None)
    with torch.inference_mode():
        got, tslot = block(t(x), None)
    assert slot is None and tslot is None
    close(got, want, ATOL64)


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_chm_block_matches_fused_route_interpret_float32(bias):
    """Against kernels='pallas' in interpret mode, the route the port
    follows: 128 window tokens (the JAX package's gate for its probabilities
    kernel) and W % 8 == 0. A window of 2 on a 16 x 32 map; with biases a
    window of 4 on 32 x 64 (a strided conv of window 2 and padding 1 does
    not give the lattice's grid)."""
    patch = 2 if bias else 1
    jspec, tree, block, rng = _chm_pair(2, "pallas", bias=bias, patch=patch,
                                        ring=2)
    block = block.float()
    b, h, w, c = 1, 16 * patch, 32 * patch, 8
    jslot, tslot = _slots(b, h, w, c, 2 * patch, 2, jnp.float32,
                          torch.float32)
    jp = to_jnp(tree, jnp.float32)
    for i in range(3):
        x = rng.standard_normal((b, h, w, c))
        want, jslot = JB.attn_block_apply(jp, jnp.asarray(x, jnp.float32),
                                          jspec, jslot)
        with torch.inference_mode():
            got, tslot = block(t(x, torch.float32), tslot)
        assert got.dtype == torch.float32
        close(got, want, ATOL32_BLOCK)
        close(tslot["v"], jslot["v"], ATOL32_BLOCK)


def test_chm_block_refuses_a_map_the_window_does_not_divide():
    _, _, block, rng = _chm_pair(3, "xla")
    with pytest.raises(ValueError, match="must divide"):
        block(t(rng.standard_normal((1, 6, 8, 8))), None)


def test_chm_state_dict_names_and_conversion():
    """The reference's names; depthwise ws x ws weights cross like every
    4-D weight (HWIO -> OIHW), no rule of their own."""
    _, tree, block, _ = _chm_pair(4, "xla", patch=2)
    sd = block.state_dict()
    for k in ("attn.spatial_aligner.temperature",
              "attn.spatial_aligner.qk_dwconv.weight",
              "attn.spatial_aligner.k2_dwconv.weight",
              "attn.spatial_aligner.q2.weight",
              "attn.spatial_aligner.project_out.weight",
              "attn.ChanAttn.qkv.weight", "attn.ChanAttn.temperature",
              "attn.kv.weight", "attn.kv_dwconv.weight"):
        assert k in sd, k
    assert sd["attn.spatial_aligner.temperature"].shape == (1, 1, 1)
    assert sd["attn.spatial_aligner.k2_dwconv.weight"].shape == (16, 1, 4, 4)
    hwio = tree["attn"]["spatial_aligner"]["k2_dwconv"]["weight"]
    assert hwio.shape == (4, 4, 1, 16)
    close(sd["attn.spatial_aligner.k2_dwconv.weight"],
          hwio.transpose(3, 2, 0, 1), 0)
    assert not any(k.endswith("bias") for k in sd if ".attn." in "." + k
                   and "norm" not in k)
