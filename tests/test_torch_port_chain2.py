"""Port vs JAX package: the last two kernel rows on the CPU, where the port
runs their plain versions. Row 13, two chained depthwise stages
(``fused_two_stage``), and the ``two_stage`` fused plan of the conv-only
levels; row 12, the sparse softmax on given scores (``sab_sparse_softmax``).
The Pallas kernels run in interpret mode and compute in float32 inside
(their LayerNorm, dots and softmax cast to float32 whatever the input), so
they are held at a float32 tolerance; the float64 comparisons are made
against the JAX package's unfused XLA blocks at 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_oracle import tiny_opt
from torch_port_util import close, numpy_tree_like, t, to_jnp
from turtlevsr_tpu.kernels import chain2 as JC
from turtlevsr_tpu.kernels import sab as JS
from turtlevsr_tpu.models import blocks as JB
from turtlevsr_tpu.ops import attn_utils as JA
from turtlevsr_tpu_torch.io.torch_convert import load_jax_params
from turtlevsr_tpu_torch.kernels import chain2 as TC
from turtlevsr_tpu_torch.kernels import sab as TS
from turtlevsr_tpu_torch.models import blocks as TB
from turtlevsr_tpu_torch.models import build_model
from turtlevsr_tpu_torch.models import turtle as TT
from turtlevsr_tpu_torch.ops.attn_utils import local_window_mask

torch.set_num_threads(1)
ATOL64 = 1e-9
# float32 inside the Pallas kernels: two chained stages of LN, three products
# and the FFW on values of order 1..10
ATOL32_CHAIN = 2e-5
ATOL32_SOFTMAX = 1e-6  # probabilities in [0, 1]


def _stage(rng, c, e, mode, biases, ln_bias, scale):
    ch = 2 * e if mode == "gate" else e
    r = rng.standard_normal
    st = dict(ln_w=1.0 + 0.2 * r(c), ln_b=0.2 * r(c) if ln_bias else None,
              w1=r((c, ch)) / np.sqrt(c), wd=0.3 * r((3, 3, ch)),
              w2=r((e, c)) / np.sqrt(e), mode=mode)
    if biases:
        st.update(b1=0.2 * r(ch), bd=0.2 * r(ch), b2=0.2 * r(c))
    if scale:
        st["scale"] = 0.5 * r(c)
    return st


def _ffw(rng, c, ln_bias):
    r = rng.standard_normal
    f = 2 * c
    return dict(ln_w=1.0 + 0.2 * r(c), ln_b=0.2 * r(c) if ln_bias else None,
                w1=r((c, f)) / np.sqrt(c), b1=0.2 * r(f),
                w2=r((f, c)) / np.sqrt(f), b2=0.2 * r(c), scale=0.5 * r(c))


def _as(d, fn):
    if d is None:
        return None
    return {k: (v if v is None or isinstance(v, str) else fn(v))
            for k, v in d.items()}


# (kind, B, H, W, C, E1, E2, biases, ln_bias): a pair of ReducedAttn+FFW
# blocks (gelu stages with scale, an FFW after each) or a ReducedAttn+GFFW
# block (gelu stage, then the gate with a hidden width of 2.5 C)
CHAIN_CASES = {
    "pair": ("pair", 1, 12, 16, 8, 16, 16, True, True),
    "pair_ln_biasfree": ("pair", 2, 9, 8, 16, 32, 32, True, False),
    "ra_gffw_nobias": ("ra_gffw", 1, 12, 16, 8, 16, 20, False, True),
    "ra_gffw_bias": ("ra_gffw", 1, 10, 24, 16, 32, 40, True, False),
}


def _chain_case(name, seed):
    kind, b, h, w, c, e1, e2, biases, ln_bias = CHAIN_CASES[name]
    rng = np.random.RandomState(seed)
    x = 0.5 * rng.standard_normal((b, h, w, c))
    # the ReducedAttn's convs always carry biases (turtle_arch.py:627-665)
    st1 = _stage(rng, c, e1, "gelu", True, ln_bias, True)
    if kind == "pair":
        st2 = _stage(rng, c, e2, "gelu", True, ln_bias, True)
        ffw1, ffw2 = _ffw(rng, c, ln_bias), _ffw(rng, c, ln_bias)
    else:
        st2 = _stage(rng, c, e2, "gate", biases, ln_bias, False)
        ffw1 = ffw2 = None
    return x, st1, st2, ffw1, ffw2


@pytest.mark.parametrize("name", sorted(CHAIN_CASES))
def test_two_stage_plain_matches_pallas_interpret_float32(name):
    """Both stage kinds, biases on and off, LayerNorm with and without its
    bias, against the JAX kernel interpreted on the same float32 values."""
    x, st1, st2, ffw1, ffw2 = _chain_case(name, 0)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    want = JC.fused_two_stage(f32(x), _as(st1, f32), _as(st2, f32),
                              ffw1=_as(ffw1, f32), ffw2=_as(ffw2, f32),
                              interpret=True)
    tt = lambda a: t(np.asarray(a, np.float32), torch.float32)  # noqa: E731
    got = TC.fused_two_stage(tt(x), _as(st1, tt), _as(st2, tt),
                             ffw1=_as(ffw1, tt), ffw2=_as(ffw2, tt))
    assert got.dtype == torch.float32 and got.shape == x.shape
    close(got, want, ATOL32_CHAIN)


def _ra_blocks(seed, ffw_type, n, bias=False, ln_bias=True, c=8):
    common = dict(attn_type="ReducedAttn", ffw_type=ffw_type, dim=c,
                  num_heads=1, ffn_expansion_factor=2.5, bias=bias,
                  layernorm_bias=ln_bias, num_frames_tocache=0)
    rng = np.random.RandomState(seed)
    trees, blocks = [], []
    for i in range(n):
        jspec = JB.BlockSpec(kernels="xla", **common)
        tree = numpy_tree_like(
            JB.attn_block_init(jax.random.PRNGKey(i), jspec), rng)
        block = TB.TurtleAttnBlock(TB.BlockSpec(**common)).double().eval()
        load_jax_params(block, tree)
        trees.append(tree)
        blocks.append(block)
    return JB.BlockSpec(kernels="xla", **common), trees, blocks


@pytest.mark.parametrize("ffw_type,bias", [("FFW", False), ("GFFW", False),
                                           ("GFFW", True)],
                         ids=["pair", "ra_gffw_nobias", "ra_gffw_bias"])
def test_two_stage_of_blocks_matches_xla_blocks_float64(ffw_type, bias):
    """The blocks' own weights through the two-stage wrapper (a pair of
    ReducedAttn+FFW blocks, or one ReducedAttn+GFFW block) against the JAX
    package's blocks applied one after the other (XLA, float64)."""
    n = 2 if ffw_type == "FFW" else 1
    jspec, trees, blocks = _ra_blocks(1, ffw_type, n, bias=bias)
    x = np.random.RandomState(2).standard_normal((2, 9, 11, 8))
    want = jnp.asarray(x)
    for tree in trees:
        want, _ = JB.attn_block_apply(to_jnp(tree, jnp.float64), want, jspec,
                                      None)
    with torch.inference_mode():
        got = TT.apply_conv_level(blocks, t(x))
    close(got, want, ATOL64)


def test_two_stage_pair_matches_the_jax_pair_route_interpreted(monkeypatch):
    """The JAX package's own pair route (its TURTLE_CHAIN2 opt-in, set here
    for this test only) against the port's level under the plan, float32."""
    monkeypatch.setenv("TURTLE_CHAIN2", "1")
    common = dict(attn_type="ReducedAttn", ffw_type="FFW", dim=8,
                  num_heads=1, ffn_expansion_factor=2.5, bias=False,
                  layernorm_bias=True, num_frames_tocache=0)
    jspec = JB.BlockSpec(kernels="pallas", **common)
    rng = np.random.RandomState(3)
    trees = [numpy_tree_like(JB.attn_block_init(jax.random.PRNGKey(i),
                                                jspec), rng) for i in (0, 1)]
    x = jnp.asarray(0.5 * rng.standard_normal((1, 12, 16, 8)), jnp.float32)
    p1, p2 = (to_jnp(tr, jnp.float32) for tr in trees)
    assert JB.ra_pair_ok(p1, p2, x, jspec)
    want = JB.ra_pair_apply(p1, p2, x, jspec)
    blocks = []
    for tree in trees:
        block = TB.TurtleAttnBlock(TB.BlockSpec(**common)).float().eval()
        load_jax_params(block, tree)
        blocks.append(block)
    with torch.inference_mode():
        got = TT.apply_conv_level(blocks, t(np.asarray(x), torch.float32))
    close(got, want, ATOL32_CHAIN)


def test_two_stage_wrapper_checks_its_operands():
    x, st1, st2, ffw1, ffw2 = _chain_case("pair", 4)
    tt = lambda a: t(a, torch.float32)  # noqa: E731
    st1, st2 = _as(st1, tt), _as(st2, tt)
    meta = torch.zeros(1, 8, 8, 16, device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        TC.fused_two_stage(meta, st1, st2)
    assert TC.two_stage_supported(64) and TC.two_stage_supported(128)
    assert not TC.two_stage_supported(8) and not TC.two_stage_supported(256)


# ---------------------------------------------------------------------------
# the two_stage plan of the levels
# ---------------------------------------------------------------------------

# dim 16: the conv-only levels have 16 (enc1, refinement) and 32 (enc2)
# channels, multiples of 16 that the kernel takes; enc2 has an odd count
PLAN_OPT = dict(dim=16, Enc_blocks=[2, 3, 2], num_refinement_blocks=2)


@pytest.mark.parametrize("model", ["Turtle_t1_arch", "Turtle_arch",
                                   "Turtlesuper_t1_arch"])
def test_two_stage_plan_equals_the_split_plan(model, monkeypatch):
    """Under fuse=("two_stage",) the model gives the split plan's frames bit
    for bit (the plain version is the split chains), with one launch per
    ReducedAttn+FFW pair and per ReducedAttn+GFFW block: enc1 one pair, enc2
    one pair and a single block, the refinement two."""
    opt = tiny_opt(model=model, **PLAN_OPT)
    split = build_model(opt, device="cpu", dtype=torch.float64)
    fused = build_model(opt, device="cpu", dtype=torch.float64,
                        fuse=("two_stage",))
    tree = numpy_tree_like(
        {k: v.numpy() for k, v in split.state_dict().items()},
        np.random.RandomState(5))
    split.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in tree.items()})
    fused.load_state_dict(split.state_dict())
    calls = []
    real = TT.fused_two_stage

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(TT, "fused_two_stage", counted)
    h = 8 if model == "Turtlesuper_t1_arch" else 32
    frames = np.random.RandomState(6).rand(4, 1, h, h, 3)
    cs, cf = split.init_cache(1, h, h), fused.init_cache(1, h, h)
    with torch.inference_mode():
        for i in range(3):
            pair = t(np.stack([frames[i], frames[i + 1]], axis=1))
            want, cs = split(pair, cs)
            assert len(calls) == 4 * i
            got, cf = fused(pair, cf)
            assert len(calls) == 4 * (i + 1)
            assert torch.equal(got, want)


def test_two_stage_plan_leaves_other_widths_to_the_split_kernels():
    """dim 8: enc1 and the refinement have 8 channels, which the kernel does
    not take: the plan leaves them to the split kernels (a choice between
    hand-written kernels); enc2 (16 channels) takes the two-stage kernel."""
    model = build_model(tiny_opt(), device="cpu", fuse=("two_stage",))
    assert [lvl.conv_only for lvl in (
        model.encoder_level1, model.encoder_level2, model.refinement)] == [
        False, True, False]
    model = build_model(tiny_opt(**PLAN_OPT), device="cpu",
                        fuse=("two_stage",))
    assert all(lvl.conv_only for lvl in (
        model.encoder_level1, model.encoder_level2, model.refinement))
    assert not model.encoder_level3.conv_only


# ---------------------------------------------------------------------------
# row 12: the sparse softmax on given scores
# ---------------------------------------------------------------------------


def _scores(rng, bn, q, k, exact):
    """Normal scores, or (exact) multiples of 1/8 in [-1, 1]: many ties, each
    score exact in every type."""
    if exact:
        return rng.randint(-8, 9, (bn, q, k)) / 8.0
    return rng.standard_normal((bn, q, k))


# (BN, Q, K, hq, wq of the mask's grid, exact scores)
SPARSE_CASES = [(2, 16, 128, 8, 16, False), (3, 8, 130, 10, 13, True),
                (1, 24, 144, 12, 12, False), (2, 8, 256, 16, 16, True)]


@pytest.mark.parametrize("case", SPARSE_CASES, ids=lambda c: "x".join(
    map(str, c[:3])) + ("_ties" if c[5] else ""))
def test_sparse_softmax_plain_matches_pallas_interpret_float32(case):
    bn, q, k, hq, wq, exact = case
    rng = np.random.RandomState(7)
    s = _scores(rng, bn, q, k, exact).astype(np.float32)
    mask = local_window_mask(hq, wq, 4)[:q, :k].numpy()
    want = JS.sab_sparse_softmax(jnp.asarray(s), jnp.asarray(mask),
                                 interpret=True)
    got = TS.sab_sparse_softmax(torch.from_numpy(s), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    assert torch.equal(torch.from_numpy(np.asarray(want)) != 0, got != 0)
    close(got, want, ATOL32_SOFTMAX)


@pytest.mark.parametrize("exact", [False, True], ids=["normal", "ties"])
def test_sparse_softmax_plain_matches_the_xla_chain_float64(exact):
    """Against the JAX package's unfused chain: top-5 keep + local mask,
    clipped softmax (turtle_t1_arch.py:588-596), float64."""
    rng = np.random.RandomState(8)
    s = _scores(rng, 2, 20, 40, exact)
    mask = local_window_mask(4, 10, 4, torch.float64)[:20].numpy()
    js = jnp.asarray(s)
    want = JA.clipped_softmax(JA.topk_keep(js, 5) + js * jnp.asarray(mask))
    got = TS.sab_sparse_softmax(t(s), t(mask))
    close(got, want, ATOL64)


def test_sparse_softmax_with_fewer_keys_than_k_follows_the_chain():
    """Fewer than 5 keys: every key is kept once (min(k, keys), as the
    unfused chain's topk_keep), not key 0 twice as the Pallas kernel's fifth
    round of its running maximum would mark it."""
    rng = np.random.RandomState(9)
    s = rng.standard_normal((2, 3, 3))
    mask = np.eye(3)
    js = jnp.asarray(s)
    want = JA.clipped_softmax(JA.topk_keep(js, 5) + js * jnp.asarray(mask))
    got = TS.sab_sparse_softmax(t(s), t(mask))
    close(got, want, ATOL64)
    no_local = TS.sab_sparse_softmax(t(s), t(np.zeros((3, 3))))
    close(no_local, jax.nn.softmax(js, axis=-1), ATOL64)


def test_sparse_softmax_is_row_7_after_its_scores():
    """Row 12 on the scores row 7 computes (rounded to the map's type), the
    token grid's local mask and every frame valid gives row 7's
    probabilities."""
    rng = np.random.RandomState(10)
    for dtype in (torch.float64, torch.bfloat16):
        hq, wq, d, nf = 4, 6, 16, 2
        q = torch.from_numpy(rng.standard_normal((1, hq * wq, d)))
        k = torch.from_numpy(rng.standard_normal((1, nf, hq * wq, d)))
        q = (q / q.norm(dim=-1, keepdim=True)).to(dtype)
        k = (k / k.norm(dim=-1, keepdim=True)).to(dtype)
        temp = torch.tensor([1.7])
        want = TS.sab_attn_probs_plain(q, k, temp, grid_wq=wq)
        ad = torch.promote_types(dtype, torch.float32)
        s = torch.einsum("bqd,bnkd->bnqk", q.to(ad), k.to(ad)) * temp.to(ad)
        s = s.to(dtype).reshape(nf, hq * wq, hq * wq)
        got = TS.sab_sparse_softmax(s, local_window_mask(hq, wq, 4))
        assert torch.equal(got.reshape(want.shape), want)


def test_sparse_softmax_wrapper_checks_its_operands():
    s = torch.zeros(2, 4, 6)
    with pytest.raises(ValueError, match="local_mask"):
        TS.sab_sparse_softmax(s, torch.zeros(4, 5))
    with pytest.raises(ValueError, match="k_top"):
        TS.sab_sparse_softmax(s, torch.zeros(4, 6), k_top=6)
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        TS.sab_sparse_softmax(s.to("meta"), torch.zeros(4, 6, device="meta"))
