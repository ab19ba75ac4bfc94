"""The CUDA kernels of turtlevsr_tpu_torch against their plain versions, on
the card: small and odd shapes (ragged tiles, masked channel lanes, every
FFN mode) in float32 and bfloat16. Needs an NVIDIA GPU and nvcc; run with

    python -m pytest tests/test_torch_port_cuda.py -q

Without a card every test here skips (chip_smoke.py holds the kernels
against the plain versions at the full serving shapes; the plain versions
are held against the JAX package on the CPU by test_torch_port_kernels.py,
at these cases too)."""

import pytest
import torch

from torch_port_util import (
    ATTN_V_KERNEL_SHAPES,
    CHM_KERNEL_SHAPES,
    CONV_KERNEL_SHAPES,
    CONV_LN_KERNEL_SHAPES,
    FFN_KERNEL_CASES,
    FFN_LIST_CASES,
    KERNEL_TOL,
    LATTICE_KERNEL_SHAPES,
    LEVEL_KERNEL_SHAPES,
    QKV_KERNEL_SHAPES,
    SAB_KERNEL_SHAPES,
    SPARSE_KERNEL_SHAPES,
    SPLIT_KERNEL_SHAPES,
    TWO_STAGE_KERNEL_CASES,
    Maker,
    attn_v_kernel_case,
    chain_kernel_case,
    chm_kernel_case,
    ffn_kernel_case,
    ffn_list_case,
    level_kernel_case,
    max_err,
    sab_compare,
    sab_kernel_case,
    sparse_kernel_case,
    two_stage_kernel_case,
)
from turtlevsr_tpu_torch.kernels import chain2 as C2
from turtlevsr_tpu_torch.kernels import ffn as K
from turtlevsr_tpu_torch.kernels import lattice as L
from turtlevsr_tpu_torch.kernels import level as LV
from turtlevsr_tpu_torch.kernels import sab as S

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]


# every tile of csrc/conv3x3.cu (the 3-channel gather, the narrow, middle
# and wide N tiles, the fallback tile of a large Cin) on maps that do not
# fill the tiles and N tiles that Cout does not fill, a batch of two
CONV_RAGGED_SHAPES = [(2, 37, 53, cin, cout, bias) for cin in (3, 16, 64, 512)
                      for cout in (3, 8, 32, 72, 1024) for bias in (False, True)]
# (B, H, W, C, Cout, bias, ln_bias): the LayerNorm halo at the widths of the
# CHM blocks, Cout = C (the composite v chain) and a narrow Cout
CONV_LN_RAGGED_SHAPES = [(2, 37, 53, c, cout, bias, ln_bias)
                         for c in (64, 128, 256) for cout in (c, 32)
                         for bias, ln_bias in ((False, True), (True, False))]
# (B, NF, hh, ww, ws, C, ring): HW = hh * ww of 400 (a 320 tile at dec3),
# 47 (a prime: every query tile and key chunk ragged, rows of a off the
# 16-byte grid) and multiples of 80 (the tall query tile full); D = ws^2 C
# from 8 to 16384; one to five value tensors
ATTN_V_RAGGED_SHAPES = [(1, 1, 47, 1, 1, 8, False), (2, 5, 20, 20, 4, 256, True),
                        (2, 3, 10, 16, 2, 16, False), (1, 2, 20, 20, 16, 64, True),
                        (1, 4, 16, 15, 2, 40, True), (3, 1, 40, 4, 8, 16, False),
                        (1, 3, 1, 47, 2, 8, True)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(FFN_KERNEL_CASES))
def test_ffn_kernel_matches_plain(dev, case, dtype):
    if FFN_KERNEL_CASES[case][3] > 128 and dtype == torch.float32:
        pytest.skip("the float32 kernels are built for C <= 128")
    x, kw = ffn_kernel_case(case, Maker(0, dtype, dev))
    before = K.fused_block_ffn.launches
    got = K.fused_block_ffn(x, **kw)
    torch.cuda.synchronize()
    assert K.fused_block_ffn.launches == before + 1
    assert max_err(got, K.ffn_plain(x, **kw)) <= KERNEL_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", QKV_KERNEL_SHAPES)
def test_qkv_stats_kernel_matches_plain(dev, shape, dtype):
    b, h, w, c, heads, biases = shape
    x, kw = chain_kernel_case(Maker(1, dtype, dev), b, h, w, c, 3 * c, biases)
    got = K.fused_qkv_stats(x, heads=heads, **kw)
    torch.cuda.synchronize()
    want = K.qkv_stats_plain(x, heads=heads, **kw)
    assert max_err(got[0], want[0]) <= KERNEL_TOL[dtype]
    assert max_err(got[1] / (h * w), want[1] / (h * w)) <= KERNEL_TOL[dtype]
    assert max_err(got[2] / (h * w), want[2] / (h * w)) <= KERNEL_TOL[dtype]
    again = K.fused_qkv_stats(x, heads=heads, **kw)
    torch.cuda.synchronize()  # fixed-order sums: bitwise repeatable
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SPLIT_KERNEL_SHAPES)
def test_split_proj_kernel_matches_plain(dev, shape, dtype):
    b, h, w, c, e, n, biases = shape
    x, kw = chain_kernel_case(Maker(2, dtype, dev), b, h, w, c, n * e, biases,
                              ln_bias=biases)
    got = K.fused_ln_split_proj(x, n_out=n, **kw)
    torch.cuda.synchronize()
    want = K.split_proj_plain(x, n_out=n, **kw)
    assert max(max_err(g, w_) for g, w_ in zip(got, want)) <= KERNEL_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", CONV_KERNEL_SHAPES + CONV_RAGGED_SHAPES)
def test_conv3x3_kernel_matches_plain(dev, shape, dtype):
    b, h, w, cin, cout, bias = shape
    m = Maker(3, dtype, dev)
    x = m(b, h, w, cin)
    wt = m(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    bb = m(cout) if bias else None
    before = K.fused_conv3x3.launches
    got = K.fused_conv3x3(x, wt, bb)
    torch.cuda.synchronize()
    assert K.fused_conv3x3.launches == before + 1
    assert got.shape == (b, h, w, cout)
    assert max_err(got, K.conv3x3_plain(x, wt, bb)) <= KERNEL_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(FFN_LIST_CASES))
def test_ffn_kernel_with_lists_matches_plain(dev, case, dtype):
    if FFN_LIST_CASES[case][3] > 128 and dtype == torch.float32:
        pytest.skip("the float32 kernels are built for C <= 128")
    x, kw = ffn_list_case(case, Maker(5, dtype, dev))
    before = K.fused_block_ffn.launches
    got = K.fused_block_ffn(x, **kw)
    torch.cuda.synchronize()
    assert K.fused_block_ffn.launches == before + 1
    assert max_err(got, K.ffn_plain(x, **kw)) <= KERNEL_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SPLIT_KERNEL_SHAPES)
def test_split_proj_kernel_without_layernorm_matches_plain(dev, shape, dtype):
    b, h, w, c, e, n, biases = shape
    x, kw = chain_kernel_case(Maker(6, dtype, dev), b, h, w, c, n * e, biases)
    kw["ln_w"] = kw["ln_b"] = None
    got = K.fused_ln_split_proj(x, n_out=n, **kw)
    torch.cuda.synchronize()
    want = K.split_proj_plain(x, n_out=n, **kw)
    assert max(max_err(g, w_) for g, w_ in zip(got, want)) <= KERNEL_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", CONV_LN_KERNEL_SHAPES + CONV_LN_RAGGED_SHAPES)
def test_conv3x3_kernel_with_layernorm_matches_plain(dev, shape, dtype):
    b, h, w, cin, cout, bias, ln_bias = shape
    if cin > 128 and dtype == torch.float32:
        pytest.skip("the float32 kernels are built for C <= 128")
    m = Maker(7, dtype, dev)
    x = m(b, h, w, cin)
    wt = m(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    kw = dict(ln_w=m(cin), ln_b=m(cin) if ln_bias else None)
    bb = m(cout) if bias else None
    got = K.fused_conv3x3(x, wt, bb, **kw)
    torch.cuda.synchronize()
    assert max_err(got, K.conv3x3_plain(x, wt, bb, **kw)) <= KERNEL_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", CHM_KERNEL_SHAPES)
def test_chm_stats_kernel_matches_plain(dev, shape, dtype):
    b, h, w, c, heads, nf, ln_bias = shape
    if c > 128 and dtype == torch.float32:
        pytest.skip("the float32 kernels are built for C <= 128")
    x, x_sp, kw = chm_kernel_case(Maker(8, dtype, dev), *shape)
    before = K.fused_chm_stats.launches
    got = K.fused_chm_stats(x, x_sp, **kw)
    torch.cuda.synchronize()
    assert K.fused_chm_stats.launches == before + 1
    want = K.chm_stats_plain(x, x_sp, **kw)
    assert got[1].shape == (b, nf, h, w, c)
    assert got[3].shape == (b, nf, heads, c // heads, c // heads)
    assert max_err(got[0], want[0]) <= KERNEL_TOL[dtype]
    assert max_err(got[1], want[1]) <= KERNEL_TOL[dtype]
    for g, w_ in zip(got[2:], want[2:]):  # sums over h * w pixels
        assert max_err(g / (h * w), w_ / (h * w)) <= KERNEL_TOL[dtype]
    again = K.fused_chm_stats(x, x_sp, **kw)
    torch.cuda.synchronize()  # fixed-order sums: bitwise repeatable
    assert all(torch.equal(g, a) for g, a in zip(got[2:], again[2:]))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SAB_KERNEL_SHAPES)
def test_sab_kernel_exact_inputs_same_support(dev, shape, dtype):
    """Scores that are exact in fp32 whatever the order of the sum, with many
    ties: the kernel must keep the same entries as the plain version, bit
    for bit, and agree within 2^-9 on their values."""
    b, nf, hq, wq, d = shape
    q, k, temp, fv = sab_kernel_case(Maker(9, dtype, dev), *shape, exact=True)
    before = S.sab_attn_probs.launches
    got = S.sab_attn_probs(q, k, temp, fv, grid_wq=wq)
    torch.cuda.synchronize()
    assert S.sab_attn_probs.launches == before + 1
    want = S.sab_attn_probs_plain(q, k, temp, fv, grid_wq=wq)
    assert got.shape == (b, nf, hq * wq, hq * wq)
    assert torch.equal(got != 0, want != 0)
    assert max_err(got, want) <= 2.0 ** -9
    if nf > 1:
        assert got[:, 1].abs().max() == 0  # the invalid frame


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SAB_KERNEL_SHAPES)
def test_sab_kernel_normal_inputs(dev, shape, dtype):
    """Unit vectors: another order of the fp32 sum can move a score across
    a rounding boundary of the map's type and so change which five are kept.
    The rows whose support agrees must agree in value; the share of the
    others is bounded (bfloat16 scores take few values, so near-ties are
    common there; in float32 they are not)."""
    wq = shape[3]
    q, k, temp, fv = sab_kernel_case(Maker(10, dtype, dev), *shape,
                                     exact=False)
    got = S.sab_attn_probs(q, k, temp, fv, grid_wq=wq)
    torch.cuda.synchronize()
    want = S.sab_attn_probs_plain(q, k, temp, fv, grid_wq=wq)
    share, err = sab_compare(got, want)
    assert share <= (0.25 if dtype == torch.bfloat16 else 0.02)
    assert err <= (2.0 ** -6 if dtype == torch.bfloat16 else 1e-5)
    sums = got.float().sum(dim=-1)
    assert torch.all((sums - fv[None, :, None]).abs() <= 0.02)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", LATTICE_KERNEL_SHAPES)
def test_lattice_kernels_match_plain(dev, shape, dtype):
    n, hh, ww, ws, c = shape
    if (c * (4 if dtype == torch.float32 else 2)) % 16:
        pytest.skip("a pixel's channels must fill 16-byte pieces")
    x = Maker(11, dtype, dev)(n, hh * ws, ww * ws, c)
    tok = L.lattice_split(x, ws)
    back = L.lattice_merge(tok, ws, hh * ws, ww * ws)
    torch.cuda.synchronize()
    assert torch.equal(tok, L.lattice_split_plain(x, ws))
    assert torch.equal(back, x)
    assert torch.equal(back, L.lattice_merge_plain(tok, ws, hh * ws, ww * ws))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", ATTN_V_KERNEL_SHAPES + ATTN_V_RAGGED_SHAPES)
def test_attn_v_kernel_matches_plain(dev, shape, dtype):
    """Both epilogues of the attention @ values kernel: the slots layout and
    the merged maps, values read from ring views or from their own tensors,
    query rows and keys that do not fill the query tiles."""
    b, nf, hh, ww, ws, c, _ = shape
    a, vs = attn_v_kernel_case(Maker(12, dtype, dev), *shape)
    h, w = hh * ws, ww * ws
    before = S.sab_attn_v_merge.launches, S.sab_attn_v_slots.launches
    maps = S.sab_attn_v_merge(a, vs, ws, h, w)
    slots = S.sab_attn_v_slots(a, vs, c)
    torch.cuda.synchronize()
    assert (S.sab_attn_v_merge.launches, S.sab_attn_v_slots.launches) == (
        before[0] + 1, before[1] + 1)
    assert maps.shape == (b * nf, h, w, c)
    assert slots.shape == (b * nf, ws * ws, hh * ww, c)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 * 4
    assert max_err(maps, S.attn_v_merge_plain(a, vs, ws, h, w)) <= tol
    assert max_err(slots, S.attn_v_slots_plain(a, vs, c)) <= tol
    # the merge is the lattice merge of the token product, bit for bit
    tok = slots.permute(0, 2, 1, 3).reshape(b * nf, hh * ww, -1)
    assert torch.equal(maps, L.lattice_merge_plain(tok, ws, h, w))
    out = torch.full_like(maps, 7.0)
    assert S.sab_attn_v_merge(a, vs, ws, h, w, out=out) is out
    torch.cuda.synchronize()
    assert torch.equal(out, maps)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", LEVEL_KERNEL_SHAPES)
def test_level_run_kernel_matches_plain_and_split(dev, shape, dtype):
    """The run kernel against its plain version and, with a tighter limit,
    against the split kernels it shares its device code with."""
    if shape[3] > 128 and dtype == torch.float32:
        pytest.skip("the float32 kernels are built for C <= 128")
    x, blocks = level_kernel_case(Maker(13, dtype, dev), *shape)
    heads = shape[5]
    before = LV.fused_channel_gffw_run.launches
    got = LV.fused_channel_gffw_run(x, blocks, heads)
    torch.cuda.synchronize()
    assert LV.fused_channel_gffw_run.launches == before + 1
    assert got.shape == x.shape and bool(torch.isfinite(got.float()).all())
    want = LV.channel_gffw_run_plain(x, blocks, heads)
    split = LV.channel_gffw_run_split(x, blocks, heads)
    torch.cuda.synchronize()
    n = len(blocks)
    assert max_err(got, want) <= KERNEL_TOL[dtype] * n
    # same device code, same rounding points: only the softmax's exp and
    # divide differ (the card's against the library's)
    assert max_err(got, split) <= (1e-5 if dtype == torch.float32
                                   else KERNEL_TOL[dtype] / 4) * n
    again = LV.fused_channel_gffw_run(x, blocks, heads)
    torch.cuda.synchronize()  # fixed-order sums: bitwise repeatable
    assert torch.equal(got, again)


def test_level_run_longer_than_one_launch(dev):
    shape = (1, 8, 8, 16, 8, 1, LV.MAX_RUN + 2, True)
    x, blocks = level_kernel_case(Maker(14, torch.float32, dev), *shape)
    before = LV.fused_channel_gffw_run.launches
    got = LV.fused_channel_gffw_run(x, blocks, 1)
    torch.cuda.synchronize()
    assert LV.fused_channel_gffw_run.launches == before + 2
    assert max_err(got, LV.channel_gffw_run_plain(x, blocks, 1)) <= 1e-3


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(TWO_STAGE_KERNEL_CASES))
def test_two_stage_kernel_matches_plain_and_split(dev, case, dtype):
    """Row 13 against its plain version, and against the split route it
    replaces (two launches of the FFN kernel), whose arithmetic it repeats
    pixel by pixel: equal up to a last-place difference now and then (the
    two builds do not round every step alike: up to 8.6e-7 in float32)."""
    x, st1, st2, ffw1, ffw2 = two_stage_kernel_case(case, Maker(9, dtype, dev))
    before = C2.fused_two_stage.launches
    got = C2.fused_two_stage(x, st1, st2, ffw1=ffw1, ffw2=ffw2)
    torch.cuda.synchronize()
    assert C2.fused_two_stage.launches == before + 1
    want = C2.two_stage_plain(x, st1, st2, ffw1=ffw1, ffw2=ffw2)
    err = max_err(got, want)
    assert err <= 2 * KERNEL_TOL[dtype], err
    y = K.fused_block_ffn(x, ffw2=ffw1, **st1)
    split = K.fused_block_ffn(y, ffw2=ffw2, **st2)
    assert max_err(got, split) <= KERNEL_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SPARSE_KERNEL_SHAPES)
def test_sparse_softmax_kernel_matches_plain(dev, shape, dtype):
    """Row 12: the scores are given, so the kernel and the plain version keep
    the same entries; the values differ by the order of the fp32 sum and the
    exponential (one bf16 rounding of values <= 1)."""
    s, mask = sparse_kernel_case(Maker(10, dtype, dev), *shape)
    before = S.sab_sparse_softmax.launches
    got = S.sab_sparse_softmax(s, mask)
    torch.cuda.synchronize()
    assert S.sab_sparse_softmax.launches == before + 1
    want = S.sparse_softmax_plain(s, mask)
    assert torch.equal(got != 0, want != 0)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    assert max_err(got, want) <= tol
    assert ((got.float().sum(-1) - 1.0).abs() <= 0.02).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SAB_KERNEL_SHAPES)
def test_sparse_softmax_kernel_is_row_7_after_its_scores(dev, shape, dtype):
    """On scores that are exact in fp32 whatever the order of the sum, row 12
    on row 7's rounded scores and the token grid's mask gives row 7's
    probabilities bit for bit: the two kernels share their row body."""
    from turtlevsr_tpu_torch.ops.attn_utils import local_window_mask

    b, nf, hq, wq, d = shape
    q, k, temp, _ = sab_kernel_case(Maker(11, dtype, dev), b, nf, hq, wq, d,
                                    exact=True)
    row7 = S.sab_attn_probs(q, k, temp, None, grid_wq=wq)
    s = (torch.einsum("bqd,bnkd->bnqk", q.float(), k.float())
         * temp.float()).to(dtype).contiguous()
    hw = hq * wq
    row12 = S.sab_sparse_softmax(s.reshape(b * nf, hw, hw),
                                 local_window_mask(hq, wq, 4, dtype, dev))
    torch.cuda.synchronize()
    assert torch.equal(row12.reshape(row7.shape), row7)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    m = Maker(4, torch.bfloat16, dev)
    x = m(1, 8, 8, 16)
    kw = dict(ln_w=m(16), w1=m(16, 32), wd=m(3, 3, 32), w2=m(32, 16),
              mode="gelu")
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_block_ffn(x.transpose(1, 2), **kw)
    with pytest.raises(ValueError, match="expected"):
        K.fused_block_ffn(x, **{**kw, "w2": m(32, 16).float()})
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        K.fused_block_ffn(x.double(), **{k: (v.double() if torch.is_tensor(v)
                                             else v) for k, v in kw.items()})
    with pytest.raises(ValueError, match="shape"):
        K.fused_block_ffn(x, **{**kw, "wd": m(3, 3, 16)})
    with pytest.raises(ValueError, match="up to 5"):
        K.fused_block_ffn(x, x2=[m(1, 6, 8, 8, 16)],
                          po_w=[m(16, 16) for _ in range(6)], **kw)
    with pytest.raises(ValueError, match="multiple of 8"):
        L.lattice_split(m(1, 4, 4, 4), 2)
    with pytest.raises(ValueError, match="grids differ"):
        S.sab_attn_probs(m(1, 8, 16), m(1, 1, 12, 16), torch.ones(1),
                         grid_wq=4)
    with pytest.raises(ValueError, match="shared memory"):
        S.sab_attn_probs(m(1, 20000, 16), m(1, 1, 20000, 16), torch.ones(1),
                         grid_wq=200)
    a = m(2, 8, 8)
    with pytest.raises(ValueError, match="multiple of 8"):
        S.sab_attn_v_slots(a, m(2, 8, 24), 12)
    with pytest.raises(ValueError, match="contiguous"):
        S.sab_attn_v_merge(a, m(2, 8, 64)[:, :, ::2], 2, 4, 8)
    with pytest.raises(ValueError, match="do not give"):
        S.sab_attn_v_merge(a, m(2, 8, 32), 2, 4, 6)
    xl, blocks = level_kernel_case(m, 1, 8, 8, 16, 8, 2, 2, True)
    with pytest.raises(ValueError, match="shape"):
        LV.fused_channel_gffw_run(xl, [dict(blocks[0], wpo=m(16, 8))], 2)
    with pytest.raises(ValueError, match="C / heads"):
        LV.fused_channel_gffw_run(xl, blocks, 3)
