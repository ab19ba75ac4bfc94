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
    CHM_KERNEL_SHAPES,
    CONV_KERNEL_SHAPES,
    CONV_LN_KERNEL_SHAPES,
    FFN_KERNEL_CASES,
    FFN_LIST_CASES,
    KERNEL_TOL,
    LATTICE_KERNEL_SHAPES,
    QKV_KERNEL_SHAPES,
    SAB_KERNEL_SHAPES,
    SPLIT_KERNEL_SHAPES,
    Maker,
    chain_kernel_case,
    chm_kernel_case,
    ffn_kernel_case,
    ffn_list_case,
    max_err,
    sab_compare,
    sab_kernel_case,
)
from turtlevsr_tpu_torch.kernels import ffn as K
from turtlevsr_tpu_torch.kernels import lattice as L
from turtlevsr_tpu_torch.kernels import sab as S

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]


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
@pytest.mark.parametrize("shape", CONV_KERNEL_SHAPES)
def test_conv3x3_kernel_matches_plain(dev, shape, dtype):
    b, h, w, cin, cout, bias = shape
    m = Maker(3, dtype, dev)
    x = m(b, h, w, cin)
    wt = m(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    bb = m(cout) if bias else None
    got = K.fused_conv3x3(x, wt, bb)
    torch.cuda.synchronize()
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
@pytest.mark.parametrize("shape", CONV_LN_KERNEL_SHAPES)
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
