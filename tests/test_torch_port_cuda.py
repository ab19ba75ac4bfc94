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
    CONV_KERNEL_SHAPES,
    FFN_KERNEL_CASES,
    KERNEL_TOL,
    QKV_KERNEL_SHAPES,
    SPLIT_KERNEL_SHAPES,
    Maker,
    chain_kernel_case,
    ffn_kernel_case,
    max_err,
)
from turtlevsr_tpu_torch.kernels import ffn as K

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
