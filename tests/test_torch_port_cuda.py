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
    FFN_C64_CASES,
    FFN_C64_LIST_CASES,
    FFN_KERNEL_CASES,
    FFN_LIST_CASES,
    FFN_WG_CASES,
    FFN_WG_LIST_CASES,
    KERNEL_TOL,
    LATTICE_KERNEL_SHAPES,
    LEVEL_KERNEL_SHAPES,
    QKV_KERNEL_SHAPES,
    SAB_KERNEL_SHAPES,
    SPARSE_KERNEL_SHAPES,
    SPLIT_KERNEL_SHAPES,
    TWO_STAGE_KERNEL_CASES,
    TWO_STAGE_WG_CASES,
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
from reference_oracle import tiny_opt
from test_torch_port_pw_split_c64 import FFN_PW_CASES, SPLIT_C64_CASES
from turtlevsr_tpu_torch import kernels as KP
from turtlevsr_tpu_torch.kernels import chain2 as C2
from turtlevsr_tpu_torch.kernels import ffn as K
from turtlevsr_tpu_torch.kernels import lattice as L
from turtlevsr_tpu_torch.kernels import level as LV
from turtlevsr_tpu_torch.kernels import sab as S
from turtlevsr_tpu_torch.kernels import vjp as V

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
    x, kw = ffn_kernel_case(case, Maker(0, dtype, dev))
    before = K.fused_block_ffn.launches
    got = K.fused_block_ffn(x, **kw)
    torch.cuda.synchronize()
    assert K.fused_block_ffn.launches == before + 1
    assert max_err(got, K.ffn_plain(x, **kw)) <= KERNEL_TOL[dtype]


@pytest.mark.parametrize("case", list(FFN_WG_CASES) + list(FFN_WG_LIST_CASES))
def test_ffn_wg_body_matches_plain(dev, case):
    """The wgmma body (csrc/ffn_wg.cu) on the calls its plan gives it (one
    map, lists of maps, the chained FFW), and the mma.sync body just outside
    them: one launch either way, within the tolerance of the plain version,
    bitwise repeatable."""
    if case in FFN_WG_LIST_CASES:
        x, kw = ffn_list_case(case, Maker(15, torch.bfloat16, dev),
                              FFN_WG_LIST_CASES)
    else:
        x, kw = ffn_kernel_case(case, Maker(15, torch.bfloat16, dev),
                                FFN_WG_CASES)
    on_wg = not case.startswith("tile_")
    before, wg_before = K.fused_block_ffn.launches, K.fused_block_ffn.launches_wg
    got = K.fused_block_ffn(x, **kw)
    torch.cuda.synchronize()
    assert K.fused_block_ffn.launches == before + 1
    assert K.fused_block_ffn.launches_wg == wg_before + on_wg
    assert max_err(got, K.ffn_plain(x, **kw)) <= KERNEL_TOL[torch.bfloat16]
    again = K.fused_block_ffn(x, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def test_ffn_wg_smem_mirror_matches_the_source(dev):
    from turtlevsr_tpu_torch.kernels import build

    lib = build.load("ffn_wg")
    # every form of a width takes the same shared memory: the lists and the
    # chained FFW live in the regions of the single-map form
    for c in (128, 256, 512):
        for gate in (0, 1):
            assert lib.turtle_ffn_wg_smem(c, gate) == K._wg_smem(c, gate)[0]


@pytest.mark.parametrize("case", list(FFN_C64_CASES) + list(FFN_C64_LIST_CASES))
def test_ffn_c64_body_matches_plain(dev, case):
    """The C = 64 body (csrc/ffn_c64.cu) on the calls its plan gives it (no
    x2, one map or a list with po, the chained FFW) on ragged and small maps,
    batches with per-batch po, grids of fewer tiles than SMs; the mma.sync
    body just outside its forms: one launch either way, within 2^-7 of the
    largest output of the plain version, bitwise repeatable."""
    if case in FFN_C64_LIST_CASES:
        x, kw = ffn_list_case(case, Maker(16, torch.bfloat16, dev),
                              FFN_C64_LIST_CASES)
    else:
        x, kw = ffn_kernel_case(case, Maker(16, torch.bfloat16, dev),
                                FFN_C64_CASES)
    on_c64 = not case.startswith("tile_")
    before = K.fused_block_ffn.launches
    c64_before = K.fused_block_ffn.launches_c64
    got = K.fused_block_ffn(x, **kw)
    torch.cuda.synchronize()
    assert K.fused_block_ffn.launches == before + 1
    assert K.fused_block_ffn.launches_c64 == c64_before + on_c64
    want = K.ffn_plain(x, **kw)
    assert torch.isfinite(got.float()).all()
    assert max_err(got, want) <= 2.0 ** -7 * want.float().abs().max().item()
    again = K.fused_block_ffn(x, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


# sha256 of the C = 64 body's output (its bf16 bits) on one card case a
# form, as the body gave them before its walk, ring, LN pass and taps moved
# into csrc/c64_tile.cuh (NVIDIA H100 80GB HBM3): the move changed no bit
FFN_C64_BITS = {
    "gate_no_pair_ragged":
        "1a513e0a8b843bfabdd4315457d8819a0c58d43a2b491cb6190d775b965e978e",
    "gelu_scale_ragged":
        "8a4708ae398476273c12aed774a9203f63dae6c510e83acbdb328f9502c05a57",
    "gate_pair_po_batched_ragged":
        "8991560f7e35b4c8b8a40beb7c15dd8eaab7e481e8c104ebe2ae46294207119c",
    "gate_pair_po_batched_15_tiles":
        "6a60da66e977340c5b2bf0e7be0be74958fc8333bf616ad9922dce557f82255f",
    "gelu_scale_ffw2_ragged":
        "cf80423e7edec65555804402c60a80c92c1f8f87695de2a35ebf2445c7e263c2",
    "lists_stack3_single_ragged":
        "cfefee384fd25dd943a213529f6b42bbe6907d4432cfcdc4f3c5fe6e0f8b153c",
}


@pytest.mark.parametrize("case", list(FFN_C64_BITS))
def test_ffn_c64_bits_unchanged_by_the_shared_header(dev, case):
    import hashlib

    m = Maker(16, torch.bfloat16, dev)
    if case in FFN_C64_LIST_CASES:
        x, kw = ffn_list_case(case, m, FFN_C64_LIST_CASES)
    else:
        x, kw = ffn_kernel_case(case, m, FFN_C64_CASES)
    before = K.fused_block_ffn.launches_c64
    got = K.fused_block_ffn(x, **kw)
    torch.cuda.synchronize()
    assert K.fused_block_ffn.launches_c64 == before + 1
    bits = got.view(torch.int16).cpu().numpy().tobytes()
    assert hashlib.sha256(bits).hexdigest() == FFN_C64_BITS[case]


def test_ffn_c64_smem_mirror_matches_the_source(dev):
    from turtlevsr_tpu_torch.kernels import build

    lib = build.load("ffn_c64")
    for ch, e, gate, n_po, f in ((320, 160, 1, 0, 0), (320, 160, 1, 1, 0),
                                 (320, 160, 1, 4, 0), (320, 160, 1, 5, 0),
                                 (128, 128, 0, 0, 0), (128, 128, 0, 0, 128),
                                 (64, 64, 0, 2, 0)):
        assert lib.turtle_ffn_c64_smem(ch, e, gate, n_po, f) == K._c64_smem(
            ch, e, bool(gate), n_po, f)[0]


@pytest.mark.parametrize("case", list(FFN_PW_CASES))
def test_ffn_pw_body_matches_plain(dev, case):
    """The body without a depthwise stage (csrc/ffn_pw.cu) on the calls its
    plan gives it (one map with a per-batch or shared po, with and without
    po_b, a map without po, no map; ragged pixel counts, maps smaller than a
    tile, batches the persistent grid splits), and ffn.cu just outside its
    forms: one launch either way, within 2^-7 of the largest output of the
    plain version, bitwise repeatable."""
    x, kw = ffn_kernel_case(case, Maker(20, torch.bfloat16, dev), FFN_PW_CASES)
    on_pw = not case.startswith("tile_")
    before = K.fused_block_ffn.launches
    pw_before = K.fused_block_ffn.launches_pw
    no_dw_before = K.fused_block_ffn.launches_no_dw
    got = K.fused_block_ffn(x, **kw)
    torch.cuda.synchronize()
    assert K.fused_block_ffn.launches == before + 1
    assert K.fused_block_ffn.launches_no_dw == no_dw_before + 1
    assert K.fused_block_ffn.launches_pw == pw_before + on_pw
    want = K.ffn_plain(x, **kw)
    assert torch.isfinite(got.float()).all()
    assert max_err(got, want) <= 2.0 ** -7 * want.float().abs().max().item()
    again = K.fused_block_ffn(x, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def test_ffn_pw_smem_mirror_matches_the_source(dev):
    from turtlevsr_tpu_torch.kernels import build

    lib = build.load("ffn_pw")
    for c in K._PW_WIDTHS:
        assert lib.turtle_ffn_pw_smem(c) == K._pw_smem(c)[0]


@pytest.mark.parametrize("case", list(SPLIT_C64_CASES))
def test_split_c64_body_matches_plain(dev, case):
    """The split projection's C = 64 body (csrc/split_c64.cu) at 1-4 chains,
    with and without ln_b, on ragged maps, a map smaller than a tile, one
    tile and 15 tiles: one launch, every map within 2^-7 of the largest
    output of the plain version, bitwise repeatable."""
    b, h, w, n_out, ln_bias = SPLIT_C64_CASES[case]
    x, kw = chain_kernel_case(Maker(21, torch.bfloat16, dev), b, h, w, 64,
                              n_out * 64, False, ln_bias=ln_bias)
    before = K.fused_ln_split_proj.launches
    c64_before = K.fused_ln_split_proj.launches_c64
    got = K.fused_ln_split_proj(x, n_out=n_out, **kw)
    torch.cuda.synchronize()
    assert K.fused_ln_split_proj.launches == before + 1
    assert K.fused_ln_split_proj.launches_c64 == c64_before + 1
    want = K.split_proj_plain(x, n_out=n_out, **kw)
    assert len(got) == n_out
    for g, w_ in zip(got, want):
        assert torch.isfinite(g.float()).all()
        assert max_err(g, w_) <= 2.0 ** -7 * w_.float().abs().max().item()
    again = K.fused_ln_split_proj(x, n_out=n_out, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def test_split_c64_smem_mirror_matches_the_source(dev):
    from turtlevsr_tpu_torch.kernels import build

    lib = build.load("split_c64")
    for n_out in (1, 2, 3, 4):
        assert lib.turtle_split_c64_smem(n_out) == K._sc_smem(n_out)[0]


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


# the statistics' wgmma body (csrc/stats_wg.cuh) at every width its plans
# take: ragged 2 x 37 x 53 maps, and 3 x 99 x 101 maps whose 507 tiles the
# persistent grid cuts so that batch entries split across block ranges
STATS_REL_TOL = 2.0 ** -9
SW_MAPS = [(2, 37, 53), (3, 99, 101)]


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("hw", SW_MAPS, ids=["ragged", "split"])
@pytest.mark.parametrize("c", K._QKV_WG_WIDTHS)
def test_qkv_wg_body_matches_plain(dev, c, hw):
    b, h, w = hw
    heads = c // 64
    x, kw = chain_kernel_case(Maker(16, torch.bfloat16, dev), b, h, w, c,
                              3 * c, False)
    before, wg_before = K.fused_qkv_stats.launches, K.fused_qkv_stats.launches_wg
    got = K.fused_qkv_stats(x, heads=heads, **kw)
    torch.cuda.synchronize()
    assert K.fused_qkv_stats.launches == before + 1
    assert K.fused_qkv_stats.launches_wg == wg_before + 1
    want = K.qkv_stats_plain(x, heads=heads, **kw)
    assert max_err(got[0], want[0]) <= KERNEL_TOL[torch.bfloat16]
    assert _rel(got[1], want[1]) <= STATS_REL_TOL
    assert _rel(got[2], want[2]) <= STATS_REL_TOL
    again = K.fused_qkv_stats(x, heads=heads, **kw)
    torch.cuda.synchronize()  # fixed-order sums: bitwise repeatable
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    assert torch.equal(got[0], again[0])


@pytest.mark.parametrize("hw", SW_MAPS, ids=["ragged", "split"])
@pytest.mark.parametrize("c", K._CHM_WG_WIDTHS)
def test_chm_wg_body_matches_plain(dev, c, hw):
    b, h, w = hw
    heads, nf = c // 64, 3 if c == 64 else 4
    x, x_sp, kw = chm_kernel_case(Maker(17, torch.bfloat16, dev), b, h, w, c,
                                  heads, nf, True)
    before, wg_before = K.fused_chm_stats.launches, K.fused_chm_stats.launches_wg
    got = K.fused_chm_stats(x, x_sp, **kw)
    torch.cuda.synchronize()
    assert K.fused_chm_stats.launches == before + 1
    assert K.fused_chm_stats.launches_wg == wg_before + 1
    want = K.chm_stats_plain(x, x_sp, **kw)
    assert max_err(got[0], want[0]) <= KERNEL_TOL[torch.bfloat16]
    assert max_err(got[1], want[1]) <= KERNEL_TOL[torch.bfloat16]
    for g, w_ in zip(got[2:], want[2:]):
        assert _rel(g, w_) <= STATS_REL_TOL
    again = K.fused_chm_stats(x, x_sp, **kw)
    torch.cuda.synchronize()  # fixed-order sums: bitwise repeatable
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def test_stats_wg_smem_mirror_matches_the_source(dev):
    from turtlevsr_tpu_torch.kernels import build

    for c in K._QKV_WG_WIDTHS:
        assert build.load("qkv_wg").turtle_qkv_wg_smem(c) == K._sw_smem(
            c, False)[0]
    for c in K._CHM_WG_WIDTHS:
        assert build.load("chm_wg").turtle_chm_wg_smem(c) == K._sw_smem(
            c, True)[0]


# the split projection's wgmma body: every width its plan gives it, two and
# three chains, on a ragged map of two entries that the persistent grid
# splits and on a chunk of 15 latent tiles
SPLIT_WG_MAPS = [(2, 37, 53), (15, 40, 40)]


@pytest.mark.parametrize("hw", SPLIT_WG_MAPS, ids=["ragged", "tiles"])
@pytest.mark.parametrize("n_out", [2, 3])
@pytest.mark.parametrize("c", K._SPLIT_WG_WIDTHS)
def test_split_wg_body_matches_plain(dev, c, n_out, hw):
    b, h, w = hw
    x, kw = chain_kernel_case(Maker(18, torch.bfloat16, dev), b, h, w, c,
                              n_out * c, False)
    before = K.fused_ln_split_proj.launches
    wg_before = K.fused_ln_split_proj.launches_wg
    got = K.fused_ln_split_proj(x, n_out=n_out, **kw)
    torch.cuda.synchronize()
    assert K.fused_ln_split_proj.launches == before + 1
    assert K.fused_ln_split_proj.launches_wg == wg_before + 1
    want = K.split_proj_plain(x, n_out=n_out, **kw)
    assert max(max_err(g, w_) for g, w_ in zip(got, want)) <= KERNEL_TOL[
        torch.bfloat16]
    again = K.fused_ln_split_proj(x, n_out=n_out, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def test_split_wg_smem_mirror_matches_the_source(dev):
    from turtlevsr_tpu_torch.kernels import build

    for c in K._SPLIT_WG_WIDTHS:
        assert build.load("split_wg").turtle_split_wg_smem(c) == K._spw_smem(
            c)[0]


# the probabilities' wgmma body: (B, NF, hq, wq, D, k_top): chunks of 20 x
# 20 token grids, the whole frame's 46 x 80, a ragged grid (HW = 221, rows
# off the 16-byte grid), fewer keys than k_top, and every k_top; the call
# whose plan gives sab.cu (D = 128 on the 20 x 20 grid) is sent to the wgmma
# body here like the others
SAB_WG_CASES = [(2, 4, 20, 20, 512, 5), (15, 3, 20, 20, 128, 5),
                (1, 4, 46, 80, 256, 4), (1, 3, 46, 80, 128, 3),
                (3, 3, 13, 17, 128, 2), (1, 4, 2, 2, 64, 5),
                (2, 3, 9, 7, 256, 1)]
SAB_MAX_FLIP_SHARE = 0.25
SAB_TOL = 2.0 ** -6


@pytest.mark.parametrize("case", SAB_WG_CASES, ids=lambda c: "x".join(
    map(str, c)))
def test_sab_wg_body_matches_plain(dev, case, monkeypatch):
    """Exact scores: the same support bit for bit, values within 2^-9, and
    row 12 on the body's rounded scores bit for bit the body; unit vectors:
    the share of rows whose support flips and the error on the others
    within the limits of chip_smoke.py; two launches equal."""
    from turtlevsr_tpu_torch.ops.attn_utils import local_window_mask

    b, nf, hq, wq, d, k_top = case
    hw = hq * wq
    monkeypatch.setattr(S, "_sab_plan", lambda *a, **kw: "wg")
    for exact in (True, False):
        q, k, temp, fv = sab_kernel_case(Maker(19, torch.bfloat16, dev), b,
                                         nf, hq, wq, d, exact=exact)
        before, wg_before = S.sab_attn_probs.launches, S.sab_attn_probs.launches_wg
        got = S.sab_attn_probs(q, k, temp, fv, grid_wq=wq, k_top=k_top)
        torch.cuda.synchronize()
        assert S.sab_attn_probs.launches == before + 1
        assert S.sab_attn_probs.launches_wg == wg_before + 1
        want = S.sab_attn_probs_plain(q, k, temp, fv, grid_wq=wq,
                                      k_top=k_top)
        if exact:
            assert torch.equal(got != 0, want != 0)
            assert max_err(got, want) <= 2.0 ** -9
            assert got[:, 1].abs().max() == 0  # the invalid frame
            s = (torch.einsum("bqd,bnkd->bnqk", q.float(), k.float())
                 * temp.float()).bfloat16().reshape(b * nf, hw, hw)
            row12 = S.sab_sparse_softmax(
                s.contiguous(), local_window_mask(hq, wq, 4, torch.bfloat16,
                                                  dev), k_top)
            row7 = S.sab_attn_probs(q, k, temp, None, grid_wq=wq, k_top=k_top)
            torch.cuda.synchronize()
            assert torch.equal(row12.reshape(row7.shape), row7)
        else:
            share, err = sab_compare(got, want)
            assert share <= SAB_MAX_FLIP_SHARE and err <= SAB_TOL
            sums = got.float().sum(dim=-1)
            assert torch.all((sums - fv[None, :, None]).abs() <= 0.02)
        again = S.sab_attn_probs(q, k, temp, fv, grid_wq=wq, k_top=k_top)
        torch.cuda.synchronize()
        assert torch.equal(got, again)


def test_sab_wg_smem_mirror_matches_the_source(dev):
    from turtlevsr_tpu_torch.kernels import build

    for d in (64, 128, 192, 256, 384, 512):
        assert build.load("sab_wg").turtle_sab_wg_smem(d) == S._sb_smem(d)[0]


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
def test_ffn_kernel_with_lists_matches_plain(dev, case, dtype, monkeypatch):
    """ffn.cu's list form, the calls the plan sends to the wgmma body
    (bf16 at C = 128, 256) forced onto it."""
    x, kw = ffn_list_case(case, Maker(5, dtype, dev))
    monkeypatch.setattr(K, "_ffn_plan", lambda *a: ("tile", None))
    before, wg_before = K.fused_block_ffn.launches, K.fused_block_ffn.launches_wg
    got = K.fused_block_ffn(x, **kw)
    torch.cuda.synchronize()
    assert K.fused_block_ffn.launches == before + 1
    assert K.fused_block_ffn.launches_wg == wg_before
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


# float32 at the widths of the serving paths (C = 256 and 512) on the
# mma.sync bodies of rows 1, 3, 4, 5 (with LayerNorm) and 6: every form the
# models give them there, on ragged maps of one or two entries; at C = 512
# the LN halo lives in device memory (csrc/common.cuh)
F32_WIDE_FFN_CASES = {  # fields of FFN_KERNEL_CASES
    "gate_pair_po_batched_c256": (2, 37, 53, 256, 640, "gate", True,
                                  "batched", True, False, False, True),
    "gate_pair_po_batched_c512": (2, 19, 27, 512, 1280, "gate", True,
                                  "batched", False, False, False, True),
    "gate_pair_no_po_c512": (1, 23, 40, 512, 1280, "gate", True, None, False,
                             False, False, True),
    "gate_no_pair_biasfree_ln_c512": (1, 9, 17, 512, 48, "gate", False, None,
                                      True, False, False, False),
    "gelu_scale_c256": (1, 21, 19, 256, 512, "gelu", False, None, True, True,
                        False, True),
}
F32_WIDE_LIST_CASES = {  # fields of FFN_LIST_CASES: dec3's 4 stacked + 1
    "stack4_single_c256_ragged": (1, 37, 53, 256, 640, 4, 1, True, False,
                                  True),
    "stack2_two_singles_shared_po_b_c256": (2, 19, 21, 256, 640, 2, 2, False,
                                            True, False),
}
F32_WIDE_QKV_SHAPES = [(2, 37, 53, 256, 4, False), (1, 19, 27, 512, 8, False),
                       (1, 11, 13, 512, 8, True), (1, 9, 17, 256, 8, True)]
# (B, H, W, C, E, n_out, LayerNorm): the latent's q, k, v, the SAB q, k at
# dec3, the CHM frames' kh, vh (no LayerNorm)
F32_WIDE_SPLIT_SHAPES = [(1, 19, 27, 512, 512, 3, True),
                         (2, 37, 53, 256, 256, 2, True),
                         (3, 23, 29, 256, 256, 2, False),
                         (1, 11, 13, 512, 512, 2, False)]
F32_WIDE_CONV_LN_SHAPES = [(1, 37, 53, 256, 256, False, True),
                           (2, 19, 27, 512, 512, True, True),
                           (1, 23, 29, 256, 32, True, False)]
F32_WIDE_CHM_SHAPES = [(1, 37, 53, 256, 4, 4, True), (2, 19, 27, 256, 4, 2, False),
                       (1, 19, 27, 512, 8, 2, True)]


def _one_launch_on_the_tile_body(fn, before):
    """fn() launched its wrapper's mma.sync body once, no Hopper body."""
    got = fn()
    torch.cuda.synchronize()
    after = KP.launch_counts()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    return got, moved


@pytest.mark.parametrize("case", list(F32_WIDE_FFN_CASES)
                         + list(F32_WIDE_LIST_CASES))
def test_ffn_float32_wide_matches_plain(dev, case):
    m = Maker(21, torch.float32, dev)
    if case in F32_WIDE_LIST_CASES:
        x, kw = ffn_list_case(case, m, F32_WIDE_LIST_CASES)
    else:
        x, kw = ffn_kernel_case(case, m, F32_WIDE_FFN_CASES)
    got, moved = _one_launch_on_the_tile_body(
        lambda: K.fused_block_ffn(x, **kw), KP.launch_counts())
    assert moved == {"ffn": 1}
    assert max_err(got, K.ffn_plain(x, **kw)) <= KERNEL_TOL[torch.float32]


@pytest.mark.parametrize("shape", F32_WIDE_QKV_SHAPES, ids=str)
def test_qkv_stats_float32_wide_matches_plain(dev, shape):
    b, h, w, c, heads, biases = shape
    x, kw = chain_kernel_case(Maker(22, torch.float32, dev), b, h, w, c,
                              3 * c, biases)
    got, moved = _one_launch_on_the_tile_body(
        lambda: K.fused_qkv_stats(x, heads=heads, **kw), KP.launch_counts())
    assert moved == {"qkv_stats": 1}
    want = K.qkv_stats_plain(x, heads=heads, **kw)
    tol = KERNEL_TOL[torch.float32]
    assert max_err(got[0], want[0]) <= tol
    assert max_err(got[1] / (h * w), want[1] / (h * w)) <= tol
    assert max_err(got[2] / (h * w), want[2] / (h * w)) <= tol


@pytest.mark.parametrize("shape", F32_WIDE_SPLIT_SHAPES, ids=str)
def test_split_proj_float32_wide_matches_plain(dev, shape):
    b, h, w, c, e, n, ln = shape
    x, kw = chain_kernel_case(Maker(23, torch.float32, dev), b, h, w, c, n * e,
                              False)
    if not ln:
        kw["ln_w"] = kw["ln_b"] = None
    got, moved = _one_launch_on_the_tile_body(
        lambda: K.fused_ln_split_proj(x, n_out=n, **kw), KP.launch_counts())
    assert moved == {"split_proj": 1}
    want = K.split_proj_plain(x, n_out=n, **kw)
    assert max(max_err(g, w_) for g, w_ in zip(got, want)) <= KERNEL_TOL[
        torch.float32]


@pytest.mark.parametrize("shape", F32_WIDE_CONV_LN_SHAPES, ids=str)
def test_conv3x3_float32_wide_with_layernorm_matches_plain(dev, shape):
    b, h, w, cin, cout, bias, ln_bias = shape
    m = Maker(24, torch.float32, dev)
    x = m(b, h, w, cin)
    wt = m(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    kw = dict(ln_w=m(cin), ln_b=m(cin) if ln_bias else None)
    bb = m(cout) if bias else None
    got, moved = _one_launch_on_the_tile_body(
        lambda: K.fused_conv3x3(x, wt, bb, **kw), KP.launch_counts())
    assert moved == {"conv3x3": 1}
    assert max_err(got, K.conv3x3_plain(x, wt, bb, **kw)) <= KERNEL_TOL[
        torch.float32]


@pytest.mark.parametrize("shape", F32_WIDE_CHM_SHAPES, ids=str)
def test_chm_stats_float32_wide_matches_plain(dev, shape):
    b, h, w, c, heads, nf, ln_bias = shape
    x, x_sp, kw = chm_kernel_case(Maker(25, torch.float32, dev), *shape)
    got, moved = _one_launch_on_the_tile_body(
        lambda: K.fused_chm_stats(x, x_sp, **kw), KP.launch_counts())
    assert moved == {"chm_stats": 1}
    want = K.chm_stats_plain(x, x_sp, **kw)
    tol = KERNEL_TOL[torch.float32]
    assert max_err(got[0], want[0]) <= tol
    assert max_err(got[1], want[1]) <= tol
    for g, w_ in zip(got[2:], want[2:]):  # sums over h * w pixels
        assert max_err(g / (h * w), w_ / (h * w)) <= tol


def test_float32_plans_mirror_the_sources(dev):
    """The float32 plans' shared memory is what each source's function
    gives (the halo in device memory at C = 512 included)."""
    from turtlevsr_tpu_torch.kernels import build

    libs = {n: build.load(n) for n in ("ffn", "qkv_stats", "chm_stats",
                                       "split_proj", "conv3x3", "chain2",
                                       "level")}
    for c in range(16, 513, 16):
        assert libs["ffn"].turtle_ffn_smem(c, 0, 0, 0, 1) == K._ffn_f32_plan(
            1, 8, 8, c, 1, 0)["smem"]
        if c <= 256:
            assert libs["ffn"].turtle_ffn_smem(c, 0, 0, 0, 5) == \
                K._ffn_f32_plan(1, 8, 8, c, 5, 0)["smem"]
        if c <= 128:
            assert libs["ffn"].turtle_ffn_smem(c, 2 * c, 1, 0, 1) == \
                K._ffn_f32_plan(1, 8, 8, c, 1, 2 * c)["smem"]
            assert libs["chain2"].turtle_two_stage_smem(c, 0) == \
                C2._two_stage_f32_plan(1, 8, 8, c)["smem"]
        for heads in {max(1, c // 64), c // 16}:
            if c % heads == 0 and c // heads <= 64:
                assert libs["qkv_stats"].turtle_qkv_stats_smem(c, heads, 0) \
                    == K._qkv_f32_plan(1, 8, 8, c, heads)["smem"]
                assert libs["chm_stats"].turtle_chm_stats_smem(c, heads, 0) \
                    == K._chm_f32_plan(1, 8, 8, c, heads, 2)["smem"]
                assert libs["level"].turtle_level_smem(c, heads, 0) == \
                    LV._level_f32_plan(1, 8, 8, c, heads)["smem"]
        assert libs["split_proj"].turtle_split_proj_smem(c, 0) == \
            K._split_f32_plan(1, 8, 8, c)["smem"]
        assert libs["conv3x3"].turtle_conv3x3_smem(c, 0) == \
            K._conv_f32_plan(1, 8, 8, c, 128, True)["smem"]


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


# (n, hh, ww, ws, C): the paths' token grids at the whole 736x1280 frame (n
# = 1) and at 45 tiles of 320 (dec3 / dec2 / dec1: windows 4 / 8 / 16), and
# ragged token grids whose images are no multiple of a block's 2048 vectors,
# one of 3 vectors a pixel (C = 24 in bf16)
LATTICE_GRID_SHAPES = [(1, 46, 80, 4, 256), (1, 46, 80, 8, 128),
                       (1, 46, 80, 16, 64), (45, 20, 20, 4, 256),
                       (45, 20, 20, 8, 128), (45, 20, 20, 16, 64),
                       (1, 23, 17, 4, 256), (3, 13, 7, 8, 24),
                       (2, 5, 11, 16, 8)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", LATTICE_GRID_SHAPES, ids=str)
def test_lattice_kernels_bit_for_bit_on_the_paths_grids(dev, shape, dtype):
    """The kernel walks each image's map vectors in blocks of 2048: bit for
    bit both ways at one image and at 45, at every window of the paths, and
    on token grids that leave a block partly empty."""
    n, hh, ww, ws, c = shape
    if (c * (4 if dtype == torch.float32 else 2)) % 16:
        pytest.skip("a pixel's channels must fill 16-byte pieces")
    h, w = hh * ws, ww * ws
    x = Maker(13, dtype, dev)(n, h, w, c)
    s0, m0 = L.lattice_split.launches, L.lattice_merge.launches
    tok = L.lattice_split(x, ws)
    back = L.lattice_merge(tok, ws, h, w)
    torch.cuda.synchronize()
    assert (L.lattice_split.launches, L.lattice_merge.launches) == (s0 + 1,
                                                                    m0 + 1)
    assert torch.equal(tok, L.lattice_split_plain(x, ws))
    assert torch.equal(back, x)
    other = torch.randn_like(tok)
    assert torch.equal(L.lattice_merge(other, ws, h, w),
                       L.lattice_merge_plain(other, ws, h, w))


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


# row 14 in float32 at the paths' widths on csrc/level.cu: (B, H, W, C, E,
# heads, blocks, ln_bias); at C = 256 the LN halo of both tile phases in
# shared memory, at C = 512 in the device-memory scratch (one slice a tile
# of the batch), ragged maps, a batch of two
LEVEL_F32_WIDE_SHAPES = [(1, 19, 27, 256, 640, 4, 2, True),
                         (2, 11, 13, 256, 96, 4, 3, False),
                         (1, 19, 27, 512, 1280, 8, 2, True),
                         (2, 11, 13, 512, 256, 8, 3, False)]


@pytest.mark.parametrize("shape", LEVEL_F32_WIDE_SHAPES, ids=str)
def test_level_run_float32_wide_matches_plain_and_split(dev, shape):
    """The run kernel in float32 at C = 256 and 512 (fault F3 closed): one
    launch of csrc/level.cu, none of the Hopper body, against its plain
    version and, with the tighter limit, against the split kernels whose
    float32 tile code it runs (qkv_stats.cu and ffn.cu with the same halo
    placement); bitwise repeatable."""
    x, blocks = level_kernel_case(Maker(26, torch.float32, dev), *shape)
    heads, n = shape[5], shape[6]
    assert LV._level_f32_plan(*shape[:4], heads)["halo"] == (
        "device" if shape[3] > 256 else "shared")
    before = LV.fused_channel_gffw_run.launches
    wg_before = LV.fused_channel_gffw_run.launches_wg
    got = LV.fused_channel_gffw_run(x, blocks, heads)
    torch.cuda.synchronize()
    assert LV.fused_channel_gffw_run.launches == before + 1
    assert LV.fused_channel_gffw_run.launches_wg == wg_before
    assert got.shape == x.shape and bool(torch.isfinite(got).all())
    want = LV.channel_gffw_run_plain(x, blocks, heads)
    assert max_err(got, want) <= KERNEL_TOL[torch.float32] * n
    split = LV.channel_gffw_run_split(x, blocks, heads)
    assert max_err(got, split) <= 1e-5 * n
    again = LV.fused_channel_gffw_run(x, blocks, heads)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def test_level_run_longer_than_one_launch(dev):
    shape = (1, 8, 8, 16, 8, 1, LV.MAX_RUN + 2, True)
    x, blocks = level_kernel_case(Maker(14, torch.float32, dev), *shape)
    before = LV.fused_channel_gffw_run.launches
    got = LV.fused_channel_gffw_run(x, blocks, 1)
    torch.cuda.synchronize()
    assert LV.fused_channel_gffw_run.launches == before + 2
    assert max_err(got, LV.channel_gffw_run_plain(x, blocks, 1)) <= 1e-3


# row 14's Hopper body (csrc/level_wg.cu): (B, H, W, C, E, heads, blocks,
# ln_bias). The runs of the paths at 15 tiles and the latent's whole frame;
# a ragged map of two entries; runs of 1, 2, 10 and 11 blocks (11: two
# launches) with and without LayerNorm biases; E = 96, whose last 64-column
# chunk is half empty (the stacked w2's 3-D tensor map reads zeros past E)
LEVEL_WG_CASES = {
    "enc3_15_tiles_x10": (15, 80, 80, 256, 640, 4, 10, True),
    "latent_15_tiles_x9": (15, 40, 40, 512, 1280, 8, 9, True),
    "dec2_15_tiles_x5": (15, 160, 160, 128, 320, 2, 5, True),
    "latent_whole_frame_x9": (1, 92, 160, 512, 1280, 8, 9, True),
    "ragged_2_maps_x3": (2, 37, 53, 256, 640, 4, 3, False),
    **{f"x{n}_{'with' if ln else 'no'}_ln_b": (2, 19, 27, 128, 320, 2, n, ln)
       for n in (1, 2, 10, 11) for ln in (True, False)},
    "e96_half_chunk_x2": (1, 24, 40, 128, 96, 2, 2, True),
}


@pytest.mark.parametrize("case", list(LEVEL_WG_CASES))
def test_level_wg_body_matches_plain_and_split(dev, case):
    """The Hopper body on the runs its plan gives it: one launch a run of up
    to 10 blocks, within the plain version's limit (KERNEL_TOL a block) and
    within 2^-7 of the largest output of the model's split route, whose
    bodies and partition it runs; bitwise repeatable."""
    b, h, w, c, e, heads, n, ln_bias = LEVEL_WG_CASES[case]
    x, blocks = level_kernel_case(Maker(19, torch.bfloat16, dev), b, h, w, c,
                                  e, heads, n, ln_bias)
    launches = -(-n // LV.MAX_RUN)
    before = LV.fused_channel_gffw_run.launches
    wg_before = LV.fused_channel_gffw_run.launches_wg
    got = LV.fused_channel_gffw_run(x, blocks, heads)
    torch.cuda.synchronize()
    assert LV.fused_channel_gffw_run.launches == before + launches
    assert LV.fused_channel_gffw_run.launches_wg == wg_before + launches
    assert got.shape == x.shape and bool(torch.isfinite(got.float()).all())
    want = LV.channel_gffw_run_plain(x, blocks, heads)
    assert max_err(got, want) <= KERNEL_TOL[torch.bfloat16] * n
    split = LV.channel_gffw_run_split(x, blocks, heads)
    assert _rel(got, split) <= 2.0 ** -7
    again = LV.fused_channel_gffw_run(x, blocks, heads)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def test_level_wg_smem_mirror_matches_the_source(dev):
    from turtlevsr_tpu_torch.kernels import build

    for c in LV._LV_WG_WIDTHS:
        assert build.load("level_wg").turtle_level_wg_smem(c) == LV._lv_smem(
            c)[0]


# sha256 of the outputs of qkv_wg.cu, chm_wg.cu and ffn_wg.cu (their bf16
# and fp32 bits) on card cases, as the bodies gave them before their device
# code moved into functions of (item, ring) for level_wg.cu (stats_wg.cuh,
# ffn_wg.cuh; NVIDIA H100 80GB HBM3): the move changed no bit
SW_BITS_MAPS = {"ragged": (2, 37, 53), "split": (3, 99, 101)}
WG_BITS = {
    "qkv_wg:64_ragged":
        "8f667ff13fbdf033ccf7d731e8af166ff0d93c2643d8e0be48dfda62bb24f578",
    "qkv_wg:64_split":
        "6ed20d134bd7a762678b055ac49bb4ee493c200cc89c1076dd020b402748b5e8",
    "qkv_wg:128_ragged":
        "f1654fa81a9dcbe8a0d10d2be14b78610afc4e05e2bb20e9621c17f7873ea1ea",
    "qkv_wg:128_split":
        "8ada681d8003cde25b113eec6d4dc94e71d59872284bc77007046d59cafd597f",
    "qkv_wg:256_ragged":
        "771ed98904c54ee296b5a4efff29c1308d042cb7c3bf27d345dcd1398222d37f",
    "qkv_wg:256_split":
        "78d67a8c80784828cf8ebcb7e741266ac0db9422dd69a735cb2d53cad5e55197",
    "qkv_wg:512_ragged":
        "013398d230bfcfbae8f227de7a1dd6c6070429b3b0a592d0f0861af326aa8153",
    "qkv_wg:512_split":
        "4025eed5ebc3caf63344e819250290b9ec34a713609a91c27b6c3e1d7d7dcc12",
    "chm_wg:64_ragged":
        "2325f0a4812100b6b373e20b1574a4a860448863217cc70caed2bd79c80bef58",
    "chm_wg:64_split":
        "eb758d4b5a5a308c13e55156abcb94a44261d9c287c223f9ad03ad471b9af653",
    "chm_wg:128_ragged":
        "f0a4ca987e9a6c75dc3d5cf1884e0098e6d8fde3790d7e8c8f63fa20f7dd3783",
    "chm_wg:128_split":
        "5b832dc7e8c8313ef6e34125747300cd3e53b3a54e4ab3a5aa722cabe23f04d8",
    "chm_wg:256_ragged":
        "d4de1b729e79ab3b464dad18aac61b1cfd14086a794872830d715e6cdce9fe75",
    "chm_wg:256_split":
        "25bce8b6a07fe684aa422707c13b3add6d0e778495f15d8bb91e4854b990ab0b",
    "ffn_wg:gate_pair_po_batched_c128":
        "a4f6f14d7ef0b11b2ded59d874d269027960231d8fbd21dd592cbae377d76833",
    "ffn_wg:gate_pair_po_batched_c256":
        "fb265614d38dc9d00e9d672d5128c851d4142eebe8b89888e1d23f4948725812",
    "ffn_wg:gate_pair_po_batched_c512":
        "36e7db2968e4108f9f59a97cda7daf442fb669c84320e22c8e37d5a65b5e8fef",
    "ffn_wg:gate_pair_no_po_c512":
        "89cbb8be703eb1794f3a37b04b115d91b209135d351cab1a886b792b6f91e787",
    "ffn_wg:gate_pair_po_shared_c256":
        "0dc55650eed927119845c31442a7b93948b5b8612ce69bf4f99b5f8c54ff663f",
    "ffn_wg:gelu_scale_c128":
        "9d6c03668c4ac35f630dcf9500beb458fe46b7e6413a82948e433b5e951e5073",
    "ffn_wg:gelu_scale_ffw2_c128":
        "79434d1ff7d1391ef9ef6f0b9cb2db6a9b9f1da8c260e8e3e67d7d32d1edde90",
    "ffn_wg:gelu_scale_ffw2_biasfree_ln_c128":
        "9e523233ea29d2ac3d24c0b9e7086203596424a0026345a623d803de45364d09",
    "ffn_wg:lists_stack4_single_c256_ragged":
        "de5b6dedb65a543b77b951b3c38491cd0e5a7de604606bb6e2a49e298440fffc",
    "ffn_wg:lists_stack4_single_c128_ragged":
        "2f9a85a26110a44a0597706221fa4d96e8ad84aebf9ffadece7dec4c8dcbb2a2",
    "ffn_wg:lists_stack4_single_c256_15_tiles":
        "b5d13503c0675a410de8afc1c5b6feb0f97828a44e36eabcfaa3597fd9d090aa",
    "ffn_wg:lists_stack4_single_c128_15_tiles":
        "09e653f938e17b1877e7980d6c6f0caf1e5973749d6b4384f148de4efc20a17b",
    "ffn_wg:lists_five_singles_po_b_c128":
        "9a731f0f26064af15118c06b4266bccce42deeaba2019addde199d0e45c873c6",
    "ffn_wg:lists_stack2_two_singles_shared_c256":
        "095f2d85256c4456f969f031851f1583d215b9fb94254e314a3651de0640e6c1",
}


def _wg_outputs(case, dev):
    kind, rest = case.split(":")
    if kind in ("qkv_wg", "chm_wg"):
        c, maps = rest.split("_")
        c = int(c)
        b, h, w = SW_BITS_MAPS[maps]
        if kind == "qkv_wg":
            x, kw = chain_kernel_case(Maker(16, torch.bfloat16, dev), b, h, w,
                                      c, 3 * c, False)
            n = K.fused_qkv_stats.launches_wg
            got = K.fused_qkv_stats(x, heads=c // 64, **kw)
            assert K.fused_qkv_stats.launches_wg == n + 1
        else:
            x, x_sp, kw = chm_kernel_case(Maker(17, torch.bfloat16, dev), b,
                                          h, w, c, c // 64,
                                          3 if c == 64 else 4, True)
            n = K.fused_chm_stats.launches_wg
            got = K.fused_chm_stats(x, x_sp, **kw)
            assert K.fused_chm_stats.launches_wg == n + 1
        return list(got)
    m = Maker(15, torch.bfloat16, dev)
    if rest in FFN_WG_LIST_CASES:
        x, kw = ffn_list_case(rest, m, FFN_WG_LIST_CASES)
    else:
        x, kw = ffn_kernel_case(rest, m, FFN_WG_CASES)
    n = K.fused_block_ffn.launches_wg
    got = K.fused_block_ffn(x, **kw)
    assert K.fused_block_ffn.launches_wg == n + 1
    return [got]


@pytest.mark.parametrize("case", list(WG_BITS))
def test_wgmma_bodies_bits_unchanged_by_the_factoring(dev, case):
    import hashlib

    got = _wg_outputs(case, dev)
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in got:
        t = t.contiguous()
        h.update(t.view(torch.int16 if t.element_size() == 2 else torch.int32)
                 .cpu().numpy().tobytes())
    assert h.hexdigest() == WG_BITS[case]


def test_attn_v_float32_at_the_whole_frame_scores(dev):
    """Row 11 in float32 (the mma.sync body's float tile: 128 columns of D,
    3 stages) at dec3's whole-frame shape of a padded 720p frame: 4 entries
    of 3680 window tokens (46 x 80) against 4096 columns, the ring positions
    as views of one buffer; the merge against its plain version."""
    a, vs = attn_v_kernel_case(Maker(27, torch.float32, dev), 1, 4, 46, 80,
                               4, 256, True)
    before = S.sab_attn_v_merge.launches
    got = S.sab_attn_v_merge(a, vs, 4, 184, 320)
    torch.cuda.synchronize()
    assert S.sab_attn_v_merge.launches == before + 1
    assert got.shape == (4, 184, 320, 256)
    assert max_err(got, S.attn_v_merge_plain(a, vs, 4, 184, 320)) <= 1e-5


# row 13 in float32 on csrc/chain2.cu at the conv-only levels' forms: enc1's
# pair at C = 64, enc2's at C = 128 and the refinement's ReducedAttn+GFFW
# block, maps of several rows of tiles whose sides the 8 x 8 tiles do not
# divide (fields of TWO_STAGE_KERNEL_CASES)
TWO_STAGE_F32_CASES = {
    "enc1_pair_c64": (1, 45, 83, 64, 128, 128, "pair", False, True),
    "enc2_pair_c128": (2, 23, 41, 128, 256, 256, "pair", False, True),
    "refinement_ra_gffw_c64": (1, 45, 83, 64, 128, 160, "ra_gffw", False,
                               True),
}


@pytest.mark.parametrize("case", list(TWO_STAGE_F32_CASES))
def test_two_stage_float32_at_the_paths_widths(dev, case):
    """Row 13 in float32 at C = 64 and 128: one launch of chain2.cu, none of
    the Hopper bodies (bf16 only), against its plain version and the split
    route it replaces."""
    x, st1, st2, ffw1, ffw2 = two_stage_kernel_case(
        case, Maker(28, torch.float32, dev), TWO_STAGE_F32_CASES)
    before = C2.fused_two_stage.launches
    wg_before = C2.fused_two_stage.launches_wg
    got = C2.fused_two_stage(x, st1, st2, ffw1=ffw1, ffw2=ffw2)
    torch.cuda.synchronize()
    assert C2.fused_two_stage.launches == before + 1
    assert C2.fused_two_stage.launches_wg == wg_before
    want = C2.two_stage_plain(x, st1, st2, ffw1=ffw1, ffw2=ffw2)
    assert max_err(got, want) <= 2 * KERNEL_TOL[torch.float32]
    y = K.fused_block_ffn(x, ffw2=ffw1, **st1)
    split = K.fused_block_ffn(y, ffw2=ffw2, **st2)
    assert max_err(got, split) <= KERNEL_TOL[torch.float32]


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


@pytest.mark.parametrize("case", list(TWO_STAGE_WG_CASES))
def test_two_stage_wg_body_matches_plain_and_split(dev, case):
    """Row 13's Hopper bodies (csrc/chain2_wg.cu) on the forms their plan
    gives them, at ragged and small maps, batches and grids that walk several
    tiles a block: one launch on the new body, within the tolerance of the
    plain version and of the split route (two launches of row 1's Hopper
    bodies, whose steps each pixel repeats), bitwise repeatable."""
    x, st1, st2, ffw1, ffw2 = two_stage_kernel_case(
        case, Maker(21, torch.bfloat16, dev), TWO_STAGE_WG_CASES)
    before = C2.fused_two_stage.launches
    wg_before = C2.fused_two_stage.launches_wg
    got = C2.fused_two_stage(x, st1, st2, ffw1=ffw1, ffw2=ffw2)
    torch.cuda.synchronize()
    assert C2.fused_two_stage.launches == before + 1
    assert C2.fused_two_stage.launches_wg == wg_before + 1
    assert torch.isfinite(got.float()).all()
    want = C2.two_stage_plain(x, st1, st2, ffw1=ffw1, ffw2=ffw2)
    assert max_err(got, want) <= 2 * KERNEL_TOL[torch.bfloat16]
    y = K.fused_block_ffn(x, ffw2=ffw1, **st1)
    split = K.fused_block_ffn(y, ffw2=ffw2, **st2)
    assert max_err(got, split) <= KERNEL_TOL[torch.bfloat16]
    again = C2.fused_two_stage(x, st1, st2, ffw1=ffw1, ffw2=ffw2)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def test_two_stage_wg_smem_mirror_matches_the_source(dev):
    from turtlevsr_tpu_torch.kernels import build

    lib = build.load("chain2_wg")
    for form1, form2 in ((("gelu", 128, 128), ("gelu", 128, 128)),
                         (("gelu", 128, 0), ("gate", 160, 0)),
                         (("gelu", 64, 128), ("gelu", 192, 128))):
        ints = []
        for mode, e, f in (form1, form2):
            ints += [2 * e if mode == "gate" else e, e, f]
        assert lib.turtle_two_stage_wg_smem(64, *ints) == C2._k64_smem(
            form1, form2)
    assert lib.turtle_two_stage_wg_smem(128, 256, 256, 256, 256, 256,
                                        256) == C2._k128_smem()[0]


# (BN, Q, K, hq, wq, exact): the streaming body's shapes: entries that its
# blocks of 4 do not divide, a whole frame's key count, many entries, the
# least K it takes
SPARSE_WG_SHAPES = [(5, 23, 400, 20, 20, False), (3, 12, 3680, 46, 80, True),
                    (60, 8, 400, 20, 20, True), (2, 8, 8, 2, 4, False)]


@pytest.mark.parametrize("shape", SPARSE_WG_SHAPES)
def test_sparse_wg_body_matches_plain_and_sab_cu(dev, shape, monkeypatch):
    """Row 12's streaming body (csrc/sparse_wg.cu): one launch on it, the
    plain version's support and values within one bf16 rounding, and
    sab.cu's body bit for bit (the same floats in the same order)."""
    s, mask = sparse_kernel_case(Maker(22, torch.bfloat16, dev), *shape)
    before = S.sab_sparse_softmax.launches
    wg_before = S.sab_sparse_softmax.launches_wg
    got = S.sab_sparse_softmax(s, mask)
    torch.cuda.synchronize()
    assert S.sab_sparse_softmax.launches == before + 1
    assert S.sab_sparse_softmax.launches_wg == wg_before + 1
    want = S.sparse_softmax_plain(s, mask)
    assert torch.equal(got != 0, want != 0)
    assert max_err(got, want) <= 2.0 ** -7
    monkeypatch.setattr(S, "_sparse_plan", lambda *a, **kw: ("tile", None))
    old = S.sab_sparse_softmax(s, mask)
    torch.cuda.synchronize()
    assert S.sab_sparse_softmax.launches_wg == wg_before + 1
    assert torch.equal(got, old)


def test_sparse_wg_smem_mirror_matches_the_source(dev):
    from turtlevsr_tpu_torch.kernels import build

    lib = build.load("sparse_wg")
    for k in (8, 400, 3680, 9600):
        assert lib.turtle_sparse_wg_smem(k) == S._spw_smem(k)


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


# ---------------------------------------------------------------------------
# training: each kernel's Function (kernels/vjp.py) on the card, the lattice
# pair's backward kernels, one train step against the CPU's
# ---------------------------------------------------------------------------


def _vjp_case(name, m):
    """(dispatcher, launch counter's wrapper, plain version, args, kwargs)
    of one Function at a small or ragged shape the kernels take."""
    if name.startswith("ffn_"):
        x, kw = ffn_kernel_case(name[4:], m)
        return V.fused_block_ffn, K.fused_block_ffn, K.ffn_plain, (x,), kw
    if name == "qkv_stats":
        x, kw = chain_kernel_case(m, 2, 11, 13, 16, 48, True)
        return (V.fused_qkv_stats, K.fused_qkv_stats, K.qkv_stats_plain,
                (x,), dict(kw, heads=2))
    if name == "split_proj":
        x, kw = chain_kernel_case(m, 2, 11, 13, 16, 48, True)
        return (V.fused_ln_split_proj, K.fused_ln_split_proj,
                K.split_proj_plain, (x,), dict(kw, n_out=3))
    if name.startswith("conv3x3"):
        x = m(2, 11, 13, 16)
        kw = (dict(ln_w=1.0 + m(16, scale=0.2), ln_b=m(16, scale=0.2))
              if name.endswith("_ln") else {})
        return (V.fused_conv3x3, K.fused_conv3x3, K.conv3x3_plain,
                (x, m(3, 3, 16, 24, scale=0.1), m(24)), kw)
    if name == "chm_stats":
        x, x_sp, kw = chm_kernel_case(m, 2, 11, 13, 16, 2, 2, True)
        return (V.fused_chm_stats, K.fused_chm_stats, K.chm_stats_plain,
                (x, x_sp), kw)
    if name == "sab_probs":
        q, k, temp, fvalid = sab_kernel_case(m, *SAB_KERNEL_SHAPES[1],
                                             exact=False)
        return (V.sab_attn_probs, S.sab_attn_probs, S.sab_attn_probs_plain,
                (q, k, temp.to(m.dtype), fvalid),
                dict(grid_wq=SAB_KERNEL_SHAPES[1][3]))
    if name == "attn_v_merge":
        b, nf, hh, ww, ws, c, ring = ATTN_V_KERNEL_SHAPES[1]
        a, vs = attn_v_kernel_case(m, b, nf, hh, ww, ws, c, ring)
        return (V.sab_attn_v_merge, S.sab_attn_v_merge, S.attn_v_merge_plain,
                (a, vs, ws, hh * ws, ww * ws), {})
    if name == "sparse_softmax":
        scores, mask = sparse_kernel_case(m, *SPARSE_KERNEL_SHAPES[0])
        return (V.sab_sparse_softmax, S.sab_sparse_softmax,
                S.sparse_softmax_plain, (scores, mask.bool()), {})
    if name.startswith("two_stage_"):
        x, st1, st2, ffw1, ffw2 = two_stage_kernel_case(name[10:], m)
        return (V.fused_two_stage, C2.fused_two_stage, C2.two_stage_plain,
                (x, st1, st2), dict(ffw1=ffw1, ffw2=ffw2))
    x, blocks = level_kernel_case(m, *LEVEL_KERNEL_SHAPES[0])
    return (V.fused_channel_gffw_run, LV.fused_channel_gffw_run,
            LV.channel_gffw_run_plain, (x, blocks, LEVEL_KERNEL_SHAPES[0][5]),
            {})


VJP_CASES = ["ffn_gate_pair_po_batched", "ffn_gelu_ffw2", "ffn_gelu_no_dw",
             "qkv_stats", "split_proj", "conv3x3", "conv3x3_ln", "chm_stats",
             "sab_probs", "attn_v_merge", "sparse_softmax",
             "two_stage_pair_c16", "two_stage_ra_gffw_c64", "channel_run"]


def _outs(o):
    return o if isinstance(o, tuple) else (o,)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("name", VJP_CASES)
def test_function_forward_and_backward_on_the_card(dev, name, dtype):
    """Forward: the Function launches its kernel once (the wrapper's
    counter), within the kernel tolerance of the plain version. Backward:
    autograd through the plain version on the card, the gradient that
    autograd gives straight through the plain version on the same
    inputs."""
    fn, wrapper, plain, args, kw = _vjp_case(name, Maker(21, dtype, dev))
    leaves = []
    spec = V._flatten((args, kw), leaves)

    def fresh():
        ls = [a.detach().clone().requires_grad_(a.is_floating_point())
              for a in leaves]
        return ls, V._unflatten(spec, ls)

    ls, (a, k) = fresh()
    before = wrapper.launches
    outs = _outs(fn(*a, **k))
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert type(outs[0].grad_fn).__name__.endswith("Backward")
    with torch.no_grad():
        want = _outs(plain(*a, **k))
    for got, ref in zip(outs, want):
        scale = max(1.0, ref.float().abs().max().item())
        assert max_err(got, ref) <= KERNEL_TOL[dtype] * scale
    gen = torch.Generator(device=dev).manual_seed(3)
    cts = [torch.randn(o.shape, device=dev, generator=gen).to(o.dtype)
           for o in outs]
    wanted = [x for x in ls if x.requires_grad]
    got = torch.autograd.grad(outs, wanted, cts, allow_unused=True)
    ls2, (a2, k2) = fresh()
    ref = torch.autograd.grad(_outs(plain(*a2, **k2)),
                              [x for x in ls2 if x.requires_grad], cts,
                              allow_unused=True)
    assert wrapper.launches == before + 1  # the backward launches nothing
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            scale = max(1e-6, r.float().abs().max().item())
            tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
            assert max_err(g, r) <= tol * scale


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_lattice_backward_launches_the_other_kernel(dev, dtype):
    m = Maker(22, dtype, dev)
    x = m(2, 8, 12, 16).requires_grad_()
    s0, m0 = L.lattice_split.launches, L.lattice_merge.launches
    tok = V.lattice_split(x, 2)
    ct = m(*tok.shape)
    (g,) = torch.autograd.grad(tok, x, ct)
    torch.cuda.synchronize()
    assert (L.lattice_split.launches, L.lattice_merge.launches) == (s0 + 1,
                                                                    m0 + 1)
    assert torch.equal(g, L.lattice_merge_plain(ct, 2, 8, 12))
    t_ = m(2, 24, 64).requires_grad_()
    mp = V.lattice_merge(t_, 2, 8, 12)
    (g,) = torch.autograd.grad(mp, t_, x.detach())
    torch.cuda.synchronize()
    assert (L.lattice_split.launches, L.lattice_merge.launches) == (s0 + 2,
                                                                    m0 + 2)
    assert torch.equal(g, L.lattice_split_plain(x.detach(), 2))


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One make_train_step step of a tiny t1 model (CHM blocks; dim 16, the
    narrowest width the kernels take) in float32, on the card with the
    kernels forward and on the CPU with the plain versions: the same loss
    and gradients within float32 sums in another order."""
    from turtlevsr_tpu_torch import kernels as KP
    from turtlevsr_tpu_torch.models import build_model
    from turtlevsr_tpu_torch.train import (
        TrainState,
        build_schedule,
        make_optimizer,
        make_train_step,
    )

    train_opt = {"optim_g": {"lr": 4e-4, "weight_decay": 0,
                             "betas": [0.9, 0.99]},
                 "scheduler": {"type": "TrueCosineAnnealingLR",
                               "T_max": 1000, "eta_min": 1e-7},
                 "total_iter": 1000, "warmup_iter": -1}
    model = build_model(tiny_opt(dim=16), device="cpu",
                        generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("gamma", "beta"):
                p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    tx = make_optimizer(train_opt, build_schedule(train_opt))
    lq = torch.rand(1, 3, 32, 32, 3, generator=gen)
    gt = torch.rand(1, 3, 32, 32, 3, generator=gen)
    states = {}
    for device in ("cuda", "cpu"):
        step = make_train_step(model.cfg, tx, compute_dtype=torch.float32,
                               device=device)
        state = TrainState.create(dict(model.named_parameters()), tx,
                                   device=device)
        KP.reset_launch_counts()
        state, logs = step(state, lq.to(device), gt.to(device))
        states[device] = (state, float(logs["l_pix"]),
                          KP.launch_counts())
    (sg, lg, counts), (sc, lc, _) = states["cuda"], states["cpu"]
    for name in ("ffn", "qkv_stats", "split_proj", "conv3x3", "chm_stats",
                 "sab", "lattice_split", "lattice_merge"):
        assert counts[name] > 0, name
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    num = sum(float((sg.params[n].grad.cpu() - p.grad).square().sum())
              for n, p in sc.params.items())
    den = sum(float(p.grad.square().sum()) for p in sc.params.values())
    assert (num / den) ** 0.5 <= 1e-4
    assert sg.step == sc.step == 1


def test_train_cli_on_the_card_matches_the_cpu(dev, tmp_path):
    """Two iterations of turtlevsr_tpu_torch.cli.train.main on the tiny
    option file (dim 16, the narrowest width the kernels take; pretrained
    weights drawn from a seed), its train step in float32, on the card with
    the kernels forward and on the CPU with the plain versions: the same
    losses, and the same AdamW first moments (a sum of the two steps'
    gradients) at the tolerance of
    test_train_step_on_the_card_matches_the_cpu; the validation PSNR (bf16
    in both, the serving wrappers on the card) within 0.05 dB."""
    import os

    from test_torch_port_train_cli import TINY_YML, _seeded_weights, \
        _write_frames
    from turtlevsr_tpu_torch import kernels as KP
    from turtlevsr_tpu_torch.cli import train as TC
    from turtlevsr_tpu_torch.config.options import load_options
    from turtlevsr_tpu_torch.models import build_model

    data = str(tmp_path / "data")
    _write_frames(data)
    pth = str(tmp_path / "pretrain.pth")
    yml = str(tmp_path / "tiny.yml")
    with open(yml, "w") as f:
        f.write(TINY_YML.format(root=data).replace(
            "name: tiny_debug_cli", "name: tiny_cli").replace(
            "dim: 8", "dim: 16").replace("val_freq: 8", "val_freq: 2")
            + f"path:\n  pretrain_network_g: {pth}\n")
    model = build_model(load_options(yml), device="cpu")
    _seeded_weights(model, 11)
    torch.save({"params": model.state_dict()}, pth)
    orig = TC.make_train_step
    runs = {}
    old = os.getcwd()
    try:
        for device in ("cuda", "cpu"):
            os.makedirs(tmp_path / device)
            os.chdir(tmp_path / device)
            KP.reset_launch_counts()
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(TC, "make_train_step", lambda cfg, tx, **kw: orig(
                    cfg, tx, **{**kw, "compute_dtype": torch.float32}))
                res = TC.main(["-opt", yml, "--device", device,
                               "--max_iters", "2"])
            state = torch.load(os.path.join(
                "experiments", "tiny_cli", "training_states", "2.state"),
                weights_only=True)["optimizers"][0]["state"]
            runs[device] = (res, state, KP.launch_counts())
    finally:
        os.chdir(old)
    (rg, sg, counts), (rc, sc, _) = runs["cuda"], runs["cpu"]
    for name in ("ffn", "qkv_stats", "split_proj", "conv3x3", "chm_stats",
                 "sab", "lattice_split", "lattice_merge"):
        assert counts[name] > 0, name
    for a, b in zip(rg["logs"], rc["logs"]):
        assert abs(a["l_pix"] - b["l_pix"]) <= 1e-5 * abs(b["l_pix"])
    num = sum(float((sg[i]["exp_avg"] - s["exp_avg"]).square().sum())
              for i, s in sc.items())
    den = sum(float(s["exp_avg"].square().sum()) for s in sc.values())
    assert (num / den) ** 0.5 <= 1e-4
    assert abs(rg["val"][2]["psnr"] - rc["val"][2]["psnr"]) <= 0.05


def test_two_gloo_ranks_on_the_card_equal_one_process(dev, tmp_path):
    """Two ranks of make_train_step(group=...) over gloo on this card
    (tests/torch_port_dist_worker.py: the tiny t1 model at dim 16, bf16
    from float32 masters, the kernels forward), each on one clip of a
    batch of two, against one process's step on the whole batch: the
    ranks' masters bit for bit; the first step's loss (the group's mean)
    and averaged gradients held to the one process's float32 step as the
    train phase of chip_smoke.py holds a bf16 route (its relative L2 error
    at most 1.5 times that of the one process's bf16 step, plus 1e-3: each
    clip's bf16 gradient is rounded on its own there, the batch's once
    here)."""
    import os
    import subprocess
    import sys

    from torch_port_dist_worker import batches, make_step, run_steps, \
        seeded_model
    from turtlevsr_tpu_torch.kernels import build

    build.build_all()  # the ranks load the libraries, none builds them
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(here), here, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_port_dist_worker.py"),
         "step", str(tmp_path / f"rank{r}.pt"), str(tmp_path / "rendezvous"),
         str(r), "2", "cuda", "bfloat16"], env=env, cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        one = {}
        for dtype in ("bfloat16", "float32"):
            step, state = make_step(seeded_model(dim=16), "cuda", dtype)
            one[dtype] = run_steps(step, state, batches()[:1], "cuda")[:2]
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    a, b = (torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
            for r in range(2))
    assert a["losses"] == b["losses"]
    assert all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"])

    def rel(got, want):
        num = sum(float((got[n].float() - w.float()).square().sum())
                  for n, w in want.items())
        return (num / sum(float(w.float().square().sum())
                          for w in want.values())) ** 0.5

    (l_one, g_one), (l_ref, g_ref) = one["bfloat16"], one["float32"]
    assert rel(a["grads"], g_ref) <= 1.5 * rel(g_one, g_ref) + 1e-3
    assert abs(a["losses"][0] - l_ref[0]) <= (
        1.5 * abs(l_one[0] - l_ref[0]) + 1e-3 * abs(l_ref[0]))
