"""Row 2's body (the conv-FFN chain without a depthwise stage,
kernels/csrc/ffn_pw.cu) and row 4's C = 64 body (kernels/csrc/split_c64.cu)
on the CPU: their plans, the Python mirrors of their shared memory, and the
plain versions against the JAX package at the cases the card tests hold the
kernels to (tests/test_torch_port_cuda.py, ``-k "ffn_pw or split_c64"``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import Maker, chain_kernel_case, close, ffn_kernel_case
from turtlevsr_tpu.kernels import ffn as jffn
from turtlevsr_tpu.kernels import vjp as jvjp
from turtlevsr_tpu_torch.kernels import ffn as K

torch.set_num_threads(1)
ATOL64 = 1e-9  # float64 against the plain twin: sums in another order
# float32 against the Pallas kernel in interpret mode (the bar of
# tests/test_torch_port_kernels.py)
ATOL32 = 3e-5
SMEM_LIMIT = 232448

# The calls the body without a depthwise stage takes (kernels/csrc/ffn_pw.cu:
# bf16, gelu, F = E = 2C, C = 128 or 256, no x2 map or one with its po):
# gopro_enc3_ffw's FFW pass at enc3 (a map with a per-batch po) on
# ragged maps of two entries whose pixel counts its 128-pixel tiles do not
# divide, with po_b; a shared po on a map smaller than a tile with a
# bias-free LN; no map on exactly one tile; enc3 of a whole padded frame
# (the path's form) and of 15 tiles; C = 128. tile_*: just outside its
# forms (C = 64, gate, E = 3C, a map without po), on ffn.cu. Same fields as
# FFN_KERNEL_CASES; every name ends in _no_dw.
FFN_PW_CASES = {
    "pair_po_batched_enc3_path_c256_no_dw": (1, 184, 320, 256, 512, "gelu",
                                             True, "batched", False, True,
                                             False, True),
    "pair_po_batched_c256_no_dw": (2, 37, 53, 256, 512, "gelu", True,
                                   "batched", True, True, False, True),
    "pair_po_shared_biasfree_ln_small_c256_no_dw": (
        1, 9, 7, 256, 512, "gelu", True, "shared", False, True, False, False),
    "tile_pair_no_po_c256_no_dw": (2, 37, 53, 256, 512, "gelu", True, None,
                                   True, False, False, True),
    "no_pair_one_tile_c256_no_dw": (1, 16, 8, 256, 512, "gelu", False, None,
                                    True, True, False, True),
    "pair_po_batched_15_tiles_c256_no_dw": (15, 80, 80, 256, 512, "gelu",
                                            True, "batched", False, True,
                                            False, True),
    "pair_po_batched_c128_no_dw": (2, 37, 53, 128, 256, "gelu", True,
                                   "batched", True, True, False, True),
    "no_pair_biasfree_ln_c128_no_dw": (2, 21, 19, 128, 256, "gelu", False,
                                       None, False, True, False, False),
    "tile_pair_po_batched_c64_no_dw": (2, 37, 53, 64, 128, "gelu", True,
                                       "batched", True, True, False, True),
    "tile_gate_pair_po_c256_no_dw": (2, 37, 53, 256, 256, "gate", True,
                                     "batched", True, False, False, True),
    "tile_e768_c256_no_dw": (1, 19, 21, 256, 768, "gelu", True, "batched",
                             True, True, False, True),
}
# The calls the split projection's C = 64 body takes (kernels/csrc/
# split_c64.cu: bf16, LayerNorm, no biases, E = C = 64, 1-4 chains):
# (B, H, W, n_out, ln_bias) on ragged maps of two entries whose sides its 16
# x 8 tiles do not divide, a map smaller than a tile, exactly one tile, 15
# tiles of dec1 (at 40 x 40), dec1 of a whole padded frame (the path's form)
SPLIT_C64_CASES = {
    "n2_dec1_path": (1, 736, 1280, 2, True),
    **{f"n{n}_{'ln_b' if lnb else 'biasfree_ln'}_ragged": (2, 37, 53, n, lnb)
       for n in (1, 2, 3, 4) for lnb in (True, False)},
    "n2_small": (1, 9, 7, 2, True),
    "n3_one_tile": (1, 16, 8, 3, False),
    "n2_15_tiles": (15, 40, 40, 2, True),
}

# ---------------------------------------------------------------------------
# row 2: csrc/ffn_pw.cu
# ---------------------------------------------------------------------------


def _pw_args(case):
    b, h, w, c, e, mode, pair, po, _, _, ffw2, _ = FFN_PW_CASES[case]
    ch = 2 * e if mode == "gate" else e
    return (b, h, w, c, ch, e, mode, int(pair), bool(po), po == "batched",
            2 * c if ffw2 else 0, False, torch.bfloat16)


@pytest.mark.parametrize("case", list(FFN_PW_CASES))
def test_pw_plan_of_the_card_cases(case):
    """The card cases' bodies: pw, with its geometry (tiles of 128 pixels of
    an entry, one block an SM at most), but for tile_*, which stay on
    ffn.cu."""
    args = _pw_args(case)
    body, geo = K._ffn_plan(*args)
    if case.startswith("tile_"):
        assert (body, geo) == ("tile", None)
        return
    b, h, w, c = args[:4]
    assert body == "pw"
    assert geo["tiles"] == b * (-(-(h * w) // 128))
    assert geo["blocks"] == min(geo["tiles"], 132)
    assert (geo["smem"], geo["stages"]) == K._pw_smem(c)
    assert geo["chunk"] == 64


@pytest.mark.parametrize("c,stages", [(128, 8), (256, 6)])
def test_pw_shared_memory_fits_a_block(c, stages):
    """The source's arithmetic (pw_smem of ffn_pw.cu; a card test holds the
    two equal): the x and x2 tiles, four mbarriers, and as many 16 KB ring
    stages, each with its two mbarriers, as fit (8 at most)."""
    smem, got = K._pw_smem(c)
    assert got == stages
    assert smem == 1024 + 2 * 128 * c * 2 + stages * (16384 + 16) + 32
    assert smem <= SMEM_LIMIT
    assert smem + 16384 + 16 > SMEM_LIMIT or stages == 8


# the path's form (gopro_enc3_ffw's FFW pass at enc3) and the changes that
# leave the body's forms
PW_PATH = dict(b=1, h=184, w=320, c=256, ch=512, e=512, mode="gelu", n_x2=1,
               has_po=True, po_batched=True, f=0, has_dw=False,
               dtype=torch.bfloat16)


@pytest.mark.parametrize("change", ["float32", "c64", "c512", "gate",
                                    "e_is_c", "two_maps", "no_po", "ffw2",
                                    "dw"])
def test_pw_plan_keeps_the_other_calls_off_the_pw_body(change):
    assert K._ffn_plan(**PW_PATH)[0] == "pw"
    args = dict(PW_PATH, **{
        "float32": dict(dtype=torch.float32),
        "c64": dict(c=64, ch=128, e=128),
        "c512": dict(c=512, ch=1024, e=1024),
        "gate": dict(mode="gate", ch=1024),
        "e_is_c": dict(ch=256, e=256),
        "two_maps": dict(n_x2=2),
        "no_po": dict(has_po=False, po_batched=False),
        "ffw2": dict(f=512),
        "dw": dict(has_dw=True)}[change])
    assert K._ffn_plan(**args)[0] != "pw"


def _np64(tree):
    """Tensors (and dicts of them) as float64 numpy arrays; None dropped."""
    return {k: (_np64(v) if isinstance(v, dict) else v.double().numpy())
            for k, v in tree.items()
            if torch.is_tensor(v) or isinstance(v, dict)}


def _cpu_sized(cases):
    """The cases but the path's and 15 tiles' forms: the same arithmetic on
    more pixels, left to the card."""
    return [c for c in cases if "_path" not in c and "15_tiles" not in c]


@pytest.mark.parametrize("case", _cpu_sized(FFN_PW_CASES))
def test_pw_plain_matches_twin_float64_at_the_card_cases(case):
    """The plain version the card tests hold the body to, against the JAX
    package's plain twin (kernels/vjp.py, no depthwise stage) in float64 on
    the same inputs; x' formed in numpy as the twin takes it."""
    x, kw = ffn_kernel_case(case, Maker(20, torch.float64), FFN_PW_CASES)
    assert kw["wd"] is None
    got = K.fused_block_ffn(x, **kw)
    p, jx = _np64(kw), x.numpy()
    if "x2" in p:
        add = p["x2"]
        if "po_w" in p:
            eq = "bhwc,bce->bhwe" if p["po_w"].ndim == 3 else "bhwc,ce->bhwe"
            add = np.einsum(eq, p["x2"], p["po_w"]) + p.get("po_b", 0.0)
        jx = jx + add
        p = {k: v for k, v in p.items() if k not in ("x2", "po_w", "po_b")}
    want = jvjp._ffn_xla(jnp.asarray(jx),
                         {k: jnp.asarray(v) for k, v in p.items()},
                         kw["mode"], True,
                         "with_bias" if "ln_b" in p else "bias_free")
    close(got, want, ATOL64)


@pytest.mark.parametrize("c", [128, 256])
def test_pw_plain_matches_pallas_interpret_float32(c):
    """The path's form without its x2 map (the Pallas kernel's no-dw branch
    takes none) against the JAX kernel in interpret mode: gelu, F = 2C, b1,
    b2 and the scale, on a 3 x 16 map."""
    m = Maker(22, torch.float32)
    f = 2 * c
    x = m(1, 3, 16, c)
    kw = dict(ln_w=m(c), ln_b=m(c), w1=m(c, f, scale=c ** -0.5), b1=m(f),
              w2=m(f, c, scale=f ** -0.5), b2=m(c), scale=m(c), mode="gelu")
    f32 = lambda a: jnp.asarray(a.numpy(), jnp.float32)  # noqa: E731
    want = jffn.fused_block_ffn(f32(x), interpret=True, **{
        k: f32(v) if torch.is_tensor(v) else v for k, v in kw.items()})
    close(K.fused_block_ffn(x, **kw), np.asarray(want), ATOL32)


# ---------------------------------------------------------------------------
# row 4 at C = 64: csrc/split_c64.cu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(SPLIT_C64_CASES))
def test_split_c64_plan_of_the_card_cases(case):
    b, h, w, n_out, ln_bias = SPLIT_C64_CASES[case]
    body, geo = K._split_plan(b, h, w, 64, 64, n_out, True, False,
                              torch.bfloat16)
    assert body == "c64"
    assert geo["tile"] == (16, 8)
    assert geo["tiles"] == b * K._c64_tiles(h, w)
    assert geo["blocks"] == min(geo["tiles"], 132)
    assert (geo["smem"], geo["stages"]) == K._sc_smem(n_out)


@pytest.mark.parametrize("n_out,slots", [(1, 4), (2, 4), (3, 3), (4, 3)])
def test_split_c64_shared_memory_fits_a_block(n_out, slots):
    """The source's arithmetic (sc_smem of split_c64.cu; a card test holds
    the two equal): the LN halo, w1, two fp32 hidden chunks, wd and as many
    23552-byte ring slots, each with its mbarrier, as fit (4 at most)."""
    smem, got = K._sc_smem(n_out)
    assert got == slots
    rest = 23552 + n_out * 64 * 64 * 2 + 2 * 180 * 64 * 4 + 2 * 9 * 64 * n_out
    assert smem == 1024 + slots * (23552 + 8) + rest
    assert smem <= SMEM_LIMIT
    assert smem + 23552 + 8 > SMEM_LIMIT or slots == 4


# dec1's SAB q, k (15 tiles of 320 and a whole padded frame) and the changes
# that leave the C = 64 body's forms
SPLIT_PATH = dict(b=15, h=320, w=320, c=64, e=64, n_out=2, has_ln=True,
                  has_bias=False, dtype=torch.bfloat16)


@pytest.mark.parametrize("change", ["float32", "biases", "no_ln", "e32"])
def test_split_c64_plan_keeps_the_other_c64_calls_on_the_tile_body(change):
    assert K._split_plan(**SPLIT_PATH)[0] == "c64"
    assert K._split_plan(**dict(SPLIT_PATH, b=1, h=736, w=1280))[1][
        "tiles"] == 46 * 160
    args = dict(SPLIT_PATH, **{"float32": dict(dtype=torch.float32),
                               "biases": dict(has_bias=True),
                               "no_ln": dict(has_ln=False),
                               "e32": dict(e=32, n_out=4)}[change])
    assert K._split_plan(**args) == ("tile", None)


@pytest.mark.parametrize("n_out", [1, 2, 3, 4])
def test_split_c64_plan_takes_one_to_four_chains(n_out):
    body, geo = K._split_plan(**dict(SPLIT_PATH, n_out=n_out))
    assert body == "c64" and geo["tiles"] == 15 * 20 * 40
    assert geo["blocks"] == 132


def _projs(p, n):
    e = p["w1"].shape[1] // n
    return [dict(w1=jnp.asarray(p["w1"][:, i * e:(i + 1) * e]),
                 wd=jnp.asarray(p["wd"][:, :, i * e:(i + 1) * e]))
            for i in range(n)]


@pytest.mark.parametrize("case", _cpu_sized(SPLIT_C64_CASES))
def test_split_c64_plain_matches_twin_at_the_card_cases(case):
    """The plain version the card tests hold the C = 64 body to, against the
    JAX package's plain twin in float64 on the same inputs."""
    b, h, w, n_out, ln_bias = SPLIT_C64_CASES[case]
    x, kw = chain_kernel_case(Maker(21, torch.float64), b, h, w, 64,
                              n_out * 64, False, ln_bias=ln_bias)
    p = {k: v.numpy() for k, v in kw.items() if v is not None}
    jp = {"projs": _projs(p, n_out), "ln_w": jnp.asarray(p["ln_w"])}
    if ln_bias:
        jp["ln_b"] = jnp.asarray(p["ln_b"])
    want = jvjp._split_proj_xla(jnp.asarray(x.numpy()), jp,
                                "with_bias" if ln_bias else "bias_free")
    got = K.fused_ln_split_proj(x, n_out=n_out, **kw)
    assert len(got) == n_out
    for g, w_ in zip(got, want):
        assert g.shape == (b, h, w, 64) and g.is_contiguous()
        close(g, w_, ATOL64)


@pytest.mark.parametrize("n_out", [1, 2, 4])
def test_split_c64_plain_matches_pallas_interpret_float32(n_out):
    """dec1's form (C = E = 64, LN with a bias, no b1 or bd) against the JAX
    kernel in interpret mode on a 9 x 16 map."""
    m = Maker(23, torch.float32)
    x = m(1, 9, 16, 64)
    kw = dict(ln_w=m(64), ln_b=m(64), w1=m(64, 64 * n_out, scale=0.125),
              wd=m(3, 3, 64 * n_out, scale=0.3))
    p = {k: v.numpy() for k, v in kw.items()}
    want = jffn.fused_ln_split_proj(
        jnp.asarray(x.numpy()), _projs(p, n_out), ln_w=jnp.asarray(p["ln_w"]),
        ln_b=jnp.asarray(p["ln_b"]), interpret=True)
    got = K.fused_ln_split_proj(x, n_out=n_out, **kw)
    for g, w_ in zip(got, want):
        close(g, np.asarray(w_), ATOL32)


def test_wrappers_on_the_cpu_run_the_plain_versions_and_launch_nothing():
    x, kw = ffn_kernel_case("pair_po_batched_c256_no_dw",
                            Maker(24, torch.bfloat16), FFN_PW_CASES)
    before = (K.fused_block_ffn.launches, K.fused_block_ffn.launches_pw,
              K.fused_block_ffn.launches_no_dw)
    assert torch.equal(K.fused_block_ffn(x, **kw), K.ffn_plain(x, **kw))
    assert (K.fused_block_ffn.launches, K.fused_block_ffn.launches_pw,
            K.fused_block_ffn.launches_no_dw) == before
    x, kw = chain_kernel_case(Maker(25, torch.bfloat16), 1, 9, 7, 64, 128,
                              False)
    before = (K.fused_ln_split_proj.launches,
              K.fused_ln_split_proj.launches_c64)
    got = K.fused_ln_split_proj(x, n_out=2, **kw)
    want = K.split_proj_plain(x, n_out=2, **kw)
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    assert (K.fused_ln_split_proj.launches,
            K.fused_ln_split_proj.launches_c64) == before
