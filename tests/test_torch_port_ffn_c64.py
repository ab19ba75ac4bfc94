"""The C = 64 body of the conv-FFN kernel (row 1, kernels/csrc/ffn_c64.cu)
on the CPU: the Python mirrors of its geometry (the persistent walk, the
tiles, the shared memory), its plan, and the plain version against the JAX
package at the cases the card tests hold the kernel to
(tests/test_torch_port_cuda.py, ``-k ffn_c64``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (
    FFN_C64_CASES,
    FFN_C64_LIST_CASES,
    Maker,
    close,
    ffn_kernel_case,
    ffn_list_case,
)
from turtlevsr_tpu.kernels import ffn as jffn
from turtlevsr_tpu.kernels import vjp as jvjp
from turtlevsr_tpu_torch.kernels import ffn as K

torch.set_num_threads(1)
ATOL64 = 1e-9  # float64 against the plain twin: sums in another order
# float32 against the Pallas kernel in interpret mode (the bar of
# tests/test_torch_port_kernels.py and tests/test_torch_port_chm.py)
ATOL32 = 3e-5
SMEM_LIMIT = 232448

# (B, tiles a map, blocks): whole 736 x 1280 frames, 15 tiles of 320 x 320,
# grids of fewer items than SMs, ranges that cross entries unevenly
WALKS = [(1, 46 * 160, 132), (15, 20 * 40, 132), (2, 6, 132), (1, 1, 1),
         (3, 7, 5), (4, 33, 132), (15, 16 * 32, 131)]


@pytest.mark.parametrize("b,n_tiles,blocks", WALKS)
def test_walk_gives_each_item_once_in_entry_order(b, n_tiles, blocks):
    """Block g walks a contiguous range of the entry-major (batch entry,
    tile) items; the ranges cover every item once, in order, every block
    gets at least one, and a block meets each entry in one stretch, so that
    a per-batch po is loaded at most once an entry a block."""
    grid = min(b * n_tiles, blocks)
    walk = K._c64_walk(b, n_tiles, grid)
    assert len(walk) == grid
    items = [i for r in walk for i in r]
    assert items == list(range(b * n_tiles))
    assert all(len(r) >= 1 for r in walk)
    for r in walk:
        entries = [i // n_tiles for i in r]
        assert entries == sorted(entries)
        assert len(set(entries)) == entries[-1] - entries[0] + 1


@pytest.mark.parametrize("h,w,tiles", [(320, 320, 20 * 40), (256, 256, 16 * 32),
                                       (736, 1280, 46 * 160),
                                       (731, 1273, 46 * 160), (9, 7, 1),
                                       (37, 53, 3 * 7), (16, 8, 1),
                                       (17, 9, 4)])
def test_tiles_of_16_by_8_cover_the_map(h, w, tiles):
    assert K._c64_tiles(h, w) == tiles
    th, tw = K._C64_TH, K._C64_TW
    assert (-(-h // th) * th >= h) and (-(-w // tw) * tw >= w)


# (CH, E, gate, po matrices, F, ring slots): the refinement's GFFW and
# ReducedAttn halves, dec1's Channel half and its CHM list, enc1's
# ReducedAttn+FFW; five maps leave room for one slot only
FORMS = {"gate": (320, 160, True, 0, 0, 3), "gelu": (128, 128, False, 0, 0, 4),
         "gate_po": (320, 160, True, 1, 0, 3),
         "gate_list4": (320, 160, True, 4, 0, 2),
         "gelu_ffw2": (128, 128, False, 0, 128, 3),
         "gate_list5": (320, 160, True, 5, 0, 1)}


@pytest.mark.parametrize("form", list(FORMS))
def test_shared_memory_of_each_form(form):
    """The source's arithmetic (ct_smem of ffn_c64.cu; a card test holds the
    two equal): the parts beside the ring and as many 23552-byte slots as
    fit, each with its mbarrier."""
    ch, e, gate, n_po, f, slots = FORMS[form]
    smem, stages = K._c64_smem(ch, e, gate, n_po, f)
    assert stages == slots
    rest = (23552 + 2 * 64 * ch + 2 * e * 64 + n_po * 64 * 64 * 2
            + 2 * (64 * f + f * 64) + 180 * 64 * 4
            + 128 * ((32 if gate else 64) + 8) * 2 + 2 * 9 * ch)
    assert smem == 1024 + stages * (23552 + 8) + rest
    if stages >= 2:
        assert smem <= SMEM_LIMIT
        assert smem + 23552 + 8 > SMEM_LIMIT or stages == 4


@pytest.mark.parametrize("case", [c for c in FFN_C64_CASES])
def test_plan_of_the_card_cases(case):
    """The card cases' bodies: c64 (with its geometry) but for tile_*."""
    b, h, w, c, e, mode, pair, po, _, _, ffw2, _ = FFN_C64_CASES[case]
    ch = 2 * e if mode == "gate" else e
    body, geo = K._ffn_plan(b, h, w, c, ch, e, mode, int(pair), bool(po),
                            po == "batched", 2 * c if ffw2 else 0, True,
                            torch.bfloat16)
    if case.startswith("tile_"):
        assert (body, geo) == ("tile", None)
        return
    assert body == "c64"
    assert geo["tiles"] == b * K._c64_tiles(h, w)
    assert geo["blocks"] == min(geo["tiles"], 132)
    assert geo["chunk"] == (32 if mode == "gate" else 64)
    assert 2 <= geo["stages"] <= 4 and geo["smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("case", list(FFN_C64_LIST_CASES))
def test_plan_of_the_card_list_cases(case):
    b, h, w, c, e, n_stack, n_single, batched, _, _ = FFN_C64_LIST_CASES[case]
    body, geo = K._ffn_plan(b, h, w, c, 2 * e, e, "gate", n_stack + n_single,
                            True, batched, 0, True, torch.bfloat16, n_sm=7)
    if case.startswith("tile_"):
        assert (body, geo) == ("tile", None)
    else:
        # the po matrices of two maps or more leave room for two slots
        assert body == "c64" and geo["stages"] == 2
        assert geo["blocks"] == min(b * K._c64_tiles(h, w), 7)


def _np64(kw):
    """Tensors (and dicts of them) as float64 numpy arrays; None dropped."""
    return {k: (_np64(v) if isinstance(v, dict) else v.double().numpy())
            for k, v in kw.items() if torch.is_tensor(v) or isinstance(v, dict)}


@pytest.mark.parametrize("case", list(FFN_C64_CASES))
def test_plain_matches_twin_float64_at_the_card_cases(case):
    """The plain version the card tests hold the C = 64 body to, against the
    JAX package's plain twin (kernels/vjp.py) in float64 on the same inputs;
    x' formed in numpy as the twin takes it."""
    x, kw = ffn_kernel_case(case, Maker(16, torch.float64), FFN_C64_CASES)
    got = K.fused_block_ffn(x, **kw)
    p, jx = _np64(kw), x.numpy()
    if "x2" in p:
        add = p["x2"]
        if "po_w" in p:
            eq = "bhwc,bce->bhwe" if p["po_w"].ndim == 3 else "bhwc,ce->bhwe"
            add = np.einsum(eq, p["x2"], p["po_w"]) + p.get("po_b", 0.0)
        jx = jx + add
        p = {k: v for k, v in p.items() if k not in ("x2", "po_w", "po_b")}
    want = jvjp._ffn_xla(jnp.asarray(jx), {
        k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
            if isinstance(v, dict) else jnp.asarray(v))
        for k, v in p.items()}, kw["mode"], True,
        "with_bias" if "ln_b" in p else "bias_free")
    close(got, want, ATOL64)


@pytest.mark.parametrize("case", ["lists_stack3_single_ragged",
                                  "lists_two_singles_shared_po_b"])
def test_plain_matches_pallas_interpret_float32_with_lists(case):
    """dec1's list form: the JAX kernel in interpret mode with the same
    stacked entry and maps (a 17 x 16 map, 17 rows: ragged for the body's 16
    x 8 tiles; the Pallas kernel takes W % 8 == 0), one matrix per map, po_b
    added once."""
    b, _, _, c, e, n_stack, n_single, batched, po_b, lnb = (
        FFN_C64_LIST_CASES[case])
    cases = {case: (b, 17, 16, c, e, n_stack, n_single, batched, po_b, lnb)}
    x, kw = ffn_list_case(case, Maker(17, torch.float32), cases)
    f32 = lambda a: jnp.asarray(a.numpy(), jnp.float32)  # noqa: E731
    jkw = {k: ([f32(a) for a in v] if isinstance(v, list)
               else f32(v) if torch.is_tensor(v) else v)
           for k, v in kw.items() if v is not None}
    want = jffn.fused_block_ffn(f32(x), interpret=True, **jkw)
    close(K.fused_block_ffn(x, **kw), np.asarray(want), ATOL32)


@pytest.mark.parametrize("case", ["gelu_scale_ffw2_biasfree_ln_small",
                                  "gelu_scale_e64_smaller_than_a_tile"])
def test_plain_matches_pallas_interpret_float32(case):
    """The chained FFW and the gelu form at E = 64 against the JAX kernel in
    interpret mode, on a 9 x 16 map (the Pallas kernel takes W % 8 == 0)."""
    cases = {case: (1, 9, 16) + FFN_C64_CASES[case][3:]}
    x, kw = ffn_kernel_case(case, Maker(18, torch.float32), cases)
    f32 = lambda a: jnp.asarray(a.numpy(), jnp.float32)  # noqa: E731
    jkw = {k: ({kk: f32(vv) for kk, vv in v.items() if vv is not None}
               if isinstance(v, dict) else f32(v) if torch.is_tensor(v) else v)
           for k, v in kw.items() if v is not None}
    want = jffn.fused_block_ffn(f32(x), interpret=True, **jkw)
    close(K.fused_block_ffn(x, **kw), np.asarray(want), ATOL32)


def test_wrapper_on_the_cpu_runs_the_plain_version_and_launches_nothing():
    x, kw = ffn_kernel_case("gate_pair_po_batched_ragged",
                            Maker(19, torch.bfloat16), FFN_C64_CASES)
    before = (K.fused_block_ffn.launches, K.fused_block_ffn.launches_c64)
    got = K.fused_block_ffn(x, **kw)
    assert torch.equal(got, K.ffn_plain(x, **kw))
    assert (K.fused_block_ffn.launches,
            K.fused_block_ffn.launches_c64) == before
