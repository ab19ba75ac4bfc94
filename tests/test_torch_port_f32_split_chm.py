"""The float32 bodies of rows 4 and 6 (kernels/csrc/split_f32.cu,
kernels/csrc/chm_f32.cu, on csrc/f32_tile.cuh's product and, for row 6,
csrc/gram_f32.cuh's Gram pass): which float32 calls their plans take, their
launch geometry and scratch, the refusals outside their forms, torch mirrors
of what the kernels compute after the products, and the plain versions
against the JAX package.

Runs on the CPU. Every fused_ln_split_proj and fused_chm_stats call of one
float32 model call under ``fuse=()`` (recorded on fake tensors, as
tests/test_torch_port_f32_conv_av.py records) at the sizes of
tests/test_torch_port_f32_bodies.py and at 1920x1080 goes to the float32
body, its shared memory within a block's; the launch code reaches the
body's launch (stubbed: no card here) with its scratch; the taps' grid of
row 4 and the Gram pass's walk of rows 3 and 6 (tiles, partial rows, the
fixed-order sum of the rows), mirrored in torch, give the plain versions in
float64; the plain versions equal the JAX package's kernels in interpret
mode. The kernels' arithmetic against the plain versions runs on the card
(tests/test_torch_port_cuda.py -k "split_f32 or chm_f32").
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_chm import _check_chm_stats, _jax_chm_stats
from test_torch_port_f32_conv_av import ALL_SIZES, _record
from test_torch_port_float32 import _chip_smoke, _FakeLib
from test_torch_port_frame_sizes import FILES
from test_torch_port_pw_split_c64 import _projs
from torch_port_util import Maker, chain_kernel_case, close
from turtlevsr_tpu.kernels import ffn as jffn
from turtlevsr_tpu_torch import kernels as KP
from turtlevsr_tpu_torch.kernels import ffn as K

torch.set_num_threads(1)
SMEM_LIMIT = 232448  # dynamic shared memory a block can have on an H100
WRAPPERS = ("fused_ln_split_proj", "fused_chm_stats")
ATOL64 = 1e-9  # float64 mirrors against the plain versions: another order
ATOL32 = 3e-5  # float32 against the Pallas kernels in interpret mode


@pytest.mark.parametrize("size", list(ALL_SIZES))
def test_every_float32_call_of_rows_4_and_6_on_the_float32_bodies(size):
    """Each float32 call of rows 4 and 6 under fuse=() gets its float32
    body: the plan answers "f32" with the body's scratch, the shared memory
    fits a block; the CHM files' five split projections (the latent FHR
    blocks' q, k, v, the SAB fronts' q, k) and three CHM fronts, the t0
    files' two and three; at 720p the counts are chip_smoke.py's table."""
    task, (b, h, w) = ALL_SIZES[size]
    cfg, calls = _record(FILES[task], h, w, b, wrappers=WRAPPERS, fuse=())
    n_split = n_chm = 0
    for name, args, kw in calls:
        x = args[0]
        bb, hh, ww, c = x.shape
        if name == "fused_ln_split_proj":
            n_out = kw["n_out"]
            e = kw["w1"].shape[1] // n_out
            body, geo = K._split_plan(bb, hh, ww, c, e, n_out,
                                      kw.get("ln_w") is not None,
                                      kw.get("b1") is not None,
                                      torch.float32)
            assert geo["scratch"] == bb * hh * ww * (n_out * e + 2)
            n_split += 1
        else:
            nf = args[1].shape[1]
            body, geo = K._chm_plan(bb, hh, ww, c, kw["heads"], torch.float32,
                                    nf=nf)
            assert geo["scratch"] == bb * hh * ww * (3 * c + 2 + 2 * nf * c)
            n_chm += 1
        assert body == "f32", (name, x.shape)
        assert geo["smem"] <= SMEM_LIMIT
    sab = cfg.variant != "t0"
    assert (n_split, n_chm) == ((5, 3) if sab else (2, 3))
    if size == "deblur_1280x720":
        table = _chip_smoke().LAUNCHES_PER_CALL_F32["gopro"]
        assert (table["split_f32"], table["chm_f32"]) == (n_split, n_chm)
        assert (table["split_proj"], table["chm_stats"]) == (n_split, n_chm)


# (B, H, W, C, n_out, biases): the paths' forms (the latent's q, k, v, the
# SAB q, k at dec3 and dec1, 15 tiles), ragged maps, four maps, biases
SPLIT_FORMS = [(1, 92, 160, 512, 3, False), (15, 80, 80, 256, 2, False),
               (1, 736, 1280, 64, 2, False), (2, 37, 53, 128, 4, True),
               (1, 3, 5, 64, 1, True)]


@pytest.mark.parametrize("form", SPLIT_FORMS, ids=str)
def test_split_f32_geometry_mirrors_the_launch_sequence(form, monkeypatch):
    """Row 4's float32 launches, as turtle_split_f32_launch makes them: the
    rows' LayerNorm statistics (a warp a pixel), pw1 into h on the tile of N
    E (128 x 64 up to 64 hidden channels, else 128 x 128), the taps (16
    pixels x 64 channels, 4 rows a thread); the launch code (stubbed) passes
    h and the statistics last, one launch of the wrapper counted on the
    body."""
    b, h, w, c, n, biases = form
    geo = K._split_f32_geometry(b, h, w, c, c, n, True)
    m, ch = h * w, n * c
    bn = 64 if ch <= 64 else 128
    assert geo["launches"] == {"pw1 LN": b * -(-m // 8),
                               "pw1": b * -(-m // 128) * -(-ch // bn),
                               "taps": b * -(-w // 16) * -(-h // 4)
                               * -(-ch // 64)}
    assert geo["blocks"] == sum(geo["launches"].values())
    assert geo["kind"] == ("half" if ch <= 64 else "wide")
    assert geo["smem"] == K._fp_smem(geo["kind"]) <= SMEM_LIMIT
    assert geo["scratch"] == b * m * (ch + 2)
    for has_bias in (False, True):
        assert K._split_plan(b, h, w, c, c, n, True, has_bias,
                             torch.float32) == ("f32", geo)

    fake = _FakeLib()
    monkeypatch.setattr(K.build, "load", lambda name: fake)
    monkeypatch.setattr(K, "_stream", lambda x: 0)
    monkeypatch.setattr(K, "_sm_count", lambda device: 132)
    KP.reset_launch_counts()
    x, kw = chain_kernel_case(Maker(3, torch.float32), 1, 5, 7, c, ch,
                              biases)
    outs = K._split_proj_launch(x, kw["ln_w"], kw["ln_b"], kw["w1"],
                                kw.get("b1"), kw["wd"], kw.get("bd"), n)
    (ptrs, ints, is_bf16), = fake.launches
    assert is_bf16 == 0 and ints == [1, 5, 7, c, c, n]
    assert len(ptrs) == 13 and None not in ptrs[11:]
    assert ptrs[7:7 + n] == [o.data_ptr() for o in outs]
    assert ptrs[7 + n:11] == [None] * (4 - n)
    assert (ptrs[4] is not None) == (ptrs[6] is not None) == biases
    counts = KP.launch_counts()
    assert counts["split_proj"] == counts["split_f32"] == 1
    assert sum(counts.values()) == 2


# (B, H, W, C, heads, NF): dec3, dec2, dec1 of a padded 720p frame, dec3 at
# 15 tiles, a ragged pair of entries, C = 512
CHM_FORMS = [(1, 184, 320, 256, 4, 4), (1, 368, 640, 128, 2, 4),
             (1, 736, 1280, 64, 1, 3), (15, 80, 80, 256, 4, 4),
             (2, 37, 53, 128, 2, 2), (1, 19, 27, 512, 8, 1)]


@pytest.mark.parametrize("form", CHM_FORMS, ids=str)
def test_chm_f32_geometry_mirrors_the_launch_sequence(form, monkeypatch):
    """Row 6's float32 launches, as turtle_chm_f32_launch makes them: the
    LayerNorm's statistics and pw1 of x into h (3C), pw1 of the B NF frames
    into hh (2C), the Gram pass's G x heads x B (NF + 1) blocks, G at most
    two blocks an SM over all the heads, entries and parts (one wave), at
    least one, at most one a tile of 4 x 16 pixels, each writing a partial
    row for every chunk of at most 8 of its tiles; the launch code
    (stubbed) passes the partial rows, h, hh and the statistics, G and the
    chunks."""
    b, h, w, c, heads, nf = form
    geo = K._chm_f32_geometry(b, h, w, c, heads, nf)
    m = h * w
    tiles = -(-h // 4) * -(-w // 16)
    g = max(1, min(tiles, 264 // (heads * b * (nf + 1))))
    chunks = -(-(-(-tiles // g)) // 8)  # at most 8 of a block's tiles a row
    assert (geo["grid"], geo["chunks"], geo["rows"]) == (g, chunks,
                                                         g * chunks)
    assert geo["launches"] == {"pw1 LN": b * -(-m // 8),
                               "pw1": b * -(-m // 128) * -(-3 * c // 128),
                               "kv": b * nf * -(-m // 128) * -(-2 * c // 128),
                               "gram": g * heads * b * (nf + 1)}
    assert geo["launches"]["gram"] <= 264 or g == 1
    assert geo["smem"] == max(K._fp_smem("wide"), (2 * 64 + 30) * 64 * 4)
    assert geo["scratch"] == b * m * (3 * c + 2 + 2 * nf * c)
    assert K._chm_plan(b, h, w, c, heads, torch.float32, nf=nf) == ("f32",
                                                                    geo)

    fake = _FakeLib()
    monkeypatch.setattr(K.build, "load", lambda name: fake)
    monkeypatch.setattr(K, "_stream", lambda x: 0)
    monkeypatch.setattr(K, "_sm_count", lambda device: 132)
    monkeypatch.setattr(K, "_reduce_rows", lambda part, what: part.sum(1))
    KP.reset_launch_counts()
    mk = Maker(4, torch.float32)
    x, x_sp = mk(1, 5, 7, c), mk(1, nf, 5, 7, c)
    kw = dict(ln_w=mk(c), ln_b=mk(c), w_qkv=mk(c, 3 * c),
              wd_qkv=mk(3, 3, 3 * c), w_kv=mk(c, 2 * c),
              wd_kv=mk(3, 3, 2 * c))
    v, vh, gram, gh, stats = K._chm_stats_launch(x, x_sp, heads=heads, **kw)
    (ptrs, ints, is_bf16), = fake.launches
    tiny = K._chm_f32_geometry(1, 5, 7, c, heads, nf)
    assert is_bf16 == 0 and ints == [1, 5, 7, c, heads, nf, tiny["grid"],
                                     tiny["chunks"]]
    assert len(ptrs) == 14 and None not in ptrs
    assert ptrs[8:10] == [v.data_ptr(), vh.data_ptr()]
    assert gh.shape == (1, nf, heads, 64, 64) and stats.shape == (1, nf + 2,
                                                                  c)
    counts = KP.launch_counts()
    assert counts["chm_stats"] == counts["chm_f32"] == 1
    assert sum(counts.values()) == 2


@pytest.mark.parametrize("change", ["no_ln", "e_ne_c", "c32", "c1024",
                                    "five_maps"])
def test_split_f32_geometry_refuses_outside_its_forms(change):
    """Row 4's float32 form is the LayerNorm, E = C a multiple of 16 from 64
    to 512, 1-4 maps: the geometry raises naming the body for the rest, and
    the plan sends the rest to csrc/split_proj.cu (or refuses it there)."""
    args = dict(b=1, h=8, w=8, c=128, e=128, n_out=2, has_ln=True)
    args.update({"no_ln": dict(has_ln=False), "e_ne_c": dict(e=64, n_out=4),
                 "c32": dict(c=32, e=32), "c1024": dict(c=1024, e=1024),
                 "five_maps": dict(n_out=5)}[change])
    with pytest.raises(ValueError, match="csrc/split_f32.cu takes float32 "
                       "calls with the LayerNorm, E = C a multiple of 16 "
                       "from 64 to 512, 1-4 maps"):
        K._split_f32_geometry(**args)
    assert K._split_plan(**args, has_bias=False, dtype=torch.float32) == (
        "tile", None)


@pytest.mark.parametrize("c,heads,nf", [(128, 4, 2), (256, 2, 2),
                                        (1024, 16, 2), (64, 1, 0)])
def test_chm_f32_geometry_refuses_outside_its_forms(c, heads, nf):
    """Row 6's float32 form is 64 channels a head, C up to 512, at least one
    aligned frame; a float32 plan needs the frames' count."""
    with pytest.raises(ValueError, match="csrc/chm_f32.cu takes float32 maps "
                       "of 64 channels a head, C up to 512, at least one "
                       "aligned frame"):
        K._chm_f32_geometry(1, 8, 8, c, heads, nf)
    with pytest.raises(TypeError, match="needs nf"):
        K._chm_plan(1, 8, 8, 128, 2, torch.float32)


def test_float32_calls_no_body_takes_raise_before_any_build(monkeypatch):
    """A float32 call outside every body of its row raises in the wrapper
    before anything is built or launched: row 6 at 128 channels a head, row
    4 at C = 40."""
    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(K.build, "load", no_build)
    monkeypatch.setattr(K, "_sm_count", lambda device: 132)
    mk = Maker(5, torch.float32)
    c = 256
    with pytest.raises(ValueError, match="C / heads <= 64"):
        K._chm_stats_launch(mk(1, 5, 7, c), mk(1, 2, 5, 7, c), mk(c), None,
                            mk(c, 3 * c), mk(3, 3, 3 * c), mk(c, 2 * c),
                            mk(3, 3, 2 * c), 2)
    with pytest.raises(ValueError, match="C must be a multiple of 16"):
        K._split_proj_launch(mk(1, 5, 7, 40), mk(40), None, mk(40, 80), None,
                             mk(3, 3, 80), None, 2)


def _split_taps_mirror(hid, wd, bd, n_out, e):
    """split_taps_kernel's grid in torch: blocks (ceil(W / 16), ceil(H / 4),
    B ceil(CH / 64)) of 256 threads, thread t four channels c = (16 cg + t %
    16) 4 of column x = 16 bx + t / 16 and rows 4 by .. 4 by + 3; channel c
    of h goes to map c / E at c % E. Returns the maps and how often each
    element of them was written."""
    b, h, w, ch = hid.shape
    n_cg = -(-ch // 64)
    taps = K._dw_acc(hid, wd, bd)  # the taps in row-major order, then bd
    bz, by, bx, t = torch.meshgrid(torch.arange(b * n_cg),
                                   torch.arange(-(-h // 4)),
                                   torch.arange(-(-w // 16)),
                                   torch.arange(256), indexing="ij")
    c = ((bz % n_cg) * 16 + t % 16) * 4
    x = bx * 16 + t // 16
    bb = bz // n_cg
    outs = torch.zeros(n_out, b, h, w, e, dtype=hid.dtype)
    writes = torch.zeros(n_out, b, h, w, e, dtype=torch.long)
    for r in range(4):
        y = by * 4 + r
        on = (c < ch) & (x < w) & (y < h)
        for i in range(4):
            cc = (c + i)[on]
            idx = (cc // e, bb[on], y[on], x[on], cc % e)
            outs[idx] = taps[bb[on], y[on], x[on], cc]
            writes.index_put_(idx, torch.ones_like(cc), accumulate=True)
    return outs, writes


@pytest.mark.parametrize("shape", [(2, 7, 37, 64, 3, True),
                                   (1, 9, 16, 128, 2, False),
                                   (1, 4, 5, 64, 4, True)], ids=str)
def test_split_f32_taps_mirror_is_the_plain_version(shape):
    """pw1 with the LayerNorm into one hidden map, then split_taps_kernel's
    grid (every output element written once, hidden channel c into map c /
    E) is split_proj_plain in float64."""
    b, h, w, c, n, biases = shape
    x, kw = chain_kernel_case(Maker(6, torch.float64), b, h, w, c, n * c,
                              biases)
    xn = K._ln_acc(x, kw["ln_w"], kw["ln_b"])
    hid = xn @ kw["w1"] + (kw["b1"] if biases else 0)
    outs, writes = _split_taps_mirror(hid, kw["wd"], kw.get("bd"), n, c)
    assert bool((writes == 1).all())
    want = K.split_proj_plain(x, n_out=n, **kw)
    for got, w_ in zip(outs, want):
        torch.testing.assert_close(got, w_, atol=ATOL64, rtol=0)


def _gram_pass_mirror(hq, hk, heads, nf, g_blocks, chunks):
    """gram_f32.cuh's f32_gram_kernel in torch: hq the taps of h (B, H, W,
    3C: q, k, v), hk those of hh (B NF, H, W, 2C: kh, vh; None for row 3).
    Block (g, hd, b NP + j) walks tiles g, g + G, .. of 4 x 16 pixels in
    order, in R chunks (its k-th tile in chunk ck where ck n / R <= k < (ck
    + 1) n / R, n its tiles); part 0 takes q, k, v of hq, part j > 0 q of hq
    and k, v of frame j - 1 of hk; it writes v (or vh) of its head and, a
    chunk, its piece of partial row g R + ck of entry b: [gram (NP, heads,
    64, 64) | sum q^2 (C) | sum k_j^2 (NP, C)], the q sums by part 0 only.
    Returns v, vh, the rows (NaN where nothing wrote) and the writes of
    each element of v, vh and the rows."""
    b, h, w, c3 = hq.shape
    c, np_ = c3 // 3, nf + 1
    grams = np_ * heads * 64 * 64
    part = torch.full((b, g_blocks * chunks, grams + (np_ + 1) * c),
                      float("nan"), dtype=hq.dtype)
    part_w = torch.zeros(part.shape, dtype=torch.long)
    v = torch.zeros(b, h, w, c, dtype=hq.dtype)
    vh = torch.zeros(b, nf, h, w, c, dtype=hq.dtype)
    v_w = torch.zeros(v.shape, dtype=torch.long)
    vh_w = torch.zeros(vh.shape, dtype=torch.long)
    tiles_x = -(-w // 16)
    n_tiles = -(-h // 4) * tiles_x
    for bi, j, hd, g, ck in itertools.product(range(b), range(np_),
                                              range(heads), range(g_blocks),
                                              range(chunks)):
        cs = slice(hd * 64, hd * 64 + 64)
        mine = list(range(g, n_tiles, g_blocks))
        n = len(mine)
        gram = torch.zeros(64, 64, dtype=hq.dtype)
        sq = torch.zeros(64, dtype=hq.dtype)
        sk = torch.zeros(64, dtype=hq.dtype)
        for tile in mine[ck * n // chunks:(ck + 1) * n // chunks]:
            y0, x0 = (tile // tiles_x) * 4, (tile % tiles_x) * 16
            ys = slice(y0, min(y0 + 4, h))
            xs = slice(x0, min(x0 + 16, w))
            q = hq[bi, ys, xs, cs].reshape(-1, 64)
            if j == 0:
                k = hq[bi, ys, xs, c:][..., cs].reshape(-1, 64)
                v[bi, ys, xs, cs] = hq[bi, ys, xs, 2 * c:][..., cs]
                v_w[bi, ys, xs, cs] += 1
            else:
                fr = hk[bi * nf + j - 1]
                k = fr[ys, xs, cs].reshape(-1, 64)
                vh[bi, j - 1, ys, xs, cs] = fr[ys, xs, c:][..., cs]
                vh_w[bi, j - 1, ys, xs, cs] += 1
            gram += q.T @ k
            sq += (q * q).sum(0)
            sk += (k * k).sum(0)
        r = g * chunks + ck
        at = (j * heads + hd) * 4096
        part[bi, r, at:at + 4096] = gram.flatten()
        part_w[bi, r, at:at + 4096] += 1
        if j == 0:
            part[bi, r, grams + hd * 64:grams + hd * 64 + 64] = sq
            part_w[bi, r, grams + hd * 64:grams + hd * 64 + 64] += 1
        at = grams + (1 + j) * c + hd * 64
        part[bi, r, at:at + 64] = sk
        part_w[bi, r, at:at + 64] += 1
    return v, vh, part, (v_w, vh_w, part_w)


def _reduce_rows_mirror(part):
    """turtle_reduce_rows as kernels/ffn.py _reduce_rows drives it: groups
    of ceil(rows / 64) rows summed in row order, until one row is left."""
    while part.shape[1] > 1:
        rows = part.shape[1]
        per = -(-rows // K._REDUCE_GROUPS) if rows > K._REDUCE_GROUPS else rows
        part = torch.stack([part[:, i:i + per].sum(1)
                            for i in range(0, rows, per)], dim=1)
    return part[:, 0]


# (B, H, W, heads, NF, G, R): row 6's forms on maps the 4 x 16 tiles do not
# divide, a G of one, of every tile, of more blocks than tiles would give,
# chunks of one tile, of uneven tile counts, more chunks than a block's
# tiles; row 3 (NF = 0: one part, one chunk)
GRAM_CASES = [(2, 9, 37, 2, 2, 4, 1), (1, 7, 20, 1, 3, 1, 3),
              (1, 5, 33, 1, 1, 9, 2), (1, 9, 21, 1, 2, 2, 6),
              (2, 6, 17, 2, 0, 3, 1), (1, 9, 21, 1, 0, 6, 1)]


@pytest.mark.parametrize("case", GRAM_CASES, ids=str)
def test_gram_pass_mirror_is_the_plain_version(case):
    """The products into h and hh, the Gram pass's walk (v and vh written
    once, every element of every partial row once) and the fixed-order sum
    of the rows give chm_stats_plain in float64 (NF = 0: qkv_stats_plain,
    row 3's layout)."""
    b, h, w, heads, nf, g_blocks, chunks = case
    c = 64 * heads
    mk = Maker(7, torch.float64)
    x = mk(b, h, w, c)
    kw = dict(ln_w=1.0 + 0.2 * mk(c), ln_b=mk(c),
              w_qkv=mk(c, 3 * c, scale=c ** -0.5),
              wd_qkv=mk(3, 3, 3 * c, scale=0.3))
    hq = K._dw_acc(K._ln_acc(x, kw["ln_w"], kw["ln_b"]) @ kw["w_qkv"],
                   kw["wd_qkv"], None)
    hk = None
    if nf:
        kw.update(w_kv=mk(c, 2 * c, scale=c ** -0.5),
                  wd_kv=mk(3, 3, 2 * c, scale=0.3))
        x_sp = mk(b, nf, h, w, c)
        hk = K._dw_acc(x_sp.reshape(b * nf, h, w, c) @ kw["w_kv"],
                       kw["wd_kv"], None)
    v, vh, part, writes = _gram_pass_mirror(hq, hk, heads, nf, g_blocks,
                                            chunks)
    for wr in writes:
        assert bool((wr == 1).all())
    tot = _reduce_rows_mirror(part)
    n_g = heads * 64 * 64
    tol = dict(atol=ATOL64, rtol=0)
    if not nf:
        wv, wg, ws = K.qkv_stats_plain(x, ln_w=kw["ln_w"], ln_b=kw["ln_b"],
                                       w1=kw["w_qkv"], wd=kw["wd_qkv"],
                                       heads=heads)
        torch.testing.assert_close(v, wv, **tol)
        torch.testing.assert_close(tot[:, :n_g].reshape(wg.shape) / (h * w),
                                   wg / (h * w), **tol)
        torch.testing.assert_close(tot[:, n_g:].reshape(ws.shape) / (h * w),
                                   ws / (h * w), **tol)
        return
    want = K.chm_stats_plain(x, x_sp, heads=heads, **kw)
    got = (v, vh, tot[:, :n_g].reshape(want[2].shape),
           tot[:, n_g:(nf + 1) * n_g].reshape(want[3].shape),
           tot[:, (nf + 1) * n_g:].reshape(want[4].shape))
    for i, (a, w_) in enumerate(zip(got, want)):
        scale = 1 if i < 2 else h * w  # the statistics: sums over the pixels
        torch.testing.assert_close(a / scale, w_ / scale, **tol)


@pytest.mark.parametrize("n_out,c,ln_bias", [(2, 64, True), (3, 128, False),
                                             (1, 64, True)])
def test_split_plain_matches_pallas_interpret_float32(n_out, c, ln_bias):
    """Row 4's plain version in float32, the yardstick of split_f32.cu on the
    card, against the JAX kernel in interpret mode at the new body's forms
    (the LayerNorm, E = C) on a 9 x 16 map."""
    m = Maker(28, torch.float32)
    x = m(1, 9, 16, c)
    kw = dict(ln_w=1.0 + 0.2 * m(c), ln_b=m(c) if ln_bias else None,
              w1=m(c, c * n_out, scale=c ** -0.5),
              wd=m(3, 3, c * n_out, scale=0.3))
    p = {k: None if v is None else v.numpy() for k, v in kw.items()}
    ln = dict(ln_w=jnp.asarray(p["ln_w"]))
    if ln_bias:
        ln["ln_b"] = jnp.asarray(p["ln_b"])
    want = jffn.fused_ln_split_proj(jnp.asarray(x.numpy()), _projs(p, n_out),
                                    interpret=True, **ln)
    got = K.split_proj_plain(x, n_out=n_out, **kw)
    assert len(got) == n_out
    for g, w_ in zip(got, want):
        close(g, np.asarray(w_), ATOL32)


@pytest.mark.parametrize("heads,nf,ln_bias", [(1, 3, True), (2, 4, False)])
def test_chm_plain_matches_pallas_interpret_float32(heads, nf, ln_bias):
    """Row 6's plain version in float32, the yardstick of chm_f32.cu on the
    card, against the JAX kernel in interpret mode at the new body's forms
    (64 channels a head: dec1's 64 + 3 frames, dec2's 128 + 4) on an 8 x 16
    map."""
    c = 64 * heads
    rng = np.random.RandomState(29)
    r = rng.standard_normal
    x, x_sp = r((1, 8, 16, c)), r((1, nf, 8, 16, c))
    p = dict(ln_w=1 + 0.2 * r(c), ln_b=r(c) if ln_bias else None,
             w_qkv=r((c, 3 * c)) / np.sqrt(c), wd_qkv=0.3 * r((3, 3, 3 * c)),
             w_kv=r((c, 2 * c)) / np.sqrt(c), wd_kv=0.3 * r((3, 3, 2 * c)))
    f = lambda a: None if a is None else torch.tensor(  # noqa: E731
        a, dtype=torch.float32)
    got = K.chm_stats_plain(f(x), f(x_sp), heads=heads,
                            **{k: f(a) for k, a in p.items()})
    _check_chm_stats(got, _jax_chm_stats(x, x_sp, p, jnp.float32, True),
                     heads, ATOL32)
