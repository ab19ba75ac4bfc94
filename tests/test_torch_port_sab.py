"""Port vs JAX package: the alignment attention of the causal history model
(CHM): the probabilities (scores, top-5, local mask, clipped softmax,
validity), the lattice permutation, the SAB ring and the plain tensor
functions under them. On the CPU the port's wrappers run their plain
versions; the Pallas kernels run in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (
    LATTICE_KERNEL_SHAPES,
    SAB_KERNEL_SHAPES,
    Maker,
    close,
    sab_kernel_case,
    t,
)
from turtlevsr_tpu.core import cache as jcache
from turtlevsr_tpu.kernels import lattice as jlattice
from turtlevsr_tpu.kernels import sab as jsab
from turtlevsr_tpu.models import blocks as JB
from turtlevsr_tpu.ops import attn_utils as jau
from turtlevsr_tpu_torch.core import cache as tcache
from turtlevsr_tpu_torch.kernels import lattice as L
from turtlevsr_tpu_torch.kernels import sab as S
from turtlevsr_tpu_torch.ops import attn_utils as tau

torch.set_num_threads(1)
ATOL64 = 1e-12  # the same formula in float64, sums in another order
ATOL32 = 1e-6  # probabilities in [0, 1] from fp32 rows


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _sab_case(name, rng):
    """(q (B, HW, D), k (B, NF, HW, D), temp, fvalid, wq) in float64."""
    b, nf, hq, wq, d = 1, 2, 4, 6, 16
    temp, fvalid = 1.3, np.ones(nf)
    if name == "nonsquare_grid":
        hq, wq = 3, 7
    if name == "fewer_than_5_keys":
        hq, wq = 2, 2
    hw = hq * wq
    q = _unit(rng.standard_normal((b, hw, d)))
    k = _unit(rng.standard_normal((b, nf, hw, d)))
    if name == "ties_first_occurrence_wins":
        # nine keys outside the window of query 0 repeat its own direction:
        # they tie at the top and the first five must be the ones kept
        k[:, :, FAR_FROM_QUERY_0] = q[:, None, 0:1]
    if name == "invalid_frame":
        fvalid[0] = 0.0
    if name == "exactly_zero_score":
        q[:, :, 8:] = 0.0  # orthogonal to every key whose first half is 0
        k[:, :, ::2, :8] = 0.0
        q[:, 5] = 0.0  # and one query that scores 0 against every key
    if name == "entry_in_top5_and_window":
        k[:, :, 1] = q[:, 0]  # key 1 neighbours query 0 and scores highest
        temp = 2.0
    return q, k, temp, fvalid, wq


# on the 4 x 6 grid: the keys at L1 distance > 4 from query 0 at (0, 0)
FAR_FROM_QUERY_0 = [10, 11, 15, 16, 17, 20, 21, 22, 23]
SAB_CASES = ["normal", "ties_first_occurrence_wins", "fewer_than_5_keys",
             "invalid_frame", "exactly_zero_score", "entry_in_top5_and_window",
             "nonsquare_grid"]


def _xla_chain(q, k, temp, fvalid, hq, wq, dtype):
    """The unfused chain of sab_t1_apply (blocks.py:635-640)."""
    qj, kj = jnp.asarray(q, dtype), jnp.asarray(k, dtype)
    attn = jnp.einsum("bqd,bnkd->bnqk", qj, kj) * jnp.asarray(temp, dtype)
    lm = jau.local_window_mask(hq, wq, 4, dtype)
    a = jau.clipped_softmax(jau.topk_keep(attn, 5) + attn * lm[None, None])
    return a * jnp.asarray(fvalid, dtype)[None, :, None, None]


@pytest.mark.parametrize("case", SAB_CASES)
def test_sab_probs_plain_matches_xla_chain_float64(case):
    q, k, temp, fvalid, wq = _sab_case(case, np.random.RandomState(0))
    hw = q.shape[1]
    got = S.sab_attn_probs(t(q), t(k), t(temp), t(fvalid), grid_wq=wq)
    want = np.asarray(_xla_chain(q, k, temp, fvalid, hw // wq, wq,
                                 jnp.float64))
    assert got.shape == (1, 2, hw, hw)
    close(got, want, ATOL64)
    assert np.array_equal(got.numpy() != 0, want != 0)
    sums = got.sum(-1).numpy()
    if case == "exactly_zero_score":
        # a score of exactly 0 drops out, window or not; query 5 scores 0
        # against every key: its row is zeros and not NaN
        assert np.all(got.numpy()[..., ::2] == 0)
        assert np.all(sums[:, :, 5] == 0) and np.isfinite(got.numpy()).all()
        sums = np.delete(sums, 5, axis=2)
    np.testing.assert_allclose(sums, np.broadcast_to(
        fvalid[None, :, None], sums.shape), atol=1e-12)


def test_sab_probs_semantics_of_the_reference():
    """What the cases are built to show, read off the plain version."""
    rng = np.random.RandomState(0)
    q, k, temp, fv, wq = _sab_case("ties_first_occurrence_wins", rng)
    p = S.sab_attn_probs(t(q), t(k), t(temp), t(fv), grid_wq=wq).numpy()
    kept = [j for j in np.nonzero(p[0, 1, 0])[0] if j in FAR_FROM_QUERY_0]
    assert kept == FAR_FROM_QUERY_0[:5]  # the first five of the nine tied
    q, k, temp, fv, wq = _sab_case("entry_in_top5_and_window", rng)
    p = S.sab_attn_probs(t(q), t(k), t(temp), t(fv), grid_wq=wq).numpy()
    s = (q[0] @ k[0, 0].T) * temp
    # key 1 is in the top 5 AND in the window of query 0: it counts twice
    others = [j for j in np.nonzero(p[0, 0, 0])[0] if j != 1]
    j = others[0]
    in_both_j = abs(j // wq) + abs(j % wq) <= 4 and j in np.argsort(
        -s[0])[:5]
    want = np.exp(2 * s[0, 1] - (2 if in_both_j else 1) * s[0, j])
    np.testing.assert_allclose(p[0, 0, 0, 1] / p[0, 0, 0, j], want,
                               rtol=1e-9)
    q, k, temp, fv, wq = _sab_case("invalid_frame", rng)
    p = S.sab_attn_probs(t(q), t(k), t(temp), t(fv), grid_wq=wq).numpy()
    assert np.all(p[:, 0] == 0) and np.all(p[:, 1].sum(-1) > 0.999)


# With fewer than 5 keys the Pallas kernel's fifth round finds nothing left
# and marks key 0 a second time; the port follows the unfused chain, whose
# topk_keep takes min(5, keys): that case is held against the chain only.
@pytest.mark.parametrize("case", [c for c in SAB_CASES
                                  if c != "fewer_than_5_keys"])
def test_sab_probs_plain_matches_pallas_interpret_float32(case):
    q, k, temp, fvalid, wq = _sab_case(case, np.random.RandomState(1))
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    want = np.asarray(jsab.sab_fused_attn_probs(
        f32(q), f32(k).transpose(0, 1, 3, 2), wq, f32(temp), f32(fvalid),
        interpret=True))
    got = S.sab_attn_probs(t(q, torch.float32), t(k, torch.float32),
                           t(temp, torch.float32), t(fvalid, torch.float32),
                           grid_wq=wq)
    assert got.dtype == torch.float32
    close(got, want, ATOL32)
    assert np.array_equal(got.numpy() != 0, want != 0)


@pytest.mark.parametrize("shape", SAB_KERNEL_SHAPES, ids=str)
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "unit"])
def test_sab_probs_plain_matches_pallas_at_the_card_cases(shape, exact):
    """The cases at which the card tests hold the CUDA kernel against the
    plain version: here the plain version against the Pallas kernel (against
    the unfused chain where the grid has fewer than 5 keys)."""
    b, nf, hq, wq, d = shape
    if hq * wq < 5:
        q, k, temp, fv = sab_kernel_case(Maker(9, torch.float64), *shape,
                                         exact=exact)
        want = np.asarray(_xla_chain(q.numpy(), k.numpy(), temp.numpy()[0],
                                     fv.numpy(), hq, wq, jnp.float64))
        got = S.sab_attn_probs(q, k, temp, fv, grid_wq=wq)
        close(got, want, ATOL64)
        assert np.array_equal(got.numpy() != 0, want != 0)
        return
    q, k, temp, fv = sab_kernel_case(Maker(9, torch.float32), *shape,
                                     exact=exact)
    want = np.asarray(jsab.sab_fused_attn_probs(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()).transpose(0, 1, 3, 2),
        wq, jnp.asarray(temp.numpy()[0]), jnp.asarray(fv.numpy()),
        interpret=True))
    got = S.sab_attn_probs(q, k, temp, fv, grid_wq=wq)
    close(got, want, ATOL32)
    assert np.array_equal(got.numpy() != 0, want != 0)


def test_sab_probs_bfloat16_rounds_the_scores_first():
    """The selection runs on the scores as bfloat16 holds them."""
    rng = np.random.RandomState(2)
    q, k, temp, fv, wq = _sab_case("normal", rng)
    qb, kb = t(q, torch.bfloat16), t(k, torch.bfloat16)
    got = S.sab_attn_probs(qb, kb, t(temp), t(fv), grid_wq=wq)
    assert got.dtype == torch.bfloat16
    s = torch.einsum("bqd,bnkd->bnqk", qb.float(), kb.float()) * temp
    s = s.bfloat16().double()
    lm = tau.local_window_mask(4, 6, 4, torch.float64)
    want = tau.clipped_softmax(tau.topk_keep(s, 5) + s * lm)
    close(got, want.numpy(), 2.0 ** -8)
    assert torch.equal(got != 0, want != 0)


def test_sab_probs_refuses_two_grids():
    with pytest.raises(ValueError, match="grids differ"):
        S.sab_attn_probs(torch.zeros(1, 8, 4), torch.zeros(1, 1, 12, 4),
                         torch.ones(1), grid_wq=4)
    with pytest.raises(ValueError, match="must divide"):
        S.sab_attn_probs(torch.zeros(1, 9, 4), torch.zeros(1, 1, 9, 4),
                         torch.ones(1), grid_wq=4)


# ---------------------------------------------------------------------------
# lattice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [8, 64, 128])
def test_lattice_plain_matches_pallas_interpret_and_transpose(c):
    rng = np.random.RandomState(3)
    n, hh, ww, ws = 2, 3, 2, 2
    x = rng.standard_normal((n, hh * ws, ww * ws, c)).astype(np.float32)
    tok = L.lattice_split(t(x, torch.float32), ws)
    assert tok.shape == (n, hh * ww, ws * ws * c)
    assert np.array_equal(tok.numpy(), np.asarray(
        jlattice.lattice_split_op(jnp.asarray(x), ws, True)))
    assert np.array_equal(tok.numpy(), np.asarray(
        JB._lattice_split(jnp.asarray(x), ws)))  # the 6-D transpose
    back = L.lattice_merge(tok, ws, hh * ws, ww * ws)
    assert np.array_equal(back.numpy(), x)  # the round trip is the identity
    assert np.array_equal(back.numpy(), np.asarray(jlattice.lattice_merge_op(
        jnp.asarray(tok.numpy()), ws, hh * ws, ww * ws, True)))
    assert np.array_equal(back.numpy(), np.asarray(JB._lattice_merge(
        jnp.asarray(tok.numpy()), ws, hh * ws, ww * ws)))


@pytest.mark.parametrize("shape", LATTICE_KERNEL_SHAPES, ids=str)
def test_lattice_plain_matches_transpose_at_the_card_cases(shape):
    n, hh, ww, ws, c = shape
    x = np.random.RandomState(4).standard_normal(
        (n, hh * ws, ww * ws, c))
    tok = L.lattice_split_plain(t(x), ws)
    assert np.array_equal(tok.numpy(), np.asarray(
        JB._lattice_split(jnp.asarray(x), ws)))
    # token (i, j), feature (a, b, c) is pixel (a * hh + i, b * ww + j, c)
    i, j, a, b_ = hh - 1, ww - 1, ws - 1, 0
    assert np.array_equal(
        tok[0, i * ww + j].reshape(ws, ws, c)[a, b_].numpy(),
        x[0, a * hh + i, b_ * ww + j])
    assert np.array_equal(
        L.lattice_merge_plain(tok, ws, hh * ws, ww * ws).numpy(), x)


def test_lattice_refuses_a_window_that_does_not_divide():
    with pytest.raises(ValueError, match="must divide"):
        L.lattice_split(torch.zeros(1, 6, 8, 8), 4)
    with pytest.raises(ValueError, match="tokens"):
        L.lattice_merge(torch.zeros(1, 5, 32), 2, 4, 4)


# ---------------------------------------------------------------------------
# the SAB ring and the plain tensor functions
# ---------------------------------------------------------------------------


def test_sab_ring_append_past_the_wrap_and_valid_mask():
    rng = np.random.RandomState(5)
    b, n_frames, hw, dk, dv = 2, 3, 6, 4, 8
    js = jcache.sab_slot_init(b, n_frames, hw, dk, hw, dv, jnp.float64)
    ts = tcache.sab_slot_init(b, n_frames, hw, dk, hw, dv, torch.float64,
                              device="cpu")
    assert ts["n"].dtype == torch.int64 and ts["k"].shape == (b, 3, hw, dk)
    for step in range(5):  # positions 0, 1, 2, then 0 and 1 again
        assert np.array_equal(
            tcache.frame_valid_mask(ts["n"], n_frames).numpy(),
            np.asarray(jcache.frame_valid_mask(js["n"], n_frames)))
        k, v = rng.standard_normal((b, hw, dk)), rng.standard_normal(
            (b, hw, dv))
        js = jcache.sab_slot_append(js, jnp.asarray(k), jnp.asarray(v))
        buf = ts["k"]
        ts = tcache.sab_slot_append(ts, t(k), t(v))
        assert ts["k"] is buf  # written in place
        close(ts["k"], js["k"], 0)
        close(ts["v"], js["v"], 0)
        assert int(ts["n"]) == int(js["n"]) == step + 1
    close(ts["k"][:, 1], k, 0)  # the fifth frame sits at position 4 % 3
    assert tcache.frame_valid_mask(ts["n"], n_frames).all()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_l2_normalize_topk_and_clipped_softmax(dtype):
    rng = np.random.RandomState(6)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    atol = 1e-12 if dtype == "float64" else 1e-6
    x = rng.standard_normal((2, 5, 7))
    x[0, 2] = 0.0  # a zero row stays zero
    close(tau.l2_normalize(t(x, td)), jau.l2_normalize(jnp.asarray(x, jd)),
          atol)
    s = np.round(rng.standard_normal((2, 3, 9)), 1)  # ties
    s[0, 0, :] = 0.7
    for k in (1, 5, 12):
        got = tau.topk_keep(t(s, td), k)
        want = np.asarray(jau.topk_keep(jnp.asarray(s, jd), k))
        close(got, want, 0)
    assert np.array_equal(np.nonzero(tau.topk_keep(t(s), 5)[0, 0].numpy())[0],
                          np.arange(5))  # the first five of nine equal ones
    c = s * (rng.rand(2, 3, 9) > 0.5)
    c[1, 2] = 0.0  # nothing left: zeros, not NaN
    got = tau.clipped_softmax(t(c, td))
    close(got, jau.clipped_softmax(jnp.asarray(c, jd)), atol)
    assert torch.all(got[1, 2] == 0)


@pytest.mark.parametrize("hw", [(4, 6), (3, 7), (1, 5)])
def test_local_window_mask(hw):
    h, w = hw
    want = np.asarray(jau.local_window_mask(h, w, 4))
    assert np.array_equal(tau.local_window_mask(h, w, 4).numpy(), want)
    rows = slice(2, 5)
    assert np.array_equal(
        tau.local_window_mask(h, w, 4, rows=rows).numpy(), want[rows])
