"""Port vs JAX package: options, ops and the FHR ring cache (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import close, t, tiny_fhr_opt
from turtlevsr_tpu.config import options as jopt
from turtlevsr_tpu.core import cache as jcache
from turtlevsr_tpu.ops import attn_utils as jattn
from turtlevsr_tpu.ops import conv as jconv
from turtlevsr_tpu.ops import norm as jnorm
from turtlevsr_tpu.ops import resize as jresize
from turtlevsr_tpu_torch.config import options as topt
from turtlevsr_tpu_torch.core import cache as tcache
from turtlevsr_tpu_torch.ops import attn_utils as tattn
from turtlevsr_tpu_torch.ops import conv as tconv
from turtlevsr_tpu_torch.ops import norm as tnorm
from turtlevsr_tpu_torch.ops import resize as tresize

torch.set_num_threads(1)
# float64: both sides compute the same formula in double precision
ATOL64 = 1e-9
# float32: one rounding per operation on each side, values of order 1..10
ATOL32 = 2e-5


@pytest.mark.parametrize("yml", ["Turtle_Deblur_Gopro.yml",
                                 "Turtle_Denoise_Davis.yml"])
def test_options_match(yml):
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "options", yml)
    a = jopt.model_config_from_options(jopt.load_options(path, False))
    b = topt.model_config_from_options(topt.load_options(path, False))
    for f in ("variant", "dim", "enc_blocks", "middle_blocks", "dec_blocks",
              "num_heads", "ffn_expansion_factor", "bias", "layernorm_bias",
              "num_frames_tocache", "level_dims"):
        assert getattr(a, f) == getattr(b, f), f
    for lvl in ("enc1", "enc2", "enc3", "latent", "dec3", "dec2", "dec1",
                "refinement"):
        la, lb = getattr(a, lvl), getattr(b, lvl)
        assert vars(la) == vars(lb), lvl


def test_options_errors():
    opt = tiny_fhr_opt(encoder1_attn_type1="Bogus")
    with pytest.raises(topt.OptionsError):
        topt.model_config_from_options(opt)
    cfg = topt.model_config_from_options(
        tiny_fhr_opt(latent_attn_type1="CTS"))  # stale alias of FHR
    assert cfg.latent.attn_type1 == "FHR"


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype,atol", [("float64", ATOL64),
                                        ("float32", ATOL32)])
def test_layer_norm(with_bias, dtype, atol):
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 5, 7, 12)) * 3 + 1
    w, b = rng.standard_normal(12), rng.standard_normal(12)
    want = jnorm.layer_norm(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                            jnp.asarray(b, dtype) if with_bias else None)
    td = getattr(torch, dtype)
    got = tnorm.layer_norm(t(x, td), t(w, td), t(b, td) if with_bias else None)
    assert got.dtype == td
    close(got, want, atol)


def test_layer_norm_bf16_statistics_in_fp32():
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.standard_normal((1, 4, 4, 64)), dtype=torch.bfloat16)
    w = torch.ones(64, dtype=torch.bfloat16)
    got = tnorm.layer_norm(x, w, None)
    want = jnorm.layer_norm(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                            jnp.ones(64, jnp.bfloat16), None)
    assert got.dtype == torch.bfloat16
    # both round an fp32 result to bf16 once: at most one ulp (2^-8 relative)
    close(got.float(), np.asarray(want, np.float32), atol=2 ** -6)


@pytest.mark.parametrize("r", [2, 4])
def test_pixel_shuffle_roundtrip_and_order(r):
    rng = np.random.RandomState(2)
    x = rng.standard_normal((2, 8, 12, 3))
    un_j = np.asarray(jresize.pixel_unshuffle(jnp.asarray(x), r))
    un_t = tresize.pixel_unshuffle(t(x), r)
    close(un_t, un_j, 0)
    close(tresize.pixel_shuffle(un_t, r), x, 0)
    y = rng.standard_normal((1, 4, 6, 2 * r * r))
    close(tresize.pixel_shuffle(t(y), r),
          np.asarray(jresize.pixel_shuffle(jnp.asarray(y), r)), 0)
    # and torch's own modules agree (NCHW)
    want = torch.nn.PixelUnshuffle(r)(t(x).permute(0, 3, 1, 2))
    close(un_t.permute(0, 3, 1, 2), want.numpy(), 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
def test_acc_dtype(dtype):
    want = torch.float64 if dtype == torch.float64 else torch.float32
    assert tattn.acc_dtype(dtype) == want
    jd = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
          torch.float64: jnp.float64}[dtype]
    assert str(jattn.acc_dtype(jd)) == str(want).replace("torch.", "")


@pytest.mark.parametrize("dtype,atol", [("float64", ATOL64),
                                        ("float32", 1e-6)])
def test_masked_softmax(dtype, atol):
    rng = np.random.RandomState(3)
    s = rng.standard_normal((2, 3, 4, 10)) * 4
    valid = rng.rand(10) > 0.4
    valid[0] = True
    td = getattr(torch, dtype)
    for v in (None, valid):
        want = jattn.masked_softmax(jnp.asarray(s, dtype),
                                    None if v is None else jnp.asarray(v))
        got = tattn.masked_softmax(t(s, td),
                                   None if v is None else torch.tensor(v))
        close(got, want, atol)
    # no valid key at all: zeros, not NaN
    none = np.zeros(10, bool)
    got = tattn.masked_softmax(t(s, td), torch.tensor(none))
    assert torch.isfinite(got).all() and got.abs().max() == 0
    close(got, jattn.masked_softmax(jnp.asarray(s, dtype),
                                    jnp.asarray(none)), 0)


def test_fhr_ring_append_and_valid_mask():
    rng = np.random.RandomState(4)
    b, heads, n_frames, ctok, l = 1, 2, 3, 4, 6
    js = jcache.fhr_slot_init(b, heads, n_frames, ctok, l, jnp.float64)
    ts = tcache.fhr_slot_init(b, heads, n_frames, ctok, l, torch.float64,
                              device="cpu")
    assert ts["k"].shape == js["k"].shape == (b, heads, n_frames * ctok, l)
    for step in range(5):  # wraps after 3
        close(tcache.token_valid_mask(ts["n"], n_frames, ctok).numpy(),
              np.asarray(jcache.token_valid_mask(js["n"], n_frames, ctok)), 0)
        k = rng.standard_normal((b, heads, ctok, l))
        v = rng.standard_normal((b, heads, ctok, l))
        js = jcache.fhr_slot_append(js, jnp.asarray(k), jnp.asarray(v))
        ts = tcache.fhr_slot_append(ts, t(k), t(v))
        close(ts["k"], js["k"], 0)
        close(ts["v"], js["v"], 0)
        assert int(ts["n"]) == int(js["n"]) == step + 1


@pytest.mark.parametrize("case", ["1x1", "3x3", "dw3x3", "1x1_bias"])
def test_conv2d_matches(case):
    rng = np.random.RandomState(5)
    x = rng.standard_normal((2, 6, 7, 8))
    if case.startswith("1x1"):
        w = rng.standard_normal((1, 1, 8, 5))
        kw = {}
    elif case == "3x3":
        w = rng.standard_normal((3, 3, 8, 5))
        kw = {"padding": 1}
    else:
        w = rng.standard_normal((3, 3, 1, 8))
        kw = {"padding": 1, "groups": 8}
    bias = rng.standard_normal(w.shape[-1]) if case.endswith("bias") else None
    want = jconv.conv2d(jnp.asarray(x), jnp.asarray(w),
                        None if bias is None else jnp.asarray(bias), **kw)
    w_oihw = np.transpose(w, (3, 2, 0, 1))
    got = tconv.conv2d(t(x), t(w_oihw), None if bias is None else t(bias),
                       **kw)
    close(got, want, ATOL64)


def test_conv_init_statistics():
    conv = torch.nn.Conv2d(16, 32, 3, bias=True)
    tconv.conv_init(conv, torch.Generator().manual_seed(0))
    bound = 1.0 / np.sqrt(16 * 9)
    for p in (conv.weight, conv.bias):
        assert p.abs().max() <= bound
    # U(-b, b): std = b / sqrt(3)
    assert abs(conv.weight.std().item() - bound / np.sqrt(3)) < 0.1 * bound
    again = torch.nn.Conv2d(16, 32, 3, bias=True)
    tconv.conv_init(again, torch.Generator().manual_seed(0))
    assert torch.equal(conv.weight, again.weight)


@pytest.mark.parametrize("shape", [(4, 1, 1), (8, 3, 5), (12, 7, 2),
                                   (64, 16, 24), (256, 23, 40)], ids=str)
def test_posenc2d_matches(shape):
    """The 2-D sine-cosine encoding (turtle_arch.py:412-439) in float64 at
    1e-12, and its cast to float32 and bfloat16 on the CPU."""
    d, h, w = shape
    want = np.asarray(jattn.posenc2d(d, h, w, dtype=jnp.float64))
    got = tattn.posenc2d(d, h, w, dtype=torch.float64)
    assert got.shape == (h, w, d) and got.dtype == torch.float64
    assert np.abs(got.numpy() - want).max() <= 1e-12
    for dt in (torch.float32, torch.bfloat16):
        low = tattn.posenc2d(d, h, w, dtype=dt, device="cpu")
        assert low.dtype == dt and torch.equal(low, got.to(dt))


@pytest.mark.parametrize("d_model", [2, 6, 10])
def test_posenc2d_raises_unless_a_multiple_of_four(d_model):
    with pytest.raises(ValueError) as want:
        jattn.posenc2d(d_model, 2, 2)
    with pytest.raises(ValueError) as got:
        tattn.posenc2d(d_model, 2, 2)
    assert str(got.value) == str(want.value)
