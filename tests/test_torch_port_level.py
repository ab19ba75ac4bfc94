"""Port vs JAX package: the run of Channel + gated-FFN blocks
(``fused_channel_gffw_run``). On the CPU the port's wrapper runs its plain
version; it is held against the JAX package's Pallas kernel in interpret mode
(float32) and against its plain twin ``_channel_run_xla`` (float64), and the
models' routing of runs is checked by counting the calls."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_oracle import tiny_opt
from torch_port_util import (
    LEVEL_KERNEL_SHAPES,
    Maker,
    close,
    level_kernel_case,
    numpy_tree_like,
    t,
    to_jnp,
)
from turtlevsr_tpu.kernels import level as JL
from turtlevsr_tpu.kernels import vjp as JV
from turtlevsr_tpu.models import blocks as JB
from turtlevsr_tpu_torch.io.torch_convert import load_jax_params
from turtlevsr_tpu_torch.kernels import level as LV
from turtlevsr_tpu_torch.models import blocks as TB
from turtlevsr_tpu_torch.models import build_model
from turtlevsr_tpu_torch.models import turtle as TT

torch.set_num_threads(1)
ATOL64 = 1e-9
# float32 through 2 blocks (some 20 chained roundings, values of order 5),
# the Pallas kernel's polynomial erf against the library's
ATOL32 = 1e-4


def _specs(c, heads, ln_bias, kernels="xla"):
    common = dict(attn_type="Channel", ffw_type="GFFW", dim=c, num_heads=heads,
                  ffn_expansion_factor=2.5, bias=False, layernorm_bias=ln_bias,
                  num_frames_tocache=0)
    return JB.BlockSpec(kernels=kernels, **common), TB.BlockSpec(**common)


def _blocks(n, c, heads, ln_bias, seed, dtype=torch.float64):
    jspec, tspec = _specs(c, heads, ln_bias)
    rng = np.random.RandomState(seed)
    trees, mods = [], []
    for _ in range(n):
        tree = numpy_tree_like(
            JB.attn_block_init(jax.random.PRNGKey(0), jspec), rng)
        blk = TB.TurtleAttnBlock(tspec).to(dtype).eval()
        load_jax_params(blk, tree)
        trees.append(tree)
        mods.append(blk)
    return jspec, trees, mods, rng


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("ln_bias", [True, False], ids=["WithBias",
                                                        "BiasFree"])
def test_run_float64_against_the_jax_twin(heads, ln_bias):
    """run_weights() of the blocks -> the plain run == _channel_run_xla."""
    jspec, trees, mods, rng = _blocks(3, 8, heads, ln_bias, 0)
    x = rng.standard_normal((2, 9, 13, 8))
    want = JV._channel_run_xla(
        jnp.asarray(x), {"blocks": [to_jnp(tr, jnp.float64) for tr in trees]},
        jspec)
    with torch.inference_mode():
        got = LV.fused_channel_gffw_run(
            t(x), [m.run_weights() for m in mods], heads)
        chain = t(x)
        for m in mods:
            chain, _ = m(chain, None)
    close(got, want, ATOL64)
    close(got, chain.numpy(), 1e-12)


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("ln_bias", [True, False], ids=["WithBias",
                                                        "BiasFree"])
def test_run_float32_against_the_pallas_kernel_interpreted(heads, ln_bias):
    """The JAX package's kernel wants C % 128 == 0 and W % 8 == 0."""
    c = 128
    jspec, trees, mods, rng = _blocks(2, c, heads, ln_bias, 1,
                                      dtype=torch.float32)
    x = (rng.standard_normal((1, 8, 16, c)) * 0.5).astype(np.float32)
    pspec = dataclasses.replace(jspec, kernels="pallas")
    jblocks = [JV._run_block_inputs(to_jnp(tr, jnp.float32), pspec)
               for tr in trees]
    want = JL.fused_channel_gffw_run(
        jnp.asarray(x), jblocks, heads=heads,
        ln_mode="with_bias" if ln_bias else "bias_free", interpret=True)
    with torch.inference_mode():
        got = LV.fused_channel_gffw_run(
            t(x, torch.float32), [m.run_weights() for m in mods], heads)
    assert got.dtype == torch.float32
    close(got, want, ATOL32)


@pytest.mark.parametrize("shape", LEVEL_KERNEL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_run_is_the_split_route_on_the_cpu(shape, dtype):
    """At the card tests' cases: on the CPU the run and the split route are
    the same plain code, so they agree bit for bit, and the float32 run is
    close to the float64 one."""
    x, blocks = level_kernel_case(Maker(13, dtype), *shape)
    heads = shape[5]
    got = LV.fused_channel_gffw_run(x, blocks, heads)
    assert torch.equal(got, LV.channel_gffw_run_split(x, blocks, heads))
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        b64 = [{k: None if v is None else v.double() for k, v in blk.items()}
               for blk in blocks]
        want = LV.channel_gffw_run_plain(x.double(), b64, heads)
        close(got, want.numpy(), 2e-4)


def test_channel_po_against_numpy():
    rng = np.random.RandomState(2)
    b, heads, ctok = 2, 3, 4
    c = heads * ctok
    gram = rng.standard_normal((b, heads, ctok, ctok))
    stats = rng.rand(b, 2, c) + 0.5
    stats[0, 0, 1] = 0.0  # a zero row stays finite
    temp = 0.5 + rng.rand(heads)
    wpo = rng.standard_normal((c, c))
    got = LV.channel_po(t(gram), t(stats), t(temp), t(wpo), heads,
                        torch.float64)
    nq = np.maximum(np.sqrt(stats[:, 0]), 1e-12).reshape(b, heads, ctok)
    nk = np.maximum(np.sqrt(stats[:, 1]), 1e-12).reshape(b, heads, ctok)
    s = gram / (nq[..., None] * nk[..., None, :]) * temp[None, :, None, None]
    e = np.exp(s - s.max(-1, keepdims=True))
    attn = e / e.sum(-1, keepdims=True)
    want = np.einsum("bhcd,hce->bhde", attn, wpo.reshape(heads, ctok, c))
    close(got, want.reshape(b, c, c), 1e-12)


def _count_runs(monkeypatch):
    calls = []
    real = TT.fused_channel_gffw_run

    def spy(x, blocks, heads):
        calls.append(len(blocks))
        return real(x, blocks, heads)

    monkeypatch.setattr(TT, "fused_channel_gffw_run", spy)
    return calls


def test_levels_hand_runs_to_the_run_kernel(monkeypatch):
    """enc3 (2 Channel blocks, the last one closes the run) and the latent's
    middle (3 Channel blocks between the FHR blocks) are runs; dec3 has one
    Channel block before its CHM block and keeps the split route."""
    opt = tiny_opt(Middle_blocks=5)
    plain = build_model(opt, device="cpu", dtype=torch.float64)
    fused = build_model(opt, device="cpu", dtype=torch.float64,
                        fuse=("channel_runs",))
    rng = np.random.RandomState(3)
    with torch.no_grad():  # temperature one, gamma and beta zero at init
        for p in plain.parameters():
            p.copy_(t(rng.standard_normal(tuple(p.shape)) * 0.2 + (
                1.0 if p.dim() == 1 else 0.0)))
    fused.load_state_dict(plain.state_dict())
    calls = _count_runs(monkeypatch)
    c0, c1 = plain.init_cache(2, 32, 32), fused.init_cache(2, 32, 32)
    for _ in range(3):
        pair = t(rng.rand(2, 2, 32, 32, 3))
        with torch.inference_mode():
            want, c0 = plain(pair, c0)
            assert calls == []
            got, c1 = fused(pair, c1)
        assert calls == [2, 3]
        calls.clear()
        close(got, want.numpy(), 1e-12)


def test_biased_or_single_blocks_stay_out_of_runs(monkeypatch):
    calls = _count_runs(monkeypatch)
    model = build_model(tiny_opt(bias=True), device="cpu",
                        fuse=("channel_runs",))
    with torch.inference_mode():
        model(torch.rand(1, 2, 32, 32, 3), model.init_cache(1, 32, 32))
    assert calls == []  # conv biases: no block may join a run
    model = build_model(tiny_opt(Enc_blocks=[1, 1, 1]), device="cpu",
                        fuse=("channel_runs",))
    with torch.inference_mode():
        model(torch.rand(1, 2, 32, 32, 3), model.init_cache(1, 32, 32))
    assert calls == []  # runs of one block keep the split kernels


def test_unknown_fused_plan_raises():
    with pytest.raises(ValueError, match="unknown fused plan"):
        build_model(tiny_opt(), device="cpu", fuse=("everything",))
    model = build_model(tiny_opt(), device="cpu")
    assert model.fuse == ()  # off by default, as the JAX package's opt-ins


def test_run_wrapper_raises_off_the_card_and_on_empty_runs():
    x = torch.zeros(1, 8, 8, 16, device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensors only"):
        LV.fused_channel_gffw_run(x, [{}], 1)
    with pytest.raises(ValueError, match="at least one block"):
        LV.fused_channel_gffw_run(torch.zeros(1, 8, 8, 16), [], 1)
