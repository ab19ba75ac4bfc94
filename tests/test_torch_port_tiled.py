"""Port vs JAX package: tiled sliding-window streaming. The tile grid rides
the batch axis of the model with one cache per tile; both engines overlap-add
in float32, so they are held together at a float32 tolerance while the
batched model call under them is held at the float64 bar."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_oracle import tiny_opt
from torch_port_util import close, numpy_tree_like, t, tiny_fhr_opt, to_jnp
from turtlevsr_tpu.config.options import (
    model_config_from_options as j_config,
)
from turtlevsr_tpu.eval import engine as JE
from turtlevsr_tpu.models import turtle as JT
from turtlevsr_tpu_torch.eval import engine as TE
from turtlevsr_tpu_torch.io.torch_convert import load_jax_params
from turtlevsr_tpu_torch.models import build_model

torch.set_num_threads(1)
ATOL64 = 1e-9  # the batched model call, float64
# the engines: both sum the tiles and divide by the coverage in float32
# (values in [0, 1], up to 4 addends, one division), whatever the model's type
ATOL_ENGINE = 2e-6
N_FRAMES = 5  # num_frames_tocache is 2 in the tiny model: the rings wrap
# 50 x 70 frames: reflect-padded to 56 x 72; tiles of 32 with overlap 8 give
# rows [0, 24] x columns [0, 24, 40] = 6 tiles, in chunks of 4 + 2
FRAME, TILE, OVERLAP, CHUNK = (50, 70), 32, 8, 4


def _models(seed, make_opt=tiny_opt, dtype=torch.float64, fuse=(),
            **overrides):
    opt = make_opt(**overrides)
    jcfg = j_config({**opt, "kernels": "xla"})
    tree = numpy_tree_like(JT.init_params(jax.random.PRNGKey(0), jcfg),
                           np.random.RandomState(seed))
    model = build_model(opt, device="cpu", dtype=dtype, fuse=fuse)
    load_jax_params(model, tree)
    return jcfg, tree, model


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_tiled_engines_five_frames(bias):
    """Both tiled engines over 5 cache-threaded frames: a frame size that
    needs reflect padding, a tile count (6) that the chunk (4) does not
    divide; the port's last chunk is short, the JAX engine pads its grid."""
    jcfg, tree, model = _models(0, bias=bias)
    jeng = JE.InferenceEngine(jcfg, to_jnp(tree, jnp.float64), mode="tiled",
                              tile=TILE, tile_overlap=OVERLAP,
                              dtype=jnp.float64, max_tile_batch=CHUNK)
    teng = TE.InferenceEngine(model, mode="tiled", tile=TILE,
                              tile_overlap=OVERLAP, max_tile_batch=CHUNK,
                              dtype=torch.float64, device="cpu")
    hp, wp, tile, his, wis = teng.tile_plan(*FRAME)
    assert (hp, wp, tile, his, wis) == (56, 72, 32, [0, 24], [0, 24, 40])
    frames = np.random.RandomState(1).rand(N_FRAMES, *FRAME, 3).astype(
        np.float32)
    for i, fr in enumerate(frames):
        want, got = jeng.step(fr), teng.step(fr)
        assert got.shape == (*FRAME, 3) and got.dtype == np.float32
        assert got.min() >= 0.0 and got.max() <= 1.0
        close(got, want, ATOL_ENGINE)
    # one cache per tile, the ring counts advanced once per frame
    for ts, js in zip(teng._cache, jeng._cache):
        assert (ts is None) == (js is None)
        if ts is not None:
            assert ts["k"].shape[0] == 6 and int(ts["n"]) == N_FRAMES
            close(ts["k"], js["k"], ATOL64)
            close(ts["v"], js["v"], ATOL64)


def test_tiled_engine_float32_model():
    jcfg, tree, model = _models(2, make_opt=tiny_fhr_opt)
    jeng = JE.InferenceEngine(jcfg, to_jnp(tree, jnp.float32), mode="tiled",
                              tile=TILE, tile_overlap=OVERLAP,
                              dtype=jnp.float32, max_tile_batch=CHUNK)
    teng = TE.InferenceEngine(model, mode="tiled", tile=TILE,
                              tile_overlap=OVERLAP, max_tile_batch=CHUNK,
                              dtype=torch.float32, device="cpu")
    frames = np.random.RandomState(3).rand(3, *FRAME, 3).astype(np.float32)
    for fr in frames:  # float32 through 11 blocks and 8 convs
        close(teng.step(fr), jeng.step(fr), 2e-4)
    dev = teng.step_async(frames[0])
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float32


@pytest.mark.parametrize("make_opt", [tiny_opt, tiny_fhr_opt],
                         ids=["chm", "fhr"])
def test_batched_model_call_float64(make_opt):
    """The call under the tiled engine: a batch of 3 tiles with per-tile
    caches through both models, 4 frames."""
    jcfg, tree, model = _models(4, make_opt=make_opt)
    jp = to_jnp(tree, jnp.float64)
    rng = np.random.RandomState(5)
    jc = JT.init_cache(jcfg, 3, 32, 32, jnp.float64)
    tc = model.init_cache(3, 32, 32)
    for _ in range(4):
        pair = rng.rand(3, 2, 32, 32, 3)
        want, jc = JT.forward(jp, jcfg, jnp.asarray(pair), jc)
        with torch.inference_mode():
            got, tc = model(t(pair), tc)
        close(got, want, ATOL64)
    for ts, js in zip(tc, jc):
        if ts is not None:
            close(ts["v"], js["v"], ATOL64)


@pytest.mark.parametrize("chunk", [1, 4, 6, 15])
def test_chunking_does_not_change_a_tile(chunk):
    """A tile's result does not depend on what else is in its batch, and the
    chunks share one ring count per frame."""
    _, _, model = _models(6)
    frames = np.random.RandomState(7).rand(4, *FRAME, 3).astype(np.float32)
    ref = TE.InferenceEngine(model, mode="tiled", tile=TILE,
                             tile_overlap=OVERLAP, max_tile_batch=6,
                             dtype=torch.float64, device="cpu")
    eng = TE.InferenceEngine(model, mode="tiled", tile=TILE,
                             tile_overlap=OVERLAP, max_tile_batch=chunk,
                             dtype=torch.float64, device="cpu")
    for fr in frames:
        close(eng.step(fr), ref.step(fr), 1e-12)
    assert [None if s is None else int(s["n"]) for s in eng._cache] == [
        None, None, None, 4, 4, 4, 4, 4]


def test_tiled_engine_with_the_fused_plan_equals_the_split_plan():
    _, _, model = _models(8, Middle_blocks=4)
    _, _, fused = _models(8, Middle_blocks=4,
                          fuse=("channel_runs", "attn_v_merge"))
    kw = dict(mode="tiled", tile=TILE, tile_overlap=OVERLAP,
              max_tile_batch=CHUNK, dtype=torch.float64, device="cpu")
    a, b = TE.InferenceEngine(model, **kw), TE.InferenceEngine(fused, **kw)
    for fr in np.random.RandomState(9).rand(4, *FRAME, 3).astype(np.float32):
        # the same sums in another association: float64 rounding only
        close(b.step(fr), a.step(fr), 1e-12)


def test_tiled_engine_restarts_on_reset_and_on_a_new_frame_size():
    _, _, model = _models(10, make_opt=tiny_fhr_opt)
    eng = TE.InferenceEngine(model, mode="tiled", tile=TILE,
                             tile_overlap=OVERLAP, dtype=torch.float64,
                             device="cpu")
    rng = np.random.RandomState(11)
    a, b = (rng.rand(*FRAME, 3).astype(np.float32) for _ in range(2))
    first = eng.step(a)
    eng.step(b)
    eng.reset()
    close(eng.step(a), first, 0)
    small = eng.step(rng.rand(24, 40, 3).astype(np.float32))
    assert small.shape == (24, 40, 3)
    assert eng._cache[3]["k"].shape[0] == 2  # tiles of 24: columns [0, 16]
    close(eng.step(a), first, 0)  # a new size starts a new video


@pytest.mark.parametrize("hw", [(720, 1280), (50, 70), (64, 64), (33, 200),
                                (1080, 1920)])
@pytest.mark.parametrize("tile,overlap", [(320, 192), (320, 128), (32, 8),
                                          (256, 64)])
def test_tile_plan_is_the_jax_engines(hw, tile, overlap):
    h, w = hw
    eng = TE.InferenceEngine.__new__(TE.InferenceEngine)
    eng.tile, eng.tile_overlap = tile, overlap
    if min(tile, *JE._pad8(h, w)) <= overlap:
        # a frame smaller than the overlap: the reference's grid would leave
        # pixels uncovered (a division by zero); the port refuses
        with pytest.raises(ValueError, match="leaves no stride"):
            eng.tile_plan(h, w)
        return
    hp, wp, t_, his, wis = eng.tile_plan(h, w)
    assert (hp, wp) == JE._pad8(h, w) == TE._pad8(h, w)
    assert t_ == min(tile, hp, wp)
    assert his == JE._tile_grid(hp, t_, t_ - overlap)
    assert wis == JE._tile_grid(wp, t_, t_ - overlap)
    jeng = JE.InferenceEngine.__new__(JE.InferenceEngine)
    jeng.tile, jeng.tile_overlap = tile, overlap
    assert jeng._grid_size(h, w) == (len(his) * len(wis), t_)


def test_the_deblur_preset_gives_45_tiles_of_a_720p_frame():
    eng = TE.InferenceEngine.__new__(TE.InferenceEngine)
    eng.tile, eng.tile_overlap = 320, 192
    _, _, t_, his, wis = eng.tile_plan(720, 1280)
    assert (t_, len(his), len(wis)) == (320, 5, 9)


def test_engine_arguments_are_checked():
    model = build_model(tiny_fhr_opt(), device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        TE.InferenceEngine(model, mode="strips", device="cpu")
    with pytest.raises(ValueError, match="tile_overlap"):
        TE.InferenceEngine(model, mode="tiled", tile=32, tile_overlap=32,
                           device="cpu")
    with pytest.raises(ValueError, match="max_tile_batch"):
        TE.InferenceEngine(model, mode="tiled", max_tile_batch=0,
                           device="cpu")
    eng = TE.InferenceEngine(model, mode="tiled", tile=36, tile_overlap=8,
                             device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="multiple of 8"):
        eng.step(np.zeros((64, 64, 3), np.float32))


def test_video_frames_reads_a_sorted_folder(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(12)
    imgs = [rng.randint(0, 256, (9, 11, 3), dtype=np.uint8) for _ in range(3)]
    for name, img in zip(("00002.png", "00000.png", "00001.png"), imgs):
        Image.fromarray(img).save(tmp_path / name)
    vf = TE.VideoFrames(str(tmp_path))
    assert len(vf) == 3
    got, want = list(vf), list(JE.VideoFrames(str(tmp_path)))
    for g, w_ in zip(got, want):
        assert g.dtype == np.float32 and np.array_equal(g, w_)
    assert np.array_equal(got[0], imgs[1].astype(np.float32) / 255.0)
    with pytest.raises(FileNotFoundError):
        TE.VideoFrames(str(tmp_path / "none"))
