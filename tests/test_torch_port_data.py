"""The port's training data (turtlevsr_tpu_torch.data) against the JAX
package's, on the CPU: the same option dicts, seeds and frame folders
(written here from a seed) give the same crops, modes, noise, indices and
batches.

Exact (bit for bit) everywhere but the SR dataset's LQ, which the JAX
package makes with cv2's uint8 bicubic (fixed-point weights) and the port in
float64, rounded: at most one level of 255 (times rgb_range) a pixel.
"""

import os

import numpy as np
import pytest

from turtlevsr_tpu.data import dataset as JD
from turtlevsr_tpu.data import loader as JL
from turtlevsr_tpu.data import sampler as JS
from turtlevsr_tpu.data import transforms as JT
from turtlevsr_tpu_torch.data import dataset as TD
from turtlevsr_tpu_torch.data import loader as TL
from turtlevsr_tpu_torch.data import sampler as TS
from turtlevsr_tpu_torch.data import transforms as TT


@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    """Two videos of 7 frames, 36 x 44 (not multiples of the patch or of
    size_must_mode), under a path that holds "DAVIS" and one that does
    not."""
    from PIL import Image

    roots = {}
    rng = np.random.RandomState(0)
    for tag in ("DAVIS_set", "plain_set"):
        root = tmp_path_factory.mktemp(tag)
        for sub in ("gt", "blur"):
            for v in range(2):
                d = root / sub / f"video{v}"
                d.mkdir(parents=True)
                for f in range(7):
                    img = (rng.rand(36, 44, 3) * 255).astype(np.uint8)
                    Image.fromarray(img).save(d / f"{f:05d}.png")
        roots[tag] = str(root)
    return roots


def _opt(root, **kw):
    opt = {"n_sequence": 3, "n_colors": 3, "rgb_range": 1, "patch_size": 20,
           "no_augment": False, "size_must_mode": 8, "manual_seed": 7,
           "dir_data": [root], "datasets": {"val": {"dir_data": [root]}}}
    opt.update(kw)
    return opt


@pytest.mark.parametrize("mode", range(8))
def test_augmentation_modes_equal_jax(mode):
    img = np.random.RandomState(mode).rand(5, 7, 6)
    got = TT.data_augmentation(img, mode)
    np.testing.assert_array_equal(got, JT.data_augmentation(img, mode))
    with pytest.raises(ValueError):
        TT.data_augmentation(img, 8)


def test_random_augmentation_get_patch_and_mod_crop_equal_jax():
    a = np.random.RandomState(1).rand(17, 23, 6)
    b = np.random.RandomState(2).rand(68, 92, 6)
    for seed in range(12):
        got = TT.random_augmentation(np.random.RandomState(seed), a, a + 1)
        want = JT.random_augmentation(np.random.RandomState(seed), a, a + 1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for scale in (1, 4):
            lr = a if scale == 4 else b
            got = TT.get_patch(np.random.RandomState(seed), lr, b,
                               patch_size=5, scale=scale)
            want = JT.get_patch(np.random.RandomState(seed), lr, b,
                                patch_size=5, scale=scale)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    for s in (1, 3, 4, 8):
        np.testing.assert_array_equal(TT.mod_crop(b, s), JT.mod_crop(b, s))


def _same_items(got_ds, want_ds, idx):
    for i in idx:
        got, want = got_ds[i], want_ds[i]
        assert got["key"] == want["key"]
        for k in ("lq", "gt"):
            assert got[k].dtype == want[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("phase", ["train", "val"])
@pytest.mark.parametrize("tag", ["DAVIS_set", "plain_set"])
@pytest.mark.parametrize("kw", [{}, {"no_augment": True, "rgb_range": 255}],
                         ids=["augment", "no_augment_rgb255"])
def test_video_image_dataset_items_equal_jax(dataroot, phase, tag, kw):
    """lq, gt and key bit for bit over a sequence of reads (one generator
    each: the crops, modes and noise draws follow each other), both videos,
    an index past the end (it wraps)."""
    opt = _opt(dataroot[tag], **kw)
    got_ds = TD.VideoImageDataset(opt, phase)
    want_ds = JD.VideoImageDataset(opt, phase)
    assert len(got_ds) == len(want_ds) == 10
    assert got_ds.n_frames_video == want_ds.n_frames_video == [7, 7]
    assert [got_ds._locate(i) for i in range(12)] == [
        want_ds._locate(i) for i in range(12)]
    _same_items(got_ds, want_ds, [0, 4, 5, 9, 3, 11, 0])
    shape = (3, 16, 16, 3) if phase == "train" else (3, 36, 44, 3)
    assert got_ds[2]["lq"].shape == shape


def test_davis_noise_draws_equal_jax(dataroot):
    """The noise path: sigma ~ U[20, 50] / 255 a frame in training, 50 /
    255 in validation, the same draws; a second read draws anew."""
    for phase in ("train", "val"):
        opt = _opt(dataroot["DAVIS_set"], no_augment=True)
        got_ds = TD.VideoImageDataset(opt, phase)
        want_ds = JD.VideoImageDataset(opt, phase)
        a, b = got_ds[1], got_ds[1]
        assert np.abs(a["lq"] - b["lq"]).max() > 0
        w = want_ds[1]
        np.testing.assert_array_equal(a["lq"], w["lq"])
        np.testing.assert_array_equal(b["lq"], want_ds[1]["lq"])
    # without "DAVIS" in the path no noise: whole frames read alike
    clean = TD.VideoImageDataset(_opt(dataroot["plain_set"]), "val")
    assert np.abs(clean[1]["lq"] - clean[1]["lq"]).max() == 0


def test_seed_zero_gives_an_unseeded_generator(dataroot):
    """manual_seed 0 is no seed (the JAX package's `int(seed) or None`):
    two datasets draw other crops."""
    opt = _opt(dataroot["plain_set"], manual_seed=0, patch_size=8)
    a = [TD.VideoImageDataset(opt, "train")[0]["gt"] for _ in range(4)]
    assert any(np.abs(x - a[0]).max() > 0 for x in a[1:])


@pytest.mark.parametrize("phase", ["train", "val"])
def test_video_super_image_dataset_within_one_level_of_jax(dataroot, phase):
    """The SR LQ: the bicubic / 4 of the port in float64 against cv2's
    fixed-point uint8 one, at most one level of 255 a pixel; gt and key
    exact, and the crops and modes the same (the draws do not depend on the
    pixels)."""
    for rgb_range in (1, 255):
        opt = _opt(dataroot["plain_set"], patch_size=16, rgb_range=rgb_range,
                   model="Turtlesuper_t1_arch")
        got_ds = TD.create_dataset(opt, phase)
        want_ds = JD.create_dataset(opt, phase)
        assert isinstance(got_ds, TD.VideoSuperImageDataset)
        assert isinstance(want_ds, JD.VideoSuperImageDataset)
        n_diff = n_all = 0
        for i in (0, 3, 7, 0):
            got, want = got_ds[i], want_ds[i]
            assert got["key"] == want["key"]
            np.testing.assert_array_equal(got["gt"], want["gt"])
            assert got["lq"].shape == want["lq"].shape
            diff = np.abs(got["lq"].astype(np.float64) - want["lq"])
            level = rgb_range / 255.0
            assert diff.max() <= level * (1 + 1e-6), diff.max() / level
            n_diff += int((diff > 0).sum())
            n_all += diff.size
        print(f"SR LQ ({phase}, rgb_range {rgb_range}): {n_diff} of "
              f"{n_all} values one level apart ({n_diff / n_all:.4%})")
        shape = (3, 4, 4, 3) if phase == "train" else (3, 9, 11, 3)
        assert got_ds[0]["lq"].shape == shape


@pytest.mark.parametrize("items,replicas,rank,ratio,epoch", [
    (10, 1, 0, 1, 0), (10, 1, 0, 1, 3), (7, 2, 0, 1, 1), (7, 2, 1, 1, 1),
    (5, 3, 2, 4, 2), (1, 4, 3, 1, 0), (13, 4, 1, 2, 5)])
def test_enlarged_sampler_indices_equal_jax(items, replicas, rank, ratio,
                                            epoch):
    got = TS.EnlargedSampler(items, replicas, rank, ratio)
    want = JS.EnlargedSampler(items, replicas, rank, ratio)
    got.set_epoch(epoch)
    want.set_epoch(epoch)
    assert len(got) == len(want)
    assert list(got) == list(want)
    assert all(0 <= i < items for i in got)


@pytest.mark.parametrize("drop_last", [True, False])
def test_prefetch_loader_batches_equal_jax(dataroot, drop_last):
    """Batches in order and content, one worker (the shared generator's
    draws then follow the sampler's order), the last incomplete batch
    dropped or kept; two epochs."""
    opt = _opt(dataroot["DAVIS_set"])
    got_ds = TD.VideoImageDataset(opt, "train")
    want_ds = JD.VideoImageDataset(opt, "train")
    got_s, want_s = (TS.EnlargedSampler(len(got_ds), 1, 0),
                     JS.EnlargedSampler(len(want_ds), 1, 0))
    got_l = TL.PrefetchLoader(got_ds, got_s, 3, num_workers=1,
                              drop_last=drop_last)
    want_l = JL.PrefetchLoader(want_ds, want_s, 3, num_workers=1,
                               drop_last=drop_last)
    assert len(got_l) == len(want_l) == (3 if drop_last else 4)
    for epoch in range(2):
        got_s.set_epoch(epoch)
        want_s.set_epoch(epoch)
        got, want = list(got_l), list(want_l)
        assert len(got) == len(want) == len(got_l)
        for g, w in zip(got, want):
            assert g["key"] == w["key"]
            for k in ("lq", "gt"):
                np.testing.assert_array_equal(g[k], w[k])
        assert got[-1]["lq"].shape[0] == (3 if drop_last else 1)


def test_prefetch_loader_raises_an_item_error_and_stops_early():
    class Bad:
        def __getitem__(self, i):
            if i == 4:
                raise OSError("unreadable frame")
            return {"lq": np.full((1, 2, 2, 3), i, np.float32),
                    "gt": np.zeros((1, 2, 2, 3), np.float32), "key": [str(i)]}

    loader = TL.PrefetchLoader(Bad(), range(8), 2, num_workers=2)
    with pytest.raises(OSError, match="unreadable"):
        list(loader)
    first = next(iter(loader))  # leaving early is safe
    assert first["key"] == [["0"], ["1"]]


def test_create_dataset_dispatch_equals_jax(dataroot):
    root = dataroot["plain_set"]
    for kw, want in (({}, "VideoImageDataset"),
                     ({"model": "Turtle_t1_arch", "type": "deblurring"},
                      "VideoImageDataset"),
                     ({"model": "Turtlesuper_t1_arch"},
                      "VideoSuperImageDataset"),
                     ({"model": "Turtle_t1_arch",
                       "type": "SuperResolution"}, "VideoSuperImageDataset"),
                     ({"model": "Turtle_arch", "type": "deraining"},
                      "VideoImageDataset")):
        opt = _opt(root, **kw)
        assert type(TD.create_dataset(opt, "train")).__name__ == want
        assert type(JD.create_dataset(opt, "train")).__name__ == want


def test_frames_are_read_as_imageio_reads_them(tmp_path):
    """PIL's read of grey, RGB and RGBA PNGs against imageio's (the JAX
    package's reader), after the reader's grey-to-RGB and alpha drop."""
    from PIL import Image

    rng = np.random.RandomState(3)
    for mode, shape in (("L", (9, 7)), ("RGB", (9, 7, 3)),
                        ("RGBA", (9, 7, 4))):
        path = os.path.join(tmp_path, f"{mode}.png")
        Image.fromarray((rng.rand(*shape) * 255).astype(np.uint8),
                        mode).save(path)
        got = TD._imread(path)
        assert got.shape == (9, 7, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, JD._imread(path))
