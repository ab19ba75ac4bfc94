"""The port's reader of the reference's ``.pth`` checkpoints
(``turtlevsr_tpu_torch.io.load_state_dict_file``) and ``cli/infer.py
--model_path`` on the CPU, with files the tests write themselves: the
published ``{'params': state_dict}`` form, a DDP copy whose keys carry
``module.``, and a bare ``state_dict``."""

import os
import re

import numpy as np
import pytest
import torch
import yaml

from reference_oracle import tiny_opt
from turtlevsr_tpu.io.torch_convert import load_torch_checkpoint
from turtlevsr_tpu_torch.cli import infer as TI
from turtlevsr_tpu_torch.io import jax_tree_from_model, load_state_dict_file
from turtlevsr_tpu_torch.models import build_model

torch.set_num_threads(1)

FORMS = {
    "published": lambda sd: {"params": sd},
    "ddp_prefixed": lambda sd: {"params": {"module." + k: v
                                           for k, v in sd.items()}},
    "bare": lambda sd: sd,
    "bare_ddp_prefixed": lambda sd: {"module." + k: v for k, v in sd.items()},
}


def _model(seed):
    return build_model(tiny_opt(), device="cpu",
                       generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def source():
    """A tiny t1 model whose every parameter and buffer differs from a
    second model's drawn from another seed."""
    model = _model(3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("gamma", "beta"):
                p.uniform_(-0.5, 0.5)
    return model


@pytest.mark.parametrize("form", list(FORMS))
def test_loader_restores_a_model_exactly(tmp_path, source, form):
    path = str(tmp_path / "net_g.pth")
    torch.save(FORMS[form](source.state_dict()), path)
    sd = load_state_dict_file(path)
    assert set(sd) == set(source.state_dict())
    target = _model(11)
    target.load_state_dict(sd, strict=True)
    for (name, want), (_, got) in zip(source.state_dict().items(),
                                      target.state_dict().items()):
        assert torch.equal(got, want), name


@pytest.mark.parametrize("form", ["published", "ddp_prefixed"])
def test_loader_reads_what_the_jax_package_reads(tmp_path, source, form):
    """Both packages unwrap ``params`` and strip ``module.``: the port's
    state dict, carried into the JAX tree, equals the JAX reader's tree."""
    path = str(tmp_path / "net_g.pth")
    torch.save(FORMS[form](source.state_dict()), path)
    target = _model(11)
    target.load_state_dict(load_state_dict_file(path), strict=True)
    want = load_torch_checkpoint(path)
    got = jax_tree_from_model(target)

    def leaves(node, prefix=""):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from leaves(v, f"{prefix}.{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                yield from leaves(v, f"{prefix}.{i}")
        else:
            yield prefix, np.asarray(node)

    want_l, got_l = dict(leaves(want)), dict(leaves(got))
    assert set(want_l) == set(got_l)
    for k, v in want_l.items():
        np.testing.assert_array_equal(got_l[k].astype(np.float32), v)


def test_loader_takes_another_param_key(tmp_path, source):
    path = str(tmp_path / "ema.pth")
    torch.save({"params_ema": source.state_dict(), "params": {}}, path)
    assert set(load_state_dict_file(path, param_key="params_ema")) == set(
        source.state_dict())


@pytest.mark.parametrize("form", ["published", "ddp_prefixed", "bare"])
def test_a_missing_key_still_raises(tmp_path, source, form):
    sd = dict(source.state_dict())
    sd.pop("ending.bias")
    path = str(tmp_path / "bad.pth")
    torch.save(FORMS[form](sd), path)
    with pytest.raises(RuntimeError, match="Missing key"):
        _model(11).load_state_dict(load_state_dict_file(path), strict=True)


def test_an_unexpected_key_still_raises(tmp_path, source):
    sd = {**source.state_dict(), "extra.weight": torch.zeros(2)}
    path = str(tmp_path / "bad.pth")
    torch.save({"params": sd}, path)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        _model(11).load_state_dict(load_state_dict_file(path), strict=True)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """data/blur/video0/0000i.png and tiny.yml."""
    from PIL import Image

    root = tmp_path_factory.mktemp("torch_ckpt_cli")
    rng = np.random.RandomState(1)
    d = root / "data" / "blur" / "video0"
    d.mkdir(parents=True)
    for i in range(2):
        Image.fromarray(rng.randint(0, 256, (32, 48, 3), dtype=np.uint8)
                        ).save(d / f"{i:05d}.png")
    with open(root / "tiny.yml", "w") as f:
        yaml.safe_dump(tiny_opt(), f)
    return root


def test_cli_loads_a_published_ddp_file(capsys, workdir, source):
    """cli/infer.py --model_path on a {'params': {'module.' + k: v}} file:
    the pictures are those of the source model, not of random weights."""
    path = str(workdir / "net_g_ddp.pth")
    torch.save(FORMS["ddp_prefixed"](source.state_dict()), path)
    bare = str(workdir / "net_g_bare.pth")
    torch.save(source.state_dict(), bare)
    saved = {}
    for tag, p in (("ddp", path), ("bare", bare)):
        out_dir = workdir / f"out_{tag}"
        TI.main(["-opt", str(workdir / "tiny.yml"), "--data_dir",
                 str(workdir / "data" / "blur"), "--device", "cpu",
                 "--dtype", "float32", "--no_gt", "--model_path", p,
                 "--save_path", str(out_dir)])
        out = capsys.readouterr().out
        assert f"> Loaded Model. ({p})" in out
        assert "WARNING: random init" not in out
        assert re.search(r"^FPS: ", out, re.M)
        from PIL import Image

        saved[tag] = [np.asarray(Image.open(
            out_dir / "video0" / f"Frame_{i}_Pred.png")) for i in (1, 2)]
    for a, b in zip(saved["ddp"], saved["bare"]):
        np.testing.assert_array_equal(a, b)
    assert os.path.getsize(path) > 0
