"""Port vs JAX package: the gradients of the kernels (kernels/vjp.py and the
lattice pair of kernels/lattice.py) on the CPU, where each Function's
forward is the plain version.

Each Function's backward is held against ``jax.vjp`` of its JAX op's
backward chain (the ``_*_xla`` twin that the op's ``custom_vjp``
differentiates, turtlevsr_tpu/kernels/vjp.py) on the same float64 inputs
and cotangent, and against finite differences (``gradcheck``). The lattice
pair is held against ``jax.vjp`` of the JAX ops in interpret mode, and its
backward is checked to run the other wrapper.

Tolerances: float64 at 1e-9 where the JAX chain is float64 throughout.
Four JAX chains compute in float32 inside (the per-batch po product of
``_ffn_xla``, the Grams of ``_qkv_stats_xla`` and ``_chm_stats_xla``, the
scores of ``_sab_attn_probs_xla``, the product of ``_av_merge_xla``): there
the limit is 2e-5 of the largest gradient (float32 rounding, 6e-8 relative,
through sums of up to a few hundred terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import Maker, close, numpy_tree_like, t
from turtlevsr_tpu.kernels import lattice as jlat
from turtlevsr_tpu.kernels import vjp as jvjp
from turtlevsr_tpu.models import blocks as JB
from turtlevsr_tpu_torch.io.torch_convert import (
    jax_tree_from_model,
    load_jax_params,
)
from turtlevsr_tpu_torch.kernels import lattice as L
from turtlevsr_tpu_torch.kernels import vjp as V
from turtlevsr_tpu_torch.models import blocks as TB
from turtlevsr_tpu_torch.ops.attn_utils import local_window_mask

torch.set_num_threads(1)
ATOL64 = 1e-9
F32_INSIDE = 2e-5  # relative to the largest gradient, see the module note


def _leaves(tree, prefix=""):
    """(path, leaf) of a nest of dicts and lists, None leaves skipped."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def _torch_vjp(fn, tree, cts):
    """(outputs, {path: gradient}) of fn(tree) under the cotangents cts,
    every floating tensor of the tree a leaf that requires grad."""
    tree = jax.tree.map(lambda a: a, tree)  # a copy of the nest
    paths = [(p, a) for p, a in _leaves(tree)
             if isinstance(a, torch.Tensor) and a.is_floating_point()]
    for _, a in paths:
        a.requires_grad_()
    outs = fn(tree)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(outs, [a for _, a in paths],
                                [t(c) for c in cts], allow_unused=True)
    return outs, {p: g for (p, _), g in zip(paths, grads)}


def _np(tree):
    return jax.tree.map(
        lambda a: a.detach().numpy() if isinstance(a, torch.Tensor) else a,
        tree)


def _check_grads(got: dict, want: dict, rel=None):
    assert set(got) == set(want), set(got) ^ set(want)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    atol = ATOL64 if rel is None else rel * scale
    for p in want:
        close(got[p], np.asarray(want[p]), atol)


def _jax_vjp(fn, tree, cts):
    """(outputs, {path: gradient}); the cotangents in the outputs' types
    (float32 where the chain computes in float32)."""
    out, pull = jax.vjp(fn, jax.tree.map(jnp.asarray, tree))
    (g,) = pull(jax.tree.map(lambda c, o: jnp.asarray(c, o.dtype), cts, out))
    return out, dict(_leaves(g))


# ---------------------------------------------------------------------------
# rows 1 and 2: the FFN half
# ---------------------------------------------------------------------------

# name: (mode, x2 form, biases, scale, ffw2, depthwise)
FFN_GRAD_CASES = {
    "gate_pair_po_shared_bias": ("gate", "shared", True, False, False, True),
    "gelu_scale_ffw2": ("gelu", None, True, True, True, True),
    "gelu_no_dw_row2": ("gelu", None, True, True, False, False),
    "gate_list_po_batched": ("gate", "list", False, False, False, True),
}


def _ffn_case(name, rng):
    mode, x2, biases, scale, ffw2, dw = FFN_GRAD_CASES[name]
    b, h, w, c, e = 2, 4, 5, 8, 6
    ch = 2 * e if mode == "gate" else e
    r = rng.standard_normal
    kw = dict(ln_w=1 + 0.2 * r(c), ln_b=r(c), w1=r((c, ch)) / np.sqrt(c),
              w2=r((e, c)) / np.sqrt(e))
    if dw:
        kw["wd"] = 0.3 * r((3, 3, ch))
    if biases:
        kw.update(b1=r(ch), b2=r(c), **({"bd": r(ch)} if dw else {}))
    if scale:
        kw["scale"] = r(c)
    if x2 == "shared":
        kw.update(x2=r((b, h, w, c)), po_w=r((c, c)) / np.sqrt(c), po_b=r(c))
    elif x2 == "list":  # a stacked entry of 2 maps and a single map
        kw.update(x2=[r((b, 2, h, w, c)), r((b, h, w, c))],
                  po_w=[r((b, c, c)) / np.sqrt(c) for _ in range(3)])
    if ffw2:
        f = 2 * c
        kw["ffw2"] = dict(ln_w=1 + 0.2 * r(c), ln_b=r(c),
                          w1=r((c, f)) / np.sqrt(c), b1=r(f),
                          w2=r((f, c)) / np.sqrt(f), b2=r(c), scale=r(c))
    return mode, {"x": r((b, h, w, c)), **kw}, (b, h, w, c)


@pytest.mark.parametrize("name", list(FFN_GRAD_CASES))
def test_block_ffn_backward_matches_jax_vjp(name):
    rng = np.random.RandomState(0)
    mode, tree, shape = _ffn_case(name, rng)
    ct = rng.standard_normal(shape)

    def port(tr):
        kw = dict(tr)
        return V.fused_block_ffn(kw.pop("x"), mode=mode, **kw)

    out, got = _torch_vjp(port, jax.tree.map(t, tree), [ct])
    assert out[0].grad_fn.name() == "BlockFFNBackward"

    def jfn(tr):
        p = dict(tr)
        return jvjp._ffn_xla(p.pop("x"), p, mode, True, "with_bias")

    want_out, want = _jax_vjp(jfn, tree, ct)
    rel = F32_INSIDE if FFN_GRAD_CASES[name][1] == "list" else None
    close(out[0], np.asarray(want_out), ATOL64 if rel is None else 1e-5)
    _check_grads(got, want, rel)


# ---------------------------------------------------------------------------
# rows 3, 4, 6: the projections and statistics
# ---------------------------------------------------------------------------


def _proj_tree(rng, c, e, n, biases, ln=True):
    r = rng.standard_normal
    tree = {"w1": r((c, n * e)) / np.sqrt(c), "wd": 0.3 * r((3, 3, n * e))}
    if biases:
        tree.update(b1=r(n * e), bd=r(n * e))
    if ln:
        tree.update(ln_w=1 + 0.2 * r(c), ln_b=r(c))
    return tree


def _projs(tree, n, keys=("w1", "b1", "wd", "bd")):
    """The port's side-by-side weights as the JAX package's list."""
    e = tree["w1"].shape[-1] // n
    return [{k: tree[k][..., i * e:(i + 1) * e] for k in keys if k in tree}
            for i in range(n)]


def _unproj(want, n, prefix, keys=("w1", "b1", "wd", "bd")):
    """JAX gradients of a proj list, joined side by side again."""
    out = {}
    for k in keys:
        parts = [want.pop(f"{prefix}[{i}].{k}", None) for i in range(n)]
        if parts[0] is not None:
            out[f".{k}"] = np.concatenate(
                [np.asarray(p) for p in parts], axis=-1)
    return out


@pytest.mark.parametrize("n_out,biases", [(3, True), (2, False), (1, True)])
def test_split_proj_backward_matches_jax_vjp(n_out, biases):
    rng = np.random.RandomState(1)
    c, e = 8, 6
    tree = {"x": rng.standard_normal((2, 5, 4, c)),
            **_proj_tree(rng, c, e, n_out, biases)}
    cts = [rng.standard_normal((2, 5, 4, e)) for _ in range(n_out)]

    def port(tr):
        kw = dict(tr)
        return V.fused_ln_split_proj(kw.pop("x"), n_out=n_out, **kw)

    out, got = _torch_vjp(port, jax.tree.map(t, tree), cts)
    assert out[0].grad_fn.name() == "SplitProjBackward"
    jtree = {"x": tree["x"], "ln_w": tree["ln_w"], "ln_b": tree["ln_b"],
             "projs": _projs(tree, n_out)}
    _, want = _jax_vjp(lambda tr: jvjp._split_proj_xla(
        tr["x"], tr, "with_bias"), jtree, tuple(cts))
    want.update(_unproj(want, n_out, ".projs"))
    _check_grads(got, want)


def _block_diag(g, heads):
    """(B, heads, ct, ct) per-head blocks -> (B, C, C) with zeros off them."""
    b, _, ct, _ = g.shape
    out = np.zeros((b, heads * ct, heads * ct))
    for h in range(heads):
        out[:, h * ct:(h + 1) * ct, h * ct:(h + 1) * ct] = g[:, h]
    return out


def test_qkv_stats_backward_matches_jax_vjp():
    rng = np.random.RandomState(2)
    b, c, heads = 2, 8, 2
    ct = c // heads
    tree = {"x": rng.standard_normal((b, 5, 4, c)),
            **_proj_tree(rng, c, c, 3, True)}
    cts = [rng.standard_normal((b, 5, 4, c)),
           rng.standard_normal((b, heads, ct, ct)),
           rng.standard_normal((b, 2, c))]

    def port(tr):
        kw = dict(tr)
        return V.fused_qkv_stats(kw.pop("x"), heads=heads, **kw)

    out, got = _torch_vjp(port, jax.tree.map(t, tree), cts)
    assert out[0].grad_fn.name() == "QKVStatsBackward"
    s_ct = np.zeros((b, 8, 2 * c))
    s_ct[:, 0] = np.concatenate([cts[2][:, 0], cts[2][:, 1]], axis=-1)
    jtree = {"x": tree["x"], "ln_w": tree["ln_w"], "ln_b": tree["ln_b"],
             "projs": _projs(tree, 3)}
    _, want = _jax_vjp(lambda tr: jvjp._qkv_stats_xla(
        tr["x"], tr, "with_bias"), jtree,
        (cts[0], _block_diag(cts[1], heads), s_ct))
    want.update(_unproj(want, 3, ".projs"))
    _check_grads(got, want, F32_INSIDE)


@pytest.mark.parametrize("ln_bias", [True, False])
def test_chm_stats_backward_matches_jax_vjp(ln_bias):
    rng = np.random.RandomState(3)
    b, c, heads, nf = 2, 8, 2, 3
    ct = c // heads
    r = rng.standard_normal
    tree = {"x": r((b, 4, 5, c)), "x_sp": r((b, nf, 4, 5, c)),
            "ln_w": 1 + 0.2 * r(c), "w_qkv": r((c, 3 * c)) / np.sqrt(c),
            "wd_qkv": 0.3 * r((3, 3, 3 * c)),
            "w_kv": r((c, 2 * c)) / np.sqrt(c),
            "wd_kv": 0.3 * r((3, 3, 2 * c))}
    if ln_bias:
        tree["ln_b"] = r(c)
    cts = [r((b, 4, 5, c)), r((b, nf, 4, 5, c)), r((b, heads, ct, ct)),
           r((b, nf, heads, ct, ct)), r((b, nf + 2, c))]

    def port(tr):
        kw = dict(tr)
        return V.fused_chm_stats(kw.pop("x"), kw.pop("x_sp"), heads=heads,
                                 **kw)

    out, got = _torch_vjp(port, jax.tree.map(t, tree), cts)
    assert out[0].grad_fn.name() == "CHMStatsBackward"
    s_ct = np.zeros((b, nf + 2, 8, c))
    s_ct[:, :, 0] = cts[4]
    gh_ct = np.stack([_block_diag(cts[3][:, i], heads) for i in range(nf)], 1)
    qkv = _projs({"w1": tree["w_qkv"], "wd": tree["wd_qkv"]}, 3)
    kv = _projs({"w1": tree["w_kv"], "wd": tree["wd_kv"]}, 2)
    jtree = {"x": tree["x"], "x_sp": tree["x_sp"], "qkv": qkv, "kv": kv,
             **{k: tree[k] for k in ("ln_w", "ln_b") if k in tree}}
    _, want = _jax_vjp(lambda tr: jvjp._chm_stats_xla(
        tr["x"], tr["x_sp"], tr, "with_bias" if ln_bias else "bias_free"),
        jtree, (cts[0], cts[1], _block_diag(cts[2], heads), gh_ct, s_ct))
    for src, dst, n in ((".qkv", "qkv", 3), (".kv", "kv", 2)):
        for k, a in _unproj(want, n, src, ("w1", "wd")).items():
            want[{".w1": ".w_", ".wd": ".wd_"}[k] + dst] = a
    _check_grads(got, want, F32_INSIDE)


# ---------------------------------------------------------------------------
# row 5: the 3x3 conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bias,ln", [(True, False), (False, True)])
def test_conv3x3_backward_matches_jax_vjp(bias, ln):
    rng = np.random.RandomState(4)
    r = rng.standard_normal
    cin, cout = 8, 5
    tree = {"x": r((2, 5, 6, cin)), "weight": r((3, 3, cin, cout)) / 8}
    if bias:
        tree["bias"] = r(cout)
    if ln:
        tree.update(ln_w=1 + 0.2 * r(cin), ln_b=r(cin))
    ct = r((2, 5, 6, cout))

    def port(tr):
        kw = dict(tr)
        return V.fused_conv3x3(kw.pop("x"), kw.pop("weight"),
                               kw.pop("bias", None), **kw)

    out, got = _torch_vjp(port, jax.tree.map(t, tree), [ct])
    assert out[0].grad_fn.name() == "Conv3x3Backward"
    _, want = _jax_vjp(lambda tr: jvjp._conv3_xla(
        tr["x"], {k: v for k, v in tr.items() if k != "x"}), tree, ct)
    _check_grads(got, want)


# ---------------------------------------------------------------------------
# rows 7, 11, 12: the alignment attention
# ---------------------------------------------------------------------------


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def test_sab_probs_backward_matches_jax_vjp():
    rng = np.random.RandomState(5)
    b, nf, hq, wq, d = 2, 3, 3, 4, 16
    hw = hq * wq
    q = _unit(rng.standard_normal((b, hw, d)))
    k = _unit(rng.standard_normal((b, nf, hw, d)))
    temp = np.full((1, 1, 1), 1.7)
    fvalid = np.array([1.0, 0.0, 1.0])
    ct = rng.standard_normal((b, nf, hw, hw))

    def port(tr):
        return V.sab_attn_probs(tr["q"], tr["k"], tr["temp"], t(fvalid),
                                grid_wq=wq)

    out, got = _torch_vjp(port, jax.tree.map(t, {"q": q, "k": k,
                                                 "temp": temp}), [ct])
    assert out[0].grad_fn.name() == "SABProbsBackward"
    mask = local_window_mask(hq, wq, 4, torch.float64).numpy()
    want_out, want = _jax_vjp(lambda tr: jvjp._sab_attn_probs_xla(
        tr["q"], jnp.swapaxes(tr["k"], -1, -2), jnp.asarray(mask),
        tr["temp"], jnp.asarray(fvalid)), {"q": q, "k": k, "temp": temp}, ct)
    close(out[0], np.asarray(want_out), 1e-6)
    _check_grads(got, want, F32_INSIDE)


def test_sparse_softmax_backward_matches_jax_vjp():
    rng = np.random.RandomState(6)
    bn, hq, wq = 3, 3, 5
    qk = hq * wq
    tree = {"scores": rng.standard_normal((bn, qk, qk)),
            "mask": local_window_mask(hq, wq, 2, torch.float64).numpy()}
    ct = rng.standard_normal((bn, qk, qk))
    out, got = _torch_vjp(lambda tr: V.sab_sparse_softmax(
        tr["scores"], tr["mask"]), jax.tree.map(t, tree), [ct])
    assert out[0].grad_fn.name() == "SparseSoftmaxBackward"
    _, want = _jax_vjp(lambda tr: jvjp._sab_xla(tr["scores"], tr["mask"]),
                       tree, ct)
    _check_grads(got, want)


def test_attn_v_merge_backward_matches_jax_vjp():
    rng = np.random.RandomState(7)
    b, nf, hh, ww, ws, c = 2, 3, 2, 3, 2, 4
    hw, d = hh * ww, ws * ws * c
    a = rng.rand(b * nf, hw, hw) * (rng.rand(b * nf, hw, hw) > 0.5)
    tree = {"a": a, "v": [rng.standard_normal((b, hw, d)) for _ in range(nf)]}
    ct = rng.standard_normal((b * nf, hh * ws, ww * ws, c))
    out, got = _torch_vjp(lambda tr: V.sab_attn_v_merge(
        tr["a"], tr["v"], ws, hh * ws, ww * ws), jax.tree.map(t, tree), [ct])
    assert out[0].grad_fn.name() == "AttnVMergeBackward"
    jtree = {"a": a, "v": np.stack(tree["v"], 1).reshape(b * nf, hw, d)}
    _, want = _jax_vjp(lambda tr: jvjp._av_merge_xla(
        tr["a"], tr["v"], ws, hh * ws, ww * ws), jtree, ct)
    vg = np.asarray(want.pop(".v")).reshape(b, nf, hw, d)
    want.update({f".v[{i}]": vg[:, i] for i in range(nf)})
    _check_grads(got, want, F32_INSIDE)


# ---------------------------------------------------------------------------
# rows 13, 14: two stages, a run of channel blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["pair", "ra_gffw"])
def test_two_stage_backward_matches_jax_vjp(kind):
    rng = np.random.RandomState(8)
    r = rng.standard_normal
    c = 8

    def stage(e, mode):
        ch = 2 * e if mode == "gate" else e
        return dict(ln_w=1 + 0.2 * r(c), ln_b=r(c), w1=r((c, ch)) / 3,
                    b1=r(ch), wd=0.3 * r((3, 3, ch)), bd=r(ch),
                    w2=r((e, c)) / 3, b2=r(c), scale=r(c))

    def ffw():
        return dict(ln_w=1 + 0.2 * r(c), ln_b=r(c), w1=r((c, 2 * c)) / 3,
                    b1=r(2 * c), w2=r((2 * c, c)) / 4, b2=r(c), scale=r(c))

    modes = ("gelu", "gelu") if kind == "pair" else ("gelu", "gate")
    tree = {"x": r((2, 5, 4, c)), "st1": stage(12, modes[0]),
            "st2": stage(6, modes[1])}
    if kind == "pair":
        tree.update(ffw1=ffw(), ffw2=ffw())
    ct = r((2, 5, 4, c))

    def port(tr):
        return V.fused_two_stage(
            tr["x"], dict(tr["st1"], mode=modes[0]),
            dict(tr["st2"], mode=modes[1]), ffw1=tr.get("ffw1"),
            ffw2=tr.get("ffw2"))

    out, got = _torch_vjp(port, jax.tree.map(t, tree), [ct])
    assert out[0].grad_fn.name() == "TwoStageBackward"
    _, want = _jax_vjp(lambda tr: jvjp._two_stage_xla(tr["x"], tr, modes),
                       tree, ct)
    _check_grads(got, want)


def _channel_blocks(n, c=16, heads=2, seed=9):
    common = dict(attn_type="Channel", ffw_type="GFFW", dim=c,
                  num_heads=heads, ffn_expansion_factor=2.5, bias=False,
                  layernorm_bias=True, num_frames_tocache=2)
    jspec = JB.BlockSpec(kernels="xla", **common)
    rng = np.random.RandomState(seed)
    trees = [numpy_tree_like(JB.attn_block_init(jax.random.PRNGKey(0),
                                                jspec), rng)
             for _ in range(n)]
    blocks = []
    for tree in trees:
        blk = TB.TurtleAttnBlock(TB.BlockSpec(**common)).double()
        load_jax_params(blk, tree)
        blocks.append(blk)
    return jspec, trees, blocks


def test_channel_run_backward_matches_jax_vjp():
    """Gradients reach the blocks' parameters through run_weights, built
    inside the graph while autograd records."""
    jspec, trees, blocks = _channel_blocks(3)
    rng = np.random.RandomState(10)
    x = rng.standard_normal((2, 5, 6, 16))
    ct = rng.standard_normal(x.shape)
    xt = t(x).requires_grad_()
    out = V.fused_channel_gffw_run(xt, [b.run_weights() for b in blocks], 2)
    assert out.grad_fn.name() == "ChannelRunBackward"
    params = [p for b in blocks for p in b.parameters()]
    grads = torch.autograd.grad(out, [xt] + params, t(ct))
    _, pull = jax.vjp(lambda x_, ps: jvjp._channel_run_xla(
        x_, {"blocks": ps}, jspec), jnp.asarray(x),
        jax.tree.map(jnp.asarray, trees))
    gx, gps = pull(jnp.asarray(ct))
    close(grads[0], np.asarray(gx), ATOL64)
    it = iter(grads[1:])
    for blk, want in zip(blocks, gps):
        holder = TB.TurtleAttnBlock(blk.spec).double()
        with torch.no_grad():
            for p in holder.parameters():
                p.copy_(next(it))
        got = dict(_leaves(jax_tree_from_model(holder)))
        _check_grads(got, dict(_leaves(_np(want))))


# ---------------------------------------------------------------------------
# rows 8, 9: the lattice pair, each the other's gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ws,c", [(2, 8), (4, 3)])
def test_lattice_backward_is_the_jax_ops_vjp(ws, c):
    rng = np.random.RandomState(11)
    h, w = 4 * ws, 2 * ws
    x = rng.standard_normal((2, h, w, c))
    ct = rng.standard_normal((2, (h // ws) * (w // ws), ws * ws * c))
    xt = t(x).requires_grad_()
    tok = V.lattice_split(xt, ws)
    assert tok.grad_fn.name() == "LatticeSplitBackward"
    (gx,) = torch.autograd.grad(tok, xt, t(ct))
    _, pull = jax.vjp(lambda a: jlat.lattice_split_op(a, ws, True),
                      jnp.asarray(x, jnp.float32))
    close(gx, np.asarray(pull(jnp.asarray(ct, jnp.float32))[0]), 1e-6)
    tt = t(ct).requires_grad_()
    m = V.lattice_merge(tt, ws, h, w)
    assert m.grad_fn.name() == "LatticeMergeBackward"
    (gt,) = torch.autograd.grad(m, tt, t(x))
    _, pull = jax.vjp(lambda a: jlat.lattice_merge_op(a, ws, h, w, True),
                      jnp.asarray(ct, jnp.float32))
    close(gt, np.asarray(pull(jnp.asarray(x, jnp.float32))[0]), 1e-6)


def test_lattice_backward_runs_the_other_wrapper(monkeypatch):
    """The gradient of a split is one call of lattice_merge and nothing
    else of the pair, and the other way round; a gradient that arrives as a
    non-contiguous view is made contiguous first."""
    calls = []
    for name in ("lattice_split", "lattice_merge"):
        real = getattr(L, name)

        def spy(*a, _real=real, _name=name):
            calls.append((_name, a[0].is_contiguous()))
            return _real(*a)

        monkeypatch.setattr(L, name, spy)
    x = torch.randn(1, 4, 6, 8, dtype=torch.float64, requires_grad=True)
    tok = L.LatticeSplit.apply(x, 2)
    assert calls == [("lattice_split", True)]
    calls.clear()
    tok.sum().backward()  # an expanded (non-contiguous) gradient
    assert calls == [("lattice_merge", True)]
    calls.clear()
    t_ = torch.randn(1, 6, 32, dtype=torch.float64, requires_grad=True)
    m = L.LatticeMerge.apply(t_, 2, 4, 6)
    m.mean().backward()
    assert calls == [("lattice_merge", True), ("lattice_split", True)]


# ---------------------------------------------------------------------------
# every Function against finite differences
# ---------------------------------------------------------------------------


def _gradcheck_cases():
    m = Maker(12, torch.float64)
    c, e = 8, 6
    ffn = dict(ln_w=1 + 0.2 * m(c), ln_b=m(c), w1=m(c, 2 * e, scale=0.3),
               wd=m(3, 3, 2 * e, scale=0.3), w2=m(e, c, scale=0.3),
               x2=m(1, 3, 4, c), po_w=m(1, c, c, scale=0.3), mode="gate")
    chain = dict(ln_w=1 + 0.2 * m(c), ln_b=m(c), w1=m(c, 3 * c, scale=0.3),
                 wd=m(3, 3, 3 * c, scale=0.3))
    q = torch.nn.functional.normalize(m(1, 6, 8), dim=-1)
    k = torch.nn.functional.normalize(m(1, 2, 6, 8), dim=-1)
    st = dict(ln_w=1 + 0.2 * m(c), w1=m(c, e, scale=0.3),
              wd=m(3, 3, e, scale=0.3), w2=m(e, c, scale=0.3), mode="gelu")
    st2 = dict(ln_w=1 + 0.2 * m(c), w1=m(c, 2 * e, scale=0.3),
               wd=m(3, 3, 2 * e, scale=0.3), w2=m(e, c, scale=0.3),
               mode="gate")
    _, _, blocks = _channel_blocks(1, c=8, heads=2, seed=13)
    return {
        "ffn": (V.fused_block_ffn, (m(1, 3, 4, c),), ffn),
        "qkv_stats": (V.fused_qkv_stats, (m(1, 3, 4, c),),
                      dict(chain, heads=2)),
        "split_proj": (V.fused_ln_split_proj, (m(1, 3, 4, c),),
                       dict(chain, n_out=3)),
        "conv3x3": (V.fused_conv3x3, (m(1, 3, 4, c), m(3, 3, c, 4,
                                                      scale=0.3), m(4)), {}),
        "chm_stats": (V.fused_chm_stats, (m(1, 3, 4, c), m(1, 2, 3, 4, c)),
                      dict(ln_w=1 + 0.2 * m(c), w_qkv=m(c, 3 * c, scale=0.3),
                           wd_qkv=m(3, 3, 3 * c, scale=0.3),
                           w_kv=m(c, 2 * c, scale=0.3),
                           wd_kv=m(3, 3, 2 * c, scale=0.3), heads=2)),
        "sab_probs": (V.sab_attn_probs, (q, k, 1.5 + m(1)),
                      dict(grid_wq=3)),
        "attn_v_merge": (V.sab_attn_v_merge, (
            m(2, 6, 6).abs(), [m(1, 6, 4 * c), m(1, 6, 4 * c)], 2, 4, 6),
            {}),
        # the mask as bool: a 0/1 mask has no derivative at its zeros (a
        # nudge there adds the entry to the softmax's support)
        "sparse_softmax": (V.sab_sparse_softmax, (
            m(2, 6, 6), local_window_mask(2, 3, 1, torch.bool)), {}),
        "two_stage": (V.fused_two_stage, (m(1, 3, 4, c), st, st2), {}),
        "channel_run": (V.fused_channel_gffw_run, (
            m(1, 3, 4, c), [blocks[0].run_weights()], 2), {}),
    }


@pytest.mark.parametrize("name", ["ffn", "qkv_stats", "split_proj", "conv3x3",
                                  "chm_stats", "sab_probs", "attn_v_merge",
                                  "sparse_softmax", "two_stage",
                                  "channel_run"])
def test_function_passes_gradcheck(name):
    fn, args, kw = _gradcheck_cases()[name]
    leaves = []
    spec = V._flatten((args, kw), leaves)
    leaves = [a.detach().requires_grad_(a.is_floating_point())
              for a in leaves]
    fn_class = {"ffn": V.BlockFFN, "qkv_stats": V.QKVStats,
                "split_proj": V.SplitProj, "conv3x3": V.Conv3x3,
                "chm_stats": V.CHMStats, "sab_probs": V.SABProbs,
                "attn_v_merge": V.AttnVMerge,
                "sparse_softmax": V.SparseSoftmax, "two_stage": V.TwoStage,
                "channel_run": V.ChannelRun}[name]
    assert fn_class.apply(spec, *leaves) is not None
    assert torch.autograd.gradcheck(
        lambda *xs: fn_class.apply(spec, *xs), leaves, fast_mode=True)
    # the dispatcher takes the Function when autograd records
    a, k = V._unflatten(spec, leaves)
    out = fn(*a, **k)
    out = out[0] if isinstance(out, tuple) else out
    assert type(out.grad_fn).__name__ == fn_class.__name__ + "Backward"
