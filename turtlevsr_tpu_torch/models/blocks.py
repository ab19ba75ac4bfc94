"""The Turtle blocks of the serving path as ``nn.Module``s, NHWC.

Module and parameter names are the reference's (turtle_arch.py /
turtle_t1_arch.py), so its ``.pth`` state dicts load with
``load_state_dict``; parameters keep the reference's shapes (conv weights
OIHW, ``gamma``/``beta`` (1, C, 1, 1), ``temperature`` (heads, 1, 1)). The
``nn.Conv2d`` children only hold parameters: every block runs through the
fused functions of ``kernels/ffn.py`` (CUDA kernels on the card, their plain
versions on the CPU), wired like ``attn_block_apply`` of the JAX package
with its fused path taken:

  ReducedAttn + FFW   one FFN pass with the FFW chained inside
  ReducedAttn + GFFW  two FFN passes (gelu with scale=beta, then gate)
  Channel + GFFW      q/k/v statistics pass, a (heads, ctok, ctok) softmax,
                      po' = blockdiag(attn^T) @ W_po, then one FFN pass that
                      applies po' to the v map and adds the residual
  FHR + GFFW          split projection pass, history attention as plain
                      tensor products, project_out, then one FFN pass
  CHM + GFFW          the causal history model: the StateAlignBlock aligns
                      the cached frames to the current one (t1: q, k split
                      projection pass, the v chain as one composite 3x3 conv
                      with LayerNorm, the lattice split, the probabilities
                      kernel, attention @ v as plain matrix products, the
                      lattice merge; t0, whose scores are dead code: the
                      composite v conv, the lattice split and the merge of
                      [history | current]), one statistics pass over the
                      current map and the aligned frames, a small softmax,
                      and one FFN pass that takes the NF + 1 value maps with
                      the attention folded into per-map matrices. With
                      ``bias: true`` (no shipped configuration) the
                      projections keep their biases and the block takes the
                      unfolded route, as the JAX package does.

  NoAttn              the FFN pass alone
  Channel/FHR/CHM + FFW   the attention as above, then the pointwise FFW as
                      one FFN pass without a depthwise stage, which takes
                      the attention branch like the gated pass does (no
                      shipped configuration has such a block)

The fused plan (``fuse``, a tuple out of ``FUSE_PLANS``, empty by default)
chooses between hand-written kernels, never between a kernel and its plain
version: ``"attn_v_merge"`` lets a CHM block compute attention @ v and the
lattice merge in one launch (``sab_attn_v_merge``) instead of one matrix
product per ring position and a ``lattice_merge`` launch; ``"channel_runs"``
and ``"two_stage"`` are the levels' business (``models/turtle.py``): runs of
Channel+GFFW blocks go to ``fused_channel_gffw_run``, which reads
``run_weights`` of each block; pairs of ReducedAttn+FFW blocks and each
ReducedAttn+GFFW block go to ``fused_two_stage``, which reads the blocks'
``ra``, ``ffw2`` and ``ffn`` weights.

The blocks reach the kernels through ``kernels/vjp.py``: when autograd
records (training), each call is a Function whose backward runs autograd
through the kernel's plain version, the kernel-layout weights are built
inside the graph and not cached, the history rings are written out of
place (``core/cache.py``) and attention @ v makes no ``out=`` product.
Otherwise (serving) nothing of this runs: the wrappers are called as they
are, the layout copies are cached and the rings are written in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from turtlevsr_tpu_torch.core.cache import (
    fhr_slot_append,
    frame_valid_mask,
    sab_slot_append,
    sab_slot_append_v,
    token_valid_mask,
)
from turtlevsr_tpu_torch.kernels.level import channel_po, safe_norms
from turtlevsr_tpu_torch.kernels.vjp import (
    fused_block_ffn,
    fused_chm_stats,
    fused_conv3x3,
    fused_ln_split_proj,
    fused_qkv_stats,
    lattice_merge,
    lattice_split,
    records,
    sab_attn_probs,
    sab_attn_v_merge,
)
from turtlevsr_tpu_torch.ops.attn_utils import (
    acc_dtype,
    l2_normalize,
    masked_softmax,
)
from turtlevsr_tpu_torch.ops.conv import conv2d

FUSE_PLANS = ("channel_runs", "attn_v_merge", "two_stage")


def check_fuse(fuse) -> tuple:
    """The fused plan as a tuple of known names."""
    fuse = tuple(fuse or ())
    unknown = [f for f in fuse if f not in FUSE_PLANS]
    if unknown:
        raise ValueError(f"unknown fused plan {unknown}: choose out of "
                         f"{FUSE_PLANS}")
    return fuse


@dataclass(frozen=True)
class BlockSpec:
    """Static per-block configuration."""

    attn_type: str  # Channel | ReducedAttn | FHR | CHM
    ffw_type: str  # FFW | GFFW
    dim: int
    num_heads: int
    ffn_expansion_factor: float
    bias: bool
    layernorm_bias: bool
    num_frames_tocache: int
    scale_patchsize: int = 1
    variant: str = "t1"  # t0 | t1 (SR shares t1's blocks)

    @property
    def window_size(self) -> int:
        """Window of the StateAlignBlock (CHM blocks)."""
        return 2 * self.scale_patchsize


# kernel-layout views of conv parameters ------------------------------------


def pw_matrix(conv: nn.Conv2d) -> torch.Tensor:
    """1x1 conv weight (O, I, 1, 1) -> (I, O) matrix."""
    return conv.weight[:, :, 0, 0].t().contiguous()


def dw_taps(conv: nn.Conv2d) -> torch.Tensor:
    """depthwise 3x3 weight (CH, 1, 3, 3) -> (3, 3, CH)."""
    return conv.weight[:, 0].permute(1, 2, 0).contiguous()


def conv3_hwio(conv: nn.Conv2d) -> torch.Tensor:
    """dense 3x3 weight (O, I, 3, 3) -> (3, 3, I, O)."""
    return conv.weight.permute(2, 3, 1, 0).contiguous()


class KernelWeights:
    """Mixin of an ``nn.Module``: caches the kernel-layout copies of its
    parameters; they are rebuilt when a parameter is replaced, retyped,
    moved or written to. When autograd records, the copies are built inside
    the graph, each call anew, so that gradients reach the parameters."""

    _kw = None
    _kw_key = None

    def _make_kernel_weights(self) -> dict:
        raise NotImplementedError

    def kernel_weights(self) -> dict:
        params = list(self.parameters())
        if records(*params):
            return self._make_kernel_weights()
        key = tuple((p.data_ptr(), p._version, p.dtype, p.device)
                    for p in params)
        if key != self._kw_key:
            with torch.no_grad():
                self._kw = self._make_kernel_weights()
            self._kw_key = key
        return self._kw


class LayerNormBody(nn.Module):
    def __init__(self, dim: int, with_bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        if with_bias:
            self.bias = nn.Parameter(torch.zeros(dim))
        else:
            self.register_parameter("bias", None)


class LayerNorm(nn.Module):
    """Holder named like the reference's LayerNorm (``body.weight``)."""

    def __init__(self, dim: int, with_bias: bool):
        super().__init__()
        self.body = LayerNormBody(dim, with_bias)


class FeedForward(nn.Module):
    """NAFNet-style FFN (turtle_arch.py:184-213); conv biases always on,
    gamma zero-initialised."""

    def __init__(self, c: int):
        super().__init__()
        self.conv4 = nn.Conv2d(c, 2 * c, 1, bias=True)
        self.conv5 = nn.Conv2d(2 * c, c, 1, bias=True)
        self.gamma = nn.Parameter(torch.zeros(1, c, 1, 1))


class GatedFeedForward(nn.Module):
    """Restormer-style gated FFN (turtle_arch.py:162-181)."""

    def __init__(self, dim: int, ffn_expansion_factor: float, bias: bool):
        super().__init__()
        hidden = int(dim * ffn_expansion_factor)
        self.project_in = nn.Conv2d(dim, hidden * 2, 1, bias=bias)
        self.dwconv = nn.Conv2d(hidden * 2, hidden * 2, 3, padding=1,
                                groups=hidden * 2, bias=bias)
        self.project_out = nn.Conv2d(hidden, dim, 1, bias=bias)


class ReducedAttn(nn.Module):
    """NAFNet-ish conv token mixer (turtle_arch.py:627-665); biases on,
    beta zero-initialised."""

    def __init__(self, c: int, dw_expand: float = 2.0):
        super().__init__()
        dw = int(c * dw_expand)
        self.conv1 = nn.Conv2d(c, dw, 1, bias=True)
        self.conv2 = nn.Conv2d(dw, dw, 3, padding=1, groups=dw, bias=True)
        self.conv3 = nn.Conv2d(dw, c, 1, bias=True)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))


class ChannelAttention(nn.Module):
    """Projection stack of the transposed (channel-token) attention
    (turtle_arch.py:589-625); FrameHistoryRouter (:220-288) has the same."""

    def __init__(self, dim: int, heads: int, bias: bool):
        super().__init__()
        self.temperature = nn.Parameter(torch.ones(heads, 1, 1))
        self.qkv = nn.Conv2d(dim, dim * 3, 1, bias=bias)
        self.qkv_dwconv = nn.Conv2d(dim * 3, dim * 3, 3, padding=1,
                                    groups=dim * 3, bias=bias)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=bias)


class StateAlignBlock(nn.Module):
    """Projection stack of the windowed cross-frame alignment attention
    (turtle_t1_arch.py:290-310): one head, a scalar temperature; q2/k2 embed
    each window with a depthwise conv of kernel = stride = window."""

    def __init__(self, dim: int, bias: bool, window_size: int):
        super().__init__()
        ws = window_size
        self.temperature = nn.Parameter(torch.ones(1, 1, 1))
        self.qk = nn.Conv2d(dim, dim * 2, 1, bias=bias)
        self.qk_dwconv = nn.Conv2d(dim * 2, dim * 2, 3, padding=1,
                                   groups=dim * 2, bias=bias)
        self.v = nn.Conv2d(dim, dim, 1, bias=bias)
        self.v_dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim,
                                  bias=bias)
        self.k2 = nn.Conv2d(dim, dim * 2, 1, bias=bias)
        self.k2_dwconv = nn.Conv2d(dim * 2, dim * 2, ws, stride=ws, padding=1,
                                   groups=dim * 2, bias=bias)
        self.q2 = nn.Conv2d(dim, dim * 2, 1, bias=bias)
        self.q2_dwconv = nn.Conv2d(dim * 2, dim * 2, ws, stride=ws, padding=1,
                                   groups=dim * 2, bias=bias)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=bias)


class CausalHistoryModel(nn.Module):
    """CHM (turtle_arch.py:535-585): SAB alignment of the cached frames,
    then FHR-style routing of the current frame over them."""

    def __init__(self, dim: int, heads: int, bias: bool, window_size: int):
        super().__init__()
        self.spatial_aligner = StateAlignBlock(dim, bias, window_size)
        self.ChanAttn = ChannelAttention(dim, heads, bias)
        self.kv = nn.Conv2d(dim, dim * 2, 1, bias=bias)
        self.kv_dwconv = nn.Conv2d(dim * 2, dim * 2, 3, padding=1,
                                   groups=dim * 2, bias=bias)


def _patch_kernel(pw: nn.Conv2d, dw: nn.Conv2d) -> torch.Tensor:
    """1x1 conv then depthwise conv of kernel = stride = ws, folded into one
    (ws, ws, C, E) patch kernel: K[h, w, c, e] = W1[c, e] * wd[h, w, e]."""
    return (dw.weight[:, 0].permute(1, 2, 0)[:, :, None, :]
            * pw_matrix(pw)[None, None]).contiguous()


def _strided_patch_proj(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The SAB window embedding (1x1, then depthwise kernel = stride = ws,
    padding 1) as one patchify contraction: with stride == kernel the windows
    tile the image padded by one at the top and the left and cropped to
    (H, W). (B, H, W, C) -> (B, H / ws, W / ws, E). Bias-free only."""
    b, h, w, c = x.shape
    ws = kernel.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, 1, 0, 1, 0))[:, :h, :w]
    xw = xp.reshape(b, h // ws, ws, w // ws, ws, c)
    return torch.einsum("bihjwc,hwce->bije", xw, kernel.to(x.dtype))


class TurtleAttnBlock(nn.Module, KernelWeights):
    """TurtleAttnBlock (turtle_arch.py:669-734): x + attn(norm1 x), then
    x + ffn(norm2 x), through the fused passes listed in the module note."""

    def __init__(self, spec: BlockSpec, fuse=()):
        super().__init__()
        t, f = spec.attn_type, spec.ffw_type
        if t not in ("Channel", "ReducedAttn", "FHR", "CHM", "NoAttn"):
            raise ValueError(f"unknown attention type {t!r}")
        if f not in ("FFW", "GFFW"):
            raise ValueError(f"unknown FFW type {f!r}")
        self.spec = spec
        self.fuse = check_fuse(fuse)
        self.norm1 = LayerNorm(spec.dim, spec.layernorm_bias)
        self.norm2 = LayerNorm(spec.dim, spec.layernorm_bias)
        if t in ("Channel", "FHR"):  # the same projection stack
            self.attn = ChannelAttention(spec.dim, spec.num_heads, spec.bias)
        elif t == "CHM":
            self.attn = CausalHistoryModel(spec.dim, spec.num_heads,
                                           spec.bias, spec.window_size)
        elif t == "ReducedAttn":
            self.attn = ReducedAttn(spec.dim)
        else:  # NoAttn: the reference's block keeps no attention module
            self.attn = None
        if f == "GFFW":
            self.ffn = GatedFeedForward(spec.dim, spec.ffn_expansion_factor,
                                        spec.bias)
        else:
            self.ffn = FeedForward(spec.dim)

    # -- kernel-layout weights ------------------------------------------
    def _make_kernel_weights(self) -> dict:
        c = self.spec.dim
        kw = {}
        f = self.ffn
        if isinstance(f, GatedFeedForward):
            kw["ffn"] = dict(
                ln_w=self.norm2.body.weight, ln_b=self.norm2.body.bias,
                w1=pw_matrix(f.project_in), b1=f.project_in.bias,
                wd=dw_taps(f.dwconv), bd=f.dwconv.bias,
                w2=pw_matrix(f.project_out), b2=f.project_out.bias,
                mode="gate")
        else:
            kw["ffw2"] = dict(
                ln_w=self.norm2.body.weight, w1=pw_matrix(f.conv4),
                b1=f.conv4.bias, w2=pw_matrix(f.conv5), b2=f.conv5.bias,
                scale=f.gamma.reshape(c).contiguous())
            if self.norm2.body.bias is not None:
                kw["ffw2"]["ln_b"] = self.norm2.body.bias
            # the same FFW as a pass of its own: the chain without a
            # depthwise stage
            kw["ffn"] = dict(kw["ffw2"], ln_b=self.norm2.body.bias, wd=None,
                             mode="gelu")
        a = self.attn
        if a is None:
            return kw
        if isinstance(a, ReducedAttn):
            kw["ra"] = dict(
                ln_w=self.norm1.body.weight, ln_b=self.norm1.body.bias,
                w1=pw_matrix(a.conv1), b1=a.conv1.bias, wd=dw_taps(a.conv2),
                bd=a.conv2.bias, w2=pw_matrix(a.conv3), b2=a.conv3.bias,
                scale=a.beta.reshape(c).contiguous(), mode="gelu")
        elif isinstance(a, CausalHistoryModel):
            kw.update(self._chm_kernel_weights(a))
        else:
            kw["qkv"] = dict(
                ln_w=self.norm1.body.weight, ln_b=self.norm1.body.bias,
                w1=pw_matrix(a.qkv), b1=a.qkv.bias, wd=dw_taps(a.qkv_dwconv),
                bd=a.qkv_dwconv.bias)
            kw["wpo"] = pw_matrix(a.project_out)  # (C_in, C_out)
            if self.in_channel_run():
                kw["run"] = dict(
                    ln1_w=kw["qkv"]["ln_w"], ln1_b=kw["qkv"]["ln_b"],
                    w_qkv=kw["qkv"]["w1"], wd_qkv=kw["qkv"]["wd"],
                    temp=a.temperature.reshape(self.spec.num_heads),
                    wpo=kw["wpo"], ln2_w=kw["ffn"]["ln_w"],
                    ln2_b=kw["ffn"]["ln_b"], w1=kw["ffn"]["w1"],
                    wd=kw["ffn"]["wd"], w2=kw["ffn"]["w2"])
        return kw

    def in_channel_run(self) -> bool:
        """Whether the block may join a run of ``fused_channel_gffw_run``: a
        cacheless Channel + GFFW block whose convs carry no bias."""
        s = self.spec
        return (s.attn_type == "Channel" and s.ffw_type == "GFFW"
                and not s.bias)

    def run_weights(self) -> dict:
        """The block's weights as ``fused_channel_gffw_run`` takes them."""
        return self.kernel_weights()["run"]

    def _chm_kernel_weights(self, a: CausalHistoryModel) -> dict:
        sab, ca = a.spatial_aligner, a.ChanAttn
        ln = dict(ln_w=self.norm1.body.weight, ln_b=self.norm1.body.bias)
        dt = self.norm1.body.weight.dtype
        ad = acc_dtype(dt)
        kw = {"sab_ln": ln, "wpo": pw_matrix(ca.project_out)}
        if self.spec.bias:
            # the unfolded route: q, k and the unprojected v of the SAB from
            # one split projection, the kv embedding and the ChanAttn
            # projections as split projections with their biases
            def cat(*ts):
                return None if ts[0] is None else torch.cat(ts).contiguous()

            if self.spec.variant == "t0":  # the v chain alone
                kw["sab_v"] = dict(w1=pw_matrix(sab.v), b1=sab.v.bias,
                                   wd=dw_taps(sab.v_dwconv),
                                   bd=sab.v_dwconv.bias, **ln)
            else:
                kw["sab_qkv"] = dict(
                    w1=torch.cat([pw_matrix(sab.qk), pw_matrix(sab.v)],
                                 dim=1).contiguous(),
                    b1=cat(sab.qk.bias, sab.v.bias),
                    wd=torch.cat([dw_taps(sab.qk_dwconv),
                                  dw_taps(sab.v_dwconv)], dim=2).contiguous(),
                    bd=cat(sab.qk_dwconv.bias, sab.v_dwconv.bias), **ln)
            kw["kv"] = dict(w1=pw_matrix(a.kv), b1=a.kv.bias,
                            wd=dw_taps(a.kv_dwconv), bd=a.kv_dwconv.bias)
            kw["qkv"] = dict(w1=pw_matrix(ca.qkv), b1=ca.qkv.bias,
                             wd=dw_taps(ca.qkv_dwconv),
                             bd=ca.qkv_dwconv.bias, **ln)
            return kw
        # the bias-free chain project_out o v_dwconv o v as one dense 3x3
        # kernel K[t] = W_v diag(wd_v[t]) W_po, built in the accumulation
        # type and rounded to the map's type
        kw["sab_v3"] = torch.einsum(
            "im,tsm,mo->tsio", pw_matrix(sab.v).to(ad),
            dw_taps(sab.v_dwconv).to(ad),
            pw_matrix(sab.project_out).to(ad)).to(dt).contiguous()
        if self.spec.variant != "t0":  # the t0 scores are never computed
            kw["sab_qk"] = dict(w1=pw_matrix(sab.qk),
                                wd=dw_taps(sab.qk_dwconv), **ln)
            kw["sab_q2"] = _patch_kernel(sab.q2, sab.q2_dwconv)
            kw["sab_k2"] = _patch_kernel(sab.k2, sab.k2_dwconv)
        kw["chm"] = dict(w_qkv=pw_matrix(ca.qkv), wd_qkv=dw_taps(ca.qkv_dwconv),
                         w_kv=pw_matrix(a.kv), wd_kv=dw_taps(a.kv_dwconv),
                         **ln)
        return kw

    # -- attention halves --------------------------------------------------
    def _channel_po(self, x: torch.Tensor, kw: dict):
        """Cacheless channel attention up to the per-batch matrix
        po' = blockdiag(attn^T) @ W_po: out @ W_po = v @ po'. Returns
        (v map, po' (B, C, C), po bias)."""
        heads = self.spec.num_heads
        v_map, gram, stats = fused_qkv_stats(x, heads=heads, **kw["qkv"])
        po_w = channel_po(gram, stats, self.attn.temperature, kw["wpo"],
                          heads, x.dtype)
        return v_map, po_w, self.attn.project_out.bias

    def _fhr(self, x: torch.Tensor, kw: dict, slot: Optional[dict]):
        """Channel-token cross attention of the current frame over
        [history | current] keys and values (turtle_arch.py:220-288). The
        Gram is contracted straight from the maps and normalised by the
        token norms afterwards: (q/|q|).(k/|k|) = (q.k)/(|q||k|). History
        keys are stored normalised; masked history tokens are absent from
        the softmax. Returns (projected output map, new slot)."""
        b, h, w, c = x.shape
        heads = self.spec.num_heads
        ctok = c // heads
        l = h * w
        dt = x.dtype
        ad = acc_dtype(dt)
        q, k, v = fused_ln_split_proj(x, n_out=3, **kw["qkv"])
        q = q.reshape(b, l, heads, ctok).to(ad)
        k = k.reshape(b, l, heads, ctok).to(ad)
        v = v.reshape(b, l, heads, ctok)
        nq = safe_norms(torch.einsum("blhc,blhc->bhc", q, q))
        nk = safe_norms(torch.einsum("blhc,blhc->bhc", k, k))
        g = torch.einsum("blhc,blhd->bhcd", q, k)
        g = g / (nq[:, :, :, None] * nk[:, :, None, :])
        valid = None
        if slot is not None:
            n_frames = slot["k"].shape[2] // ctok
            gh = torch.einsum("blhc,bhdl->bhcd", q, slot["k"].to(ad))
            gh = gh / nq[:, :, :, None]
            scores = torch.cat([gh, g], dim=-1)
            hist_valid = token_valid_mask(slot["n"], n_frames, ctok)
            valid = torch.cat([hist_valid, torch.ones(
                ctok, dtype=torch.bool, device=x.device)])[None, None, None]
        else:
            scores = g
        temp = self.attn.temperature.to(ad)[None]
        attn = masked_softmax(scores * temp, valid).to(dt).to(ad)
        va = v.to(ad)
        if slot is not None:
            nh = slot["k"].shape[2]
            out = torch.einsum("bhcd,blhd->blhc", attn[..., nh:], va)
            out = out + torch.einsum("bhcd,bhdl->blhc", attn[..., :nh],
                                     slot["v"].to(ad))
        else:
            out = torch.einsum("bhcd,blhd->blhc", attn, va)
        out = out.to(dt).reshape(b, h, w, c)
        out = conv2d(out, self.attn.project_out.weight,
                     self.attn.project_out.bias)
        new_slot = None
        if slot is not None:
            k_cache = (k / nk[:, None]).to(dt).permute(0, 2, 3, 1)
            new_slot = fhr_slot_append(slot, k_cache, v.permute(0, 2, 3, 1))
        return out, new_slot

    def _sab(self, x: torch.Tensor, kw: dict, slot: Optional[dict]):
        """StateAlignBlock, t1 semantics (turtle_t1_arch.py:548-610): q and k
        are embedded per window into tokens of width 2C and l2-normalised,
        v is the lattice-windowed (projected) value map; every cached frame
        and the current one are attended with the top-5 + local-window
        clipped softmax and merged back into a map. Returns (aligned frames
        (B, NF, H, W, C), frame validity (NF,) bool, new slot)."""
        b, h, w, c = x.shape
        sab = self.attn.spatial_aligner
        ws = self.spec.window_size
        if h % ws or w % ws:
            raise ValueError(f"the SAB window {ws} must divide the map "
                             f"{h} x {w}")
        hq, wq = h // ws, w // ws
        if self.spec.bias:
            q_, k_, v_map = fused_ln_split_proj(x, n_out=3, **kw["sab_qkv"])
            k2 = conv2d(conv2d(k_, sab.k2.weight, sab.k2.bias),
                        sab.k2_dwconv.weight, sab.k2_dwconv.bias, stride=ws,
                        padding=1, groups=2 * c)
            q2 = conv2d(conv2d(q_, sab.q2.weight, sab.q2.bias),
                        sab.q2_dwconv.weight, sab.q2_dwconv.bias, stride=ws,
                        padding=1, groups=2 * c)
            if tuple(q2.shape[1:3]) != (hq, wq):  # a window of 2
                raise ValueError(
                    f"SAB window grid mismatch: the strided conv gives "
                    f"{q2.shape[1]}x{q2.shape[2]}, the lattice needs "
                    f"{hq}x{wq} (h={h}, w={w}, ws={ws})")
        else:
            q_, k_ = fused_ln_split_proj(x, n_out=2, **kw["sab_qk"])
            v_map = fused_conv3x3(x, kw["sab_v3"], **kw["sab_ln"])
            k2 = _strided_patch_proj(k_, kw["sab_k2"])
            q2 = _strided_patch_proj(q_, kw["sab_q2"])
        q = l2_normalize(q2.reshape(b, hq * wq, 2 * c)).contiguous()
        k = l2_normalize(k2.reshape(b, hq * wq, 2 * c))
        v = lattice_split(v_map.contiguous(), ws)  # (B, HW, ws * ws * C)

        if slot is not None:
            n_ring = slot["k"].shape[1]
            k_all = torch.cat([slot["k"].to(k.dtype), k[:, None]], dim=1)
            v_frames = [slot["v"][:, i] for i in range(n_ring)] + [v]
            fvalid = torch.cat([
                frame_valid_mask(slot["n"], n_ring),
                torch.ones(1, dtype=torch.bool, device=x.device)])
        else:
            k_all, v_frames = k[:, None].contiguous(), [v]
            fvalid = torch.ones(1, dtype=torch.bool, device=x.device)
        nf = len(v_frames)
        a = sab_attn_probs(q, k_all, sab.temperature, fvalid, grid_wq=wq)
        # the stacked copy of the ring's values with the current ones is
        # never made: every position is read where the ring stores it
        if "attn_v_merge" in self.fuse:
            # attention @ v and the lattice merge in one launch, straight
            # into the stacked maps that the FFN pass reads in place
            maps = sab_attn_v_merge(
                a.reshape(b * nf, hq * wq, hq * wq),
                [vi.to(x.dtype) for vi in v_frames], ws, h, w)
        else:
            # one matrix product per ring position, then the merge (autograd
            # takes no out= product: then the products are stacked)
            if records(a, *v_frames):
                out_tok = torch.stack([torch.matmul(a[:, i], vi.to(x.dtype))
                                       for i, vi in enumerate(v_frames)], 1)
            else:
                out_tok = torch.empty((b, nf) + tuple(v.shape[1:]),
                                      dtype=x.dtype, device=x.device)
                for i, vi in enumerate(v_frames):
                    torch.matmul(a[:, i], vi.to(x.dtype), out=out_tok[:, i])
            maps = lattice_merge(out_tok.reshape(b * nf, hq * wq, -1), ws, h,
                                 w)
        new_slot = None if slot is None else sab_slot_append(slot, k, v)
        if self.spec.bias:
            # unprojected values: project each frame, then zero the invalid
            # ones (their bias would not stay zero)
            maps = conv2d(maps, sab.project_out.weight, sab.project_out.bias)
            maps = maps.reshape(b, nf, h, w, c)
            maps = maps * fvalid.to(maps.dtype)[None, :, None, None, None]
            return maps.contiguous(), fvalid, new_slot
        # projected before the windowing and already zero where invalid:
        # the probabilities carry the frame validity
        return maps.reshape(b, nf, h, w, c), fvalid, new_slot

    def _sab_t0(self, x: torch.Tensor, kw: dict, slot: Optional[dict]):
        """StateAlignBlock, t0 semantics (turtle_arch.py:459-533): the
        attention scores are computed and then discarded by ``out = v``
        (quirk Q1 of SURVEY.md), so the aligned frames are the windowed
        projected values of [history | current] merged back into maps. The
        whole qk chain and the K ring writes are skipped, as the JAX package
        skips them; their parameters stay, so reference ``.pth`` files load
        strictly. Returns what :meth:`_sab` returns."""
        b, h, w, c = x.shape
        sab = self.attn.spatial_aligner
        ws = self.spec.window_size
        if h % ws or w % ws:
            raise ValueError(f"the SAB window {ws} must divide the map "
                             f"{h} x {w}")
        if self.spec.bias:
            (v_map,) = fused_ln_split_proj(x, n_out=1, **kw["sab_v"])
            v_map = conv2d(v_map, sab.project_out.weight,
                           sab.project_out.bias)
        else:
            v_map = fused_conv3x3(x, kw["sab_v3"], **kw["sab_ln"])
        v = lattice_split(v_map.contiguous(), ws)  # (B, HW, ws * ws * C)
        ones = torch.ones(1, dtype=torch.bool, device=x.device)
        if slot is not None:
            n_ring = slot["v"].shape[1]
            v_all = torch.cat([slot["v"].to(v.dtype), v[:, None]], dim=1)
            fvalid = torch.cat([frame_valid_mask(slot["n"], n_ring), ones])
            new_slot = sab_slot_append_v(slot, v)
        else:
            v_all, fvalid, new_slot = v[:, None], ones, None
        nf = v_all.shape[1]
        maps = lattice_merge(v_all.reshape(b * nf, *v.shape[1:]), ws, h, w)
        maps = maps.reshape(b, nf, h, w, c)
        return (maps * fvalid.to(maps.dtype)[None, :, None, None, None],
                fvalid, new_slot)

    def _chm(self, x: torch.Tensor, kw: dict, slot: Optional[dict]):
        """CausalHistoryModel + the block's FFN half (turtle_arch.py:535-585):
        channel-token attention of the current frame over the K, V
        embeddings of the aligned frames and its own. Returns (block output,
        new slot)."""
        b, h, w, c = x.shape
        heads = self.spec.num_heads
        ctok = c // heads
        l = h * w
        dt = x.dtype
        ad = acc_dtype(dt)
        ca = self.attn.ChanAttn
        sab = self._sab_t0 if self.spec.variant == "t0" else self._sab
        x_sp, fvalid, new_slot = sab(x, kw, slot)
        nf = x_sp.shape[1]
        if self.spec.bias:
            q, k, v = fused_ln_split_proj(x, n_out=3, **kw["qkv"])
            kh, vh = fused_ln_split_proj(x_sp.reshape(b * nf, h, w, c),
                                         n_out=2, **kw["kv"])
            q = q.reshape(b, l, heads, ctok).to(ad)
            k = k.reshape(b, l, heads, ctok).to(ad)
            kh = kh.reshape(b, nf, l, heads, ctok).to(ad)
            sq = torch.einsum("blhc,blhc->bhc", q, q)
            sk = torch.einsum("blhc,blhc->bhc", k, k)
            skh = torch.einsum("bnlhc,bnlhc->bnhc", kh, kh)
            g = torch.einsum("blhc,blhd->bhcd", q, k)
            gh = torch.einsum("blhc,bnlhd->bnhcd", q, kh)
        else:
            v, vh, g, gh, stats = fused_chm_stats(x, x_sp, heads=heads,
                                                  **kw["chm"])
            g, gh, stats = g.to(ad), gh.to(ad), stats.to(ad)
            sq = stats[:, 0].reshape(b, heads, ctok)
            sk = stats[:, 1].reshape(b, heads, ctok)
            skh = stats[:, 2:].reshape(b, nf, heads, ctok)
        nq, nk, nkh = safe_norms(sq), safe_norms(sk), safe_norms(skh)
        # (B, heads, ctok, NF, ctok): frame-major keys of the history
        gh = gh.permute(0, 2, 3, 1, 4) / (
            nq[:, :, :, None, None] * nkh.permute(0, 2, 1, 3)[:, :, None])
        g = g / (nq[..., None] * nk[..., None, :])
        scores = torch.cat([gh.reshape(b, heads, ctok, nf * ctok), g], dim=-1)
        valid = torch.cat([
            fvalid.repeat_interleave(ctok),
            torch.ones(ctok, dtype=torch.bool, device=x.device)])
        temp = ca.temperature.to(ad)[None]
        attn = masked_softmax(scores * temp, valid[None, None, None]).to(dt)
        a_h = attn[..., :nf * ctok].reshape(b, heads, ctok, nf, ctok).to(ad)
        a_c = attn[..., nf * ctok:].to(ad)
        if self.spec.bias:
            out = torch.einsum("bhcnd,bnlhd->blhc", a_h,
                               vh.reshape(b, nf, l, heads, ctok).to(ad))
            out = out + torch.einsum("bhcd,blhd->blhc", a_c,
                                     v.reshape(b, l, heads, ctok).to(ad))
            out = conv2d(out.to(dt).reshape(b, h, w, c),
                         ca.project_out.weight, ca.project_out.bias)
            return fused_block_ffn(x, x2=out.contiguous(),
                                   **kw["ffn"]), new_slot
        # the apply folded into the FFN pass: out @ W_po = sum_n vh_n @ P_n
        # + v @ P_c with P_n[(h, d), z] = sum_c a_h[h, c, n, d] W_po[(h, c), z]
        wpo = kw["wpo"].reshape(heads, ctok, c).to(ad)
        pn = torch.einsum("bhcnd,hcz->nbhdz", a_h, wpo).reshape(
            nf, b, c, c).to(dt)
        pc = torch.einsum("bhcd,hcz->bhdz", a_c, wpo).reshape(b, c, c).to(dt)
        return fused_block_ffn(x, x2=[vh, v], po_w=[*pn, pc],
                               **kw["ffn"]), new_slot

    def forward(self, x: torch.Tensor, slot: Optional[dict] = None):
        """(B, H, W, C) -> (same, new cache slot or None)."""
        kw = self.kernel_weights()
        t = self.spec.attn_type
        if t == "NoAttn":
            return fused_block_ffn(x, **kw["ffn"]), None
        if t == "ReducedAttn":
            if "ffw2" in kw:  # the whole ReducedAttn+FFW block in one pass
                return fused_block_ffn(x, ffw2=kw["ffw2"], **kw["ra"]), None
            x = fused_block_ffn(x, **kw["ra"])
            return fused_block_ffn(x, **kw["ffn"]), None
        if t == "Channel":
            v_map, po_w, po_b = self._channel_po(x, kw)
            return fused_block_ffn(x, x2=v_map, po_w=po_w, po_b=po_b,
                                   **kw["ffn"]), None
        if t == "CHM":
            return self._chm(x, kw, slot)
        a, new_slot = self._fhr(x, kw, slot)
        return fused_block_ffn(x, x2=a.contiguous(), **kw["ffn"]), new_slot
