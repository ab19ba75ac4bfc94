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

Other block types (CHM, NoAttn, Channel/FHR with FFW) are not ported yet
and raise ``NotImplementedError`` when the block is built.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from turtlevsr_tpu_torch.core.cache import fhr_slot_append, token_valid_mask
from turtlevsr_tpu_torch.kernels.ffn import (
    fused_block_ffn,
    fused_ln_split_proj,
    fused_qkv_stats,
)
from turtlevsr_tpu_torch.ops.attn_utils import acc_dtype, masked_softmax
from turtlevsr_tpu_torch.ops.conv import conv2d

_NORM_EPS = 1e-12  # torch.nn.functional.normalize default clamp


@dataclass(frozen=True)
class BlockSpec:
    """Static per-block configuration."""

    attn_type: str  # Channel | ReducedAttn | FHR
    ffw_type: str  # FFW | GFFW
    dim: int
    num_heads: int
    ffn_expansion_factor: float
    bias: bool
    layernorm_bias: bool
    num_frames_tocache: int


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
    moved or written to."""

    _kw = None
    _kw_key = None

    def _make_kernel_weights(self) -> dict:
        raise NotImplementedError

    def kernel_weights(self) -> dict:
        key = tuple((p.data_ptr(), p._version, p.dtype, p.device)
                    for p in self.parameters())
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


def _safe_norms(ss: torch.Tensor) -> torch.Tensor:
    """max(sqrt(ss), 1e-12): zero rows (nothing to normalise) stay finite."""
    return torch.sqrt(ss).clamp_min(_NORM_EPS)


class TurtleAttnBlock(nn.Module, KernelWeights):
    """TurtleAttnBlock (turtle_arch.py:669-734): x + attn(norm1 x), then
    x + ffn(norm2 x), through the fused passes listed in the module note."""

    def __init__(self, spec: BlockSpec):
        super().__init__()
        t, f = spec.attn_type, spec.ffw_type
        if t not in ("Channel", "ReducedAttn", "FHR"):
            raise NotImplementedError(
                f"not ported yet: attention type {t!r} (the port serves "
                "Channel, ReducedAttn and FHR blocks)")
        if f not in ("FFW", "GFFW"):
            raise ValueError(f"unknown FFW type {f!r}")
        if t != "ReducedAttn" and f != "GFFW":
            raise NotImplementedError(
                f"not ported yet: {t} attention followed by {f}")
        self.spec = spec
        self.norm1 = LayerNorm(spec.dim, spec.layernorm_bias)
        self.norm2 = LayerNorm(spec.dim, spec.layernorm_bias)
        if t in ("Channel", "FHR"):  # the same projection stack
            self.attn = ChannelAttention(spec.dim, spec.num_heads, spec.bias)
        else:
            self.attn = ReducedAttn(spec.dim)
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
        a = self.attn
        if isinstance(a, ReducedAttn):
            kw["ra"] = dict(
                ln_w=self.norm1.body.weight, ln_b=self.norm1.body.bias,
                w1=pw_matrix(a.conv1), b1=a.conv1.bias, wd=dw_taps(a.conv2),
                bd=a.conv2.bias, w2=pw_matrix(a.conv3), b2=a.conv3.bias,
                scale=a.beta.reshape(c).contiguous(), mode="gelu")
        else:
            kw["qkv"] = dict(
                ln_w=self.norm1.body.weight, ln_b=self.norm1.body.bias,
                w1=pw_matrix(a.qkv), b1=a.qkv.bias, wd=dw_taps(a.qkv_dwconv),
                bd=a.qkv_dwconv.bias)
            kw["wpo"] = pw_matrix(a.project_out)  # (C_in, C_out)
        return kw

    # -- attention halves --------------------------------------------------
    def _channel_po(self, x: torch.Tensor, kw: dict):
        """Cacheless channel attention up to the per-batch matrix
        po' = blockdiag(attn^T) @ W_po: out @ W_po = v @ po'. Returns
        (v map, po' (B, C, C), po bias)."""
        b, _, _, c = x.shape
        heads = self.spec.num_heads
        ctok = c // heads
        v_map, gram, stats = fused_qkv_stats(x, heads=heads, **kw["qkv"])
        ad = acc_dtype(x.dtype)
        nq = _safe_norms(stats[:, 0].to(ad)).reshape(b, heads, ctok)
        nk = _safe_norms(stats[:, 1].to(ad)).reshape(b, heads, ctok)
        scores = gram.to(ad) / (nq[..., None] * nk[..., None, :])
        temp = self.attn.temperature.to(ad)[None]  # (1, heads, 1, 1)
        attn = masked_softmax(scores * temp).to(x.dtype)
        po_w = torch.einsum("bhcd,hce->bhde", attn.to(ad),
                            kw["wpo"].reshape(heads, ctok, c).to(ad))
        po_w = po_w.reshape(b, c, c).to(x.dtype).contiguous()
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
        nq = _safe_norms(torch.einsum("blhc,blhc->bhc", q, q))
        nk = _safe_norms(torch.einsum("blhc,blhc->bhc", k, k))
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

    def forward(self, x: torch.Tensor, slot: Optional[dict] = None):
        """(B, H, W, C) -> (same, new cache slot or None)."""
        kw = self.kernel_weights()
        t = self.spec.attn_type
        if t == "ReducedAttn":
            if "ffw2" in kw:  # the whole ReducedAttn+FFW block in one pass
                return fused_block_ffn(x, ffw2=kw["ffw2"], **kw["ra"]), None
            x = fused_block_ffn(x, **kw["ra"])
            return fused_block_ffn(x, **kw["ffn"]), None
        if t == "Channel":
            v_map, po_w, po_b = self._channel_po(x, kw)
            return fused_block_ffn(x, x2=v_map, po_w=po_w, po_b=po_b,
                                   **kw["ffn"]), None
        a, new_slot = self._fhr(x, kw, slot)
        return fused_block_ffn(x, x2=a.contiguous(), **kw["ffn"]), new_slot
