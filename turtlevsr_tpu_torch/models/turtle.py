"""The Turtle U-Net assembly (t0, t1 and SR variants) as an ``nn.Module``,
NHWC.

3-level encoder + latent + 3-level decoder with skip concatenation, channel
reduction, refinement and a global residual head (turtle_arch.py:855-1063,
turtlesuper_t1_arch.py:932-1150), mirroring ``turtlevsr_tpu/models/turtle.py``.
The 8 cache slots are a tuple

  (enc1, enc2, enc3, latent_first, latent_last, dec3, dec2, dec1)

in which a slot is ``None`` when the level's cached block keeps no history
(Channel, ReducedAttn), an FHR slot in the latent and a SAB slot where the
level ends in a CHM block (the decoder levels of every shipped
configuration; in the t0 variant its K field is a vestigial zero buffer).
The SR variant upsamples its input x4 (bilinear) before the model's pad, adds
the upsampled current frame as its global residual and returns (4H, 4W).

``fuse`` is the fused plan (see ``models/blocks.py``), empty by default.
With ``"channel_runs"`` a level hands every run of two or more consecutive
cacheless Channel+GFFW blocks with bias-free convs to
``fused_channel_gffw_run`` (one launch a run), as ``level_block_apply`` and
``latent_block_apply`` of the JAX package do under their opt-in; the other
blocks, and single such blocks, keep the split kernels. With
``"two_stage"`` a conv-only level (attn_type1 and attn_type2 ReducedAttn,
C a multiple of 16 up to 128) hands each pair of ReducedAttn+FFW blocks and
each ReducedAttn+GFFW block to ``fused_two_stage`` (one launch each; an odd
last FFW block takes the single pass), as the JAX package's
``TURTLE_CHAIN2`` opt-in does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from turtlevsr_tpu_torch.config.options import LevelSpec, ModelConfig
from turtlevsr_tpu_torch.core.cache import fhr_slot_init, sab_slot_init
from turtlevsr_tpu_torch.kernels.chain2 import two_stage_supported
from turtlevsr_tpu_torch.kernels.vjp import (
    fused_channel_gffw_run,
    fused_conv3x3,
    fused_two_stage,
)
from turtlevsr_tpu_torch.models.blocks import (
    BlockSpec,
    KernelWeights,
    TurtleAttnBlock,
    check_fuse,
    conv3_hwio,
)
from turtlevsr_tpu_torch.ops.conv import conv2d, conv_init
from turtlevsr_tpu_torch.ops.resize import (
    pixel_shuffle,
    pixel_unshuffle,
    upsample_bilinear,
)


class Conv3x3(nn.Conv2d, KernelWeights):
    """3x3 pad-1 conv through the fused kernel; an ``nn.Conv2d`` for its
    parameters (reference shapes and names), never for its forward."""

    def __init__(self, cin: int, cout: int, bias: bool):
        super().__init__(cin, cout, 3, padding=1, bias=bias)

    def _make_kernel_weights(self) -> dict:
        return {"weight": conv3_hwio(self)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_conv3x3(x, self.kernel_weights()["weight"], self.bias)


class Downsample(nn.Module):
    """conv3x3 C -> C/2 then PixelUnshuffle(2): 2C at H/2."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(Conv3x3(n_feat, n_feat // 2, bias=False))

    def forward(self, x):
        return pixel_unshuffle(self.body(x), 2)


class Upsample(nn.Module):
    """conv3x3 C -> 2C then PixelShuffle(2): C/2 at 2H."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(Conv3x3(n_feat, n_feat * 2, bias=False))

    def forward(self, x):
        return pixel_shuffle(self.body(x), 2)


def _block_spec(cfg: ModelConfig, lvl: LevelSpec, attn_type: str) -> BlockSpec:
    return BlockSpec(
        attn_type=attn_type, ffw_type=lvl.ffw_type, dim=lvl.dim,
        num_heads=lvl.num_heads,
        ffn_expansion_factor=cfg.ffn_expansion_factor, bias=cfg.bias,
        layernorm_bias=cfg.layernorm_bias,
        num_frames_tocache=lvl.num_frames_tocache,
        scale_patchsize=lvl.scale_patchsize,
        variant="t0" if cfg.variant == "t0" else "t1")


def apply_cacheless(blocks, x, fuse=()):
    """Apply consecutive cacheless blocks. Under the ``channel_runs`` plan
    every run of two or more blocks that may join one
    (``TurtleAttnBlock.in_channel_run``) is one launch of the run kernel."""
    blocks = list(blocks)
    i = 0
    while i < len(blocks):
        j = i
        if "channel_runs" in fuse:
            while j < len(blocks) and blocks[j].in_channel_run():
                j += 1
        if j - i >= 2:
            x = fused_channel_gffw_run(
                x, [b.run_weights() for b in blocks[i:j]],
                blocks[i].spec.num_heads)
            i = j
        else:
            x, _ = blocks[i](x, None)
            i += 1
    return x


def apply_conv_level(blocks, x):
    """The blocks of a conv-only level under the ``two_stage`` plan: each
    pair of ReducedAttn+FFW blocks and each ReducedAttn+GFFW block is one
    launch of the two-stage kernel; an odd last FFW block takes the single
    pass."""
    blocks = list(blocks)
    i = 0
    while i < len(blocks):
        kw = blocks[i].kernel_weights()
        if blocks[i].spec.ffw_type == "GFFW":
            x = fused_two_stage(x, kw["ra"], kw["ffn"])
            i += 1
        elif i + 1 < len(blocks):
            kw2 = blocks[i + 1].kernel_weights()
            x = fused_two_stage(x, kw["ra"], kw2["ra"], ffw1=kw["ffw2"],
                                ffw2=kw2["ffw2"])
            i += 2
        else:
            x, _ = blocks[i](x, None)
            i += 1
    return x


class LevelBlock(nn.Module):
    """LevelBlock (turtle_arch.py:736-788): blocks 0..n-2 use attn_type1
    (cacheless), the last uses attn_type2 with the level's cache slot."""

    def __init__(self, cfg: ModelConfig, lvl: LevelSpec, fuse=()):
        super().__init__()
        self.fuse = check_fuse(fuse)
        self.transformer_blocks = nn.ModuleList(
            TurtleAttnBlock(_block_spec(
                cfg, lvl,
                lvl.attn_type2 if i == lvl.num_blocks - 1 else lvl.attn_type1),
                self.fuse)
            for i in range(lvl.num_blocks))
        # a level of ReducedAttn blocks only, at a width the two-stage
        # kernel takes
        self.conv_only = (lvl.attn_type1 == lvl.attn_type2 == "ReducedAttn"
                          and two_stage_supported(lvl.dim))

    def forward(self, x, slot: Optional[dict] = None):
        blocks = self.transformer_blocks
        last = blocks[-1]
        if "two_stage" in self.fuse and self.conv_only:
            return apply_conv_level(blocks, x), None
        if last.spec.attn_type not in ("FHR", "CHM"):
            # a cacheless last block may close a run
            return apply_cacheless(blocks, x, self.fuse), None
        x = apply_cacheless(blocks[:-1], x, self.fuse)
        return last(x, slot)


class LatentCacheBlock(nn.Module):
    """LatentCacheBlock (turtle_arch.py:790-851): first block attn_type1
    (cache slot A), middle attn_type2 (cacheless), last attn_type3 (slot B).
    Needs >= 2 blocks."""

    def __init__(self, cfg: ModelConfig, lvl: LevelSpec, fuse=()):
        super().__init__()
        if lvl.num_blocks < 2:
            raise ValueError("LatentCacheBlock needs at least 2 blocks")
        self.fuse = check_fuse(fuse)
        types = ([lvl.attn_type1] + [lvl.attn_type2] * (lvl.num_blocks - 2)
                 + [lvl.attn_type3])
        self.transformer_blocks = nn.ModuleList(
            TurtleAttnBlock(_block_spec(cfg, lvl, t), self.fuse)
            for t in types)

    def forward(self, x, slot_a: Optional[dict], slot_b: Optional[dict]):
        blocks = self.transformer_blocks
        x, new_a = blocks[0](x, slot_a)
        x = apply_cacheless(blocks[1:-1], x, self.fuse)
        x, new_b = blocks[-1](x, slot_b)
        return x, new_a, new_b


def padded_hw(cfg: ModelConfig, height: int, width: int) -> Tuple[int, int]:
    """Input H, W after the model's internal pad to a multiple of 32
    (turtle_arch.py:1058-1063); for the SR variant after the x4 upsample
    that comes first (turtlesuper_t1_arch.py:1063-1070)."""
    if cfg.variant == "sr":
        height, width = height * cfg.sr_scale, width * cfg.sr_scale
    p = cfg.padder_size
    return (height + (p - height % p) % p, width + (p - width % p) % p)


def _slot_for_level(cfg: ModelConfig, lvl: LevelSpec, attn_type: str,
                    batch: int, h: int, w: int, dtype, device):
    """Cache-slot zeros for one cached block, or None for cacheless types.
    A t0 SAB slot's K field is a vestigial (B, NF, 8, 8) zero buffer: the
    attention it would feed is dead code (quirk Q1 of SURVEY.md)."""
    if attn_type == "FHR":
        ctok = lvl.dim // lvl.num_heads
        return fhr_slot_init(batch, lvl.num_heads, lvl.num_frames_tocache,
                             ctok, h * w, dtype, device)
    if attn_type == "CHM":
        ws = 2 * lvl.scale_patchsize
        hw = (h // ws) * (w // ws)
        hw_q, dk = (8, 8) if cfg.variant == "t0" else (hw, 2 * lvl.dim)
        return sab_slot_init(batch, lvl.num_frames_tocache, hw_q, dk, hw,
                             ws * ws * lvl.dim, dtype, device)
    return None


def init_cache(cfg: ModelConfig, batch: int, height: int, width: int,
               dtype: torch.dtype = torch.float32,
               device: torch.device | str = "cuda") -> tuple:
    """Empty (zero, count-0) cache tuple for input frames of (height, width),
    the RAW frame size fed to the model (the low-resolution size for the SR
    variant). Slot order matches the reference's k_cached[0..7]
    (turtle_arch.py:989-1048)."""
    hp, wp = padded_hw(cfg, height, width)
    sizes = [(hp // s, wp // s) for s in (1, 2, 4, 8)]
    plan = [
        (cfg.enc1, cfg.enc1.attn_type2, 0), (cfg.enc2, cfg.enc2.attn_type2, 1),
        (cfg.enc3, cfg.enc3.attn_type2, 2),
        (cfg.latent, cfg.latent.attn_type1, 3),
        (cfg.latent, cfg.latent.attn_type3, 3),
        (cfg.dec3, cfg.dec3.attn_type2, 2), (cfg.dec2, cfg.dec2.attn_type2, 1),
        (cfg.dec1, cfg.dec1.attn_type2, 0),
    ]
    return tuple(_slot_for_level(cfg, lvl, t, batch, *sizes[s], dtype,
                                 device) for lvl, t, s in plan)


class Turtle(nn.Module):
    """Turtle_arch (t0), Turtle_t1_arch (t1) and Turtlesuper_t1_arch (SR);
    child names are the reference's."""

    def __init__(self, cfg: ModelConfig, fuse=()):
        super().__init__()
        if cfg.variant not in ("t0", "t1", "sr"):
            raise ValueError(f"unknown model variant {cfg.variant!r}")
        self.cfg = cfg
        self.fuse = fuse = check_fuse(fuse)
        inp_ch = cfg.inp_channels * (2 if cfg.use_both_input else 1)
        d1, d2, d3, d4 = cfg.level_dims
        self.input_projection = Conv3x3(inp_ch, d1, bias=cfg.bias)
        self.encoder_level1 = LevelBlock(cfg, cfg.enc1, fuse)
        self.down1_2 = Downsample(d1)
        self.encoder_level2 = LevelBlock(cfg, cfg.enc2, fuse)
        self.down2_3 = Downsample(d2)
        self.encoder_level3 = LevelBlock(cfg, cfg.enc3, fuse)
        self.down3_4 = Downsample(d3)
        self.latent = LatentCacheBlock(cfg, cfg.latent, fuse)
        self.up4_3 = Upsample(d4)
        self.reduce_chan_level3 = nn.Conv2d(d4, d3, 1, bias=cfg.bias)
        self.decoder_level3 = LevelBlock(cfg, cfg.dec3, fuse)
        self.up3_2 = Upsample(d3)
        self.reduce_chan_level2 = nn.Conv2d(d3, d2, 1, bias=cfg.bias)
        self.decoder_level2 = LevelBlock(cfg, cfg.dec2, fuse)
        self.up2_1 = Upsample(d2)
        self.reduce_chan_level1 = nn.Conv2d(d2, d1, 1, bias=cfg.bias)
        self.decoder_level1 = LevelBlock(cfg, cfg.dec1, fuse)
        self.refinement = LevelBlock(cfg, cfg.refinement, fuse)
        self.ending = Conv3x3(d1, cfg.out_channels, bias=True)

    def init_cache(self, batch: int, height: int, width: int,
                   dtype: Optional[torch.dtype] = None) -> tuple:
        p = self.ending.weight
        return init_cache(self.cfg, batch, height, width,
                          dtype or p.dtype, p.device)

    @staticmethod
    def _reduce(conv: nn.Conv2d, a, b):
        """reduce_chan 1x1 over concat([a, b]) (turtle_arch.py:1008-1010)."""
        return conv2d(torch.cat([a, b], dim=-1), conv.weight, conv.bias)

    def forward(self, x_pair: torch.Tensor, cache: tuple):
        """One frame step. x_pair: (B, 2, H, W, C) = [previous, current]
        frames, NHWC, [0, 1]; cache: 8 slots from init_cache or a previous
        step (its FHR and SAB slots are written in place, but out of place
        when autograd records). Returns (out (B,
        H, W, C), new cache); (B, 4H, 4W, C) for the SR variant, whose frames
        are upsampled x4 (bilinear) before the pad. Mirrors Turtle.forward
        (turtle_arch.py:968-1056, turtlesuper_t1_arch.py:1063-1150)."""
        cfg = self.cfg
        if x_pair.dim() != 5 or x_pair.shape[1] != 2:
            raise ValueError(
                "x_pair must stack [previous, current] on axis 1")
        hp, wp = padded_hw(cfg, *x_pair.shape[2:4])
        # the previous frame only where the model reads it
        frames = x_pair[:, :2] if cfg.use_both_input else x_pair[:, 1:]
        if cfg.variant == "sr":
            b, n = frames.shape[:2]
            frames = upsample_bilinear(frames.flatten(0, 1), cfg.sr_scale)
            frames = frames.unflatten(0, (b, n))
        h0, w0 = frames.shape[2:4]
        if hp != h0 or wp != w0:
            frames = F.pad(frames, (0, 0, 0, wp - w0, 0, hp - h0))
        cur = frames[:, -1].contiguous()
        inp = (torch.cat([frames[:, 0], cur], dim=-1).contiguous()
               if cfg.use_both_input else cur)

        x = self.input_projection(inp)
        out_enc1, s0 = self.encoder_level1(x, cache[0])
        x = self.down1_2(out_enc1)
        out_enc2, s1 = self.encoder_level2(x, cache[1])
        x = self.down2_3(out_enc2)
        out_enc3, s2 = self.encoder_level3(x, cache[2])
        x = self.down3_4(out_enc3)

        latent, s3, s4 = self.latent(x, cache[3], cache[4])

        x = self.up4_3(latent)
        x = self._reduce(self.reduce_chan_level3, x, out_enc3)
        out_dec3, s5 = self.decoder_level3(x, cache[5])
        x = self.up3_2(out_dec3)
        x = self._reduce(self.reduce_chan_level2, x, out_enc2)
        out_dec2, s6 = self.decoder_level2(x, cache[6])
        x = self.up2_1(out_dec2)
        x = self._reduce(self.reduce_chan_level1, x, out_enc1)
        out_dec1, s7 = self.decoder_level1(x, cache[7])
        out_dec1, _ = self.refinement(out_dec1, None)

        out = self.ending(out_dec1) + cur
        return out[:, :h0, :w0, :], (s0, s1, s2, s3, s4, s5, s6, s7)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str = "cuda",
                dtype: torch.dtype = torch.float32, fuse=()) -> Turtle:
    """A Turtle with freshly drawn parameters: every conv as
    ``torch.nn.Conv2d.reset_parameters`` draws it (U(+-1/sqrt(fan_in)) for
    weight and bias) from the given CPU generator, LN weights one and biases
    zero, gamma/beta zero, temperature one: the statistics of the JAX
    package's ``init_params``."""
    model = Turtle(cfg, fuse)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            conv_init(m, generator)
    return model.to(device=device, dtype=dtype)
