"""YAML option files — the public config surface.

Own copy of ``turtlevsr_tpu/config/options.py`` (the port imports nothing of
the JAX package); the compute-backend switch of that file is gone: on a CUDA
tensor the port always runs its hand-written kernels.

Keeps the exact key names of the reference option files
(options/*.yml, parsed by basicsr/utils/options.py:37-96) so
users can point this framework at their existing configs unchanged, but adds:

  * schema validation with helpful errors (the reference silently ignores
    unknown keys and crashes at runtime on bad attention-type strings via
    `print(...); exit()` — turtle_arch.py:713-715),
  * an alias map for the stale attention-type names shipped in
    Turtle_Denoise_Davis.yml ("MEST"->"CHM", "CTS"->"FHR"; the reference
    would exit() on these — SURVEY.md Q4),
  * a frozen, hashable `ModelConfig`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

import yaml

# Stale attention-type aliases found in shipped option files (SURVEY.md Q4).
ATTENTION_ALIASES = {"MEST": "CHM", "CTS": "FHR"}

ATTENTION_TYPES = ("Channel", "ReducedAttn", "FHR", "CHM", "NoAttn")
FFW_TYPES = ("FFW", "GFFW")

# model-name string (YAML `model:` key) -> variant tag
MODEL_VARIANTS = {
    "turtle_arch": "t0",
    "turtle_t1_arch": "t1",
    "turtlesuper_t1_arch": "sr",
    # tolerate the misspelled module name used by the reference eval script
    # (basicsr/inference.py:380 imports turtle_super_t1_arch, SURVEY.md Q3)
    "turtle_super_t1_arch": "sr",
}


class OptionsError(ValueError):
    pass


def load_options(path: str, is_train: bool = True) -> dict:
    """Parse an option YAML into a plain nested dict.

    Mirrors basicsr/utils/options.py:parse (ordered load, is_train flag,
    per-phase dataset annotation, path expansion) without the implicit
    experiments-dir side effects; those are handled by the trainer.
    """
    with open(path, "r") as f:
        opt = yaml.safe_load(f)
    if not isinstance(opt, dict):
        raise OptionsError(f"{path} did not parse to a mapping")

    opt["is_train"] = is_train
    opt.setdefault("scale", 1)
    opt.setdefault("rank", 0)
    opt.setdefault("world_size", 1)

    datasets = opt.get("datasets") or {}
    for phase, dopt in list(datasets.items()):
        if not isinstance(dopt, dict):
            continue
        phase_key = phase.split("_")[0]
        dopt["phase"] = phase_key
        dopt["scale"] = opt["scale"]
        for k in ("dataroot_gt", "dataroot_lq"):
            if dopt.get(k) is not None:
                dopt[k] = os.path.expanduser(dopt[k])

    for k in ("pretrain_network_g", "resume_state"):
        p = (opt.get("path") or {}).get(k)
        if isinstance(p, str):
            opt["path"][k] = os.path.expanduser(p)

    return opt


def _canon_attn(name: str, where: str) -> str:
    name = ATTENTION_ALIASES.get(name, name)
    if name not in ATTENTION_TYPES:
        raise OptionsError(
            f"unknown attention type {name!r} at {where}; "
            f"expected one of {ATTENTION_TYPES} (aliases: {ATTENTION_ALIASES})"
        )
    return name


def _canon_ffw(name: str, where: str) -> str:
    if name not in FFW_TYPES:
        raise OptionsError(
            f"unknown FFW type {name!r} at {where}; expected one of {FFW_TYPES}"
        )
    return name


@dataclass(frozen=True)
class LevelSpec:
    """One encoder/decoder/latent/refinement level of the Turtle U-Net."""

    dim: int
    num_blocks: int
    num_heads: int
    attn_type1: str
    attn_type2: str
    ffw_type: str
    num_frames_tocache: int
    scale_patchsize: int = 1  # SAB window_size = 2 * scale_patchsize
    # latent only: a third attention type for the final cached block
    attn_type3: Optional[str] = None


@dataclass(frozen=True)
class ModelConfig:
    """Frozen, hashable architecture description.

    Field names follow the reference option keys (turtle_arch.py:10-53) so a
    config round-trips transparently; `variant` selects the t0 / t1 / sr
    semantics (turtle_arch / turtle_t1_arch / turtlesuper_t1_arch).
    """

    variant: str  # "t0" | "t1" | "sr"
    inp_channels: int
    out_channels: int
    dim: int
    enc_blocks: Tuple[int, int, int]
    middle_blocks: int
    dec_blocks: Tuple[int, int, int]
    num_refinement_blocks: int
    num_heads: Tuple[int, int, int, int]
    ffn_expansion_factor: float
    bias: bool
    layernorm_bias: bool  # LayerNorm_type == "WithBias"
    use_both_input: bool
    num_frames_tocache: int

    enc1: LevelSpec = field(repr=False, default=None)
    enc2: LevelSpec = field(repr=False, default=None)
    enc3: LevelSpec = field(repr=False, default=None)
    latent: LevelSpec = field(repr=False, default=None)
    dec3: LevelSpec = field(repr=False, default=None)  # decoder_level3 (coarsest)
    dec2: LevelSpec = field(repr=False, default=None)
    dec1: LevelSpec = field(repr=False, default=None)  # decoder_level1 (finest)
    refinement: LevelSpec = field(repr=False, default=None)

    # input is padded so H and W are multiples of this (turtle_arch.py:966)
    padder_size: int = 32
    # sr variant: bilinear x4 upsample factor (turtlesuper_t1_arch.py:975-977)
    sr_scale: int = 4
    @property
    def level_dims(self) -> Tuple[int, int, int, int]:
        d = self.dim
        return (d, 2 * d, 4 * d, 8 * d)


def model_config_from_options(opt: dict) -> ModelConfig:
    """Build a ModelConfig from a parsed option dict.

    Mirrors make_model's option extraction (turtle_arch.py:10-53) plus the
    hard-coded wiring inside Turtle.__init__ (turtle_arch.py:855-966):
    per-level dims d/2d/4d/8d, decoder Scale_patchsize 2/4/8, and
    decoder_level1's num_frames_tocache forced to 2 (turtle_arch.py:950).
    """
    model_name = str(opt.get("model", "Turtle_t1_arch")).lower()
    if model_name not in MODEL_VARIANTS:
        raise OptionsError(
            f"unknown model {opt.get('model')!r}; expected one of "
            f"{sorted(set(MODEL_VARIANTS))}"
        )
    variant = MODEL_VARIANTS[model_name]

    def req(key):
        if key not in opt:
            raise OptionsError(f"option file missing required key {key!r}")
        return opt[key]

    dim = int(req("dim"))
    enc_blocks = tuple(int(x) for x in req("Enc_blocks"))
    middle_blocks = int(req("Middle_blocks"))
    dec_blocks = tuple(int(x) for x in req("Dec_blocks"))
    if len(enc_blocks) != 3 or len(dec_blocks) != 3:
        raise OptionsError("Enc_blocks / Dec_blocks must have exactly 3 entries")
    num_heads = tuple(int(x) for x in opt.get("num_heads", [1, 1, 1, 1]))
    if len(num_heads) != 4:
        raise OptionsError("num_heads must have exactly 4 entries")
    nftc = int(opt.get("num_frames_tocache", 1))
    ffn = float(opt.get("ffn_expansion_factor", 1))
    bias = bool(opt.get("bias", False))
    ln_bias = opt.get("LayerNorm_type", "WithBias") != "BiasFree"
    n_ref = int(opt.get("num_refinement_blocks", 1))

    def attn(key):
        return _canon_attn(str(req(key)), key)

    def ffw(key):
        return _canon_ffw(str(req(key)), key)

    d1, d2, d3, d4 = dim, dim * 2, dim * 4, dim * 8
    h1, h2, h3, h4 = num_heads

    enc1 = LevelSpec(d1, enc_blocks[0], h1, attn("encoder1_attn_type1"),
                     attn("encoder1_attn_type2"), ffw("encoder1_ffw_type"), nftc)
    enc2 = LevelSpec(d2, enc_blocks[1], h2, attn("encoder2_attn_type1"),
                     attn("encoder2_attn_type2"), ffw("encoder2_ffw_type"), nftc)
    enc3 = LevelSpec(d3, enc_blocks[2], h3, attn("encoder3_attn_type1"),
                     attn("encoder3_attn_type2"), ffw("encoder3_ffw_type"), nftc)
    latent = LevelSpec(d4, middle_blocks, h4, attn("latent_attn_type1"),
                       attn("latent_attn_type2"), ffw("latent_ffw_type"), nftc,
                       attn_type3=attn("latent_attn_type3"))
    # NOTE the reference's confusing naming: YAML decoder1_* configures
    # decoder_level3 (the coarsest decoder level) and so on
    # (turtle_arch.py:932-950).
    dec3 = LevelSpec(d3, dec_blocks[0], h3, attn("decoder1_attn_type1"),
                     attn("decoder1_attn_type2"), ffw("decoder1_ffw_type"), nftc,
                     scale_patchsize=2)
    dec2 = LevelSpec(d2, dec_blocks[1], h2, attn("decoder2_attn_type1"),
                     attn("decoder2_attn_type2"), ffw("decoder2_ffw_type"), nftc,
                     scale_patchsize=4)
    dec1 = LevelSpec(d1, dec_blocks[2], h1, attn("decoder3_attn_type1"),
                     attn("decoder3_attn_type2"), ffw("decoder3_ffw_type"),
                     num_frames_tocache=2,  # hard-coded in turtle_arch.py:950
                     scale_patchsize=8)
    refinement = LevelSpec(d1, n_ref, h1, attn("refinement_attn_type1"),
                           attn("refinement_attn_type2"),
                           ffw("refinement_ffw_type"), nftc)

    return ModelConfig(
        variant=variant,
        inp_channels=int(opt.get("n_colors", 3)),
        out_channels=int(opt.get("n_colors", 3)),
        dim=dim,
        enc_blocks=enc_blocks,
        middle_blocks=middle_blocks,
        dec_blocks=dec_blocks,
        num_refinement_blocks=n_ref,
        num_heads=num_heads,
        ffn_expansion_factor=ffn,
        bias=bias,
        layernorm_bias=ln_bias,
        use_both_input=bool(opt.get("use_both_input", False)),
        num_frames_tocache=nftc,
        enc1=enc1, enc2=enc2, enc3=enc3, latent=latent,
        dec3=dec3, dec2=dec2, dec1=dec1, refinement=refinement,
    )


def dict2str(opt: dict, indent_level: int = 1) -> str:
    """An option dict as the reference prints it (options.py:99-117)."""
    msg = "\n"
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_level * 2) + k + ":["
            msg += dict2str(v, indent_level + 1)
            msg += " " * (indent_level * 2) + "]\n"
        else:
            msg += " " * (indent_level * 2) + k + ": " + str(v) + "\n"
    return msg
