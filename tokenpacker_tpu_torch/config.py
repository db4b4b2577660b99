"""Configuration dataclasses (counterpart of `tokenpacker_tpu/config.py`).

The same fields and defaults as the JAX package, without JAX: `dtype` is
a `torch.dtype`. Only what the serving paths read is here, with the
released-checkpoint preset table; the HF `config.json` round trip waits
for the checkpoint loader.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from tokenpacker_tpu_torch.constants import CLIP_RAW_GRID


@dataclass(frozen=True)
class VisionConfig:
    """CLIP ViT tower; defaults = openai/clip-vit-large-patch14-336."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    select_layer: int = -2  # penultimate hidden state
    multi_layers: tuple[int, ...] = (12, 16, 22, 23)
    select_feature: str = "patch"  # drop CLS

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid**2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def multi_dim(self) -> int:
        return self.hidden_size * len(self.multi_layers)


@dataclass(frozen=True)
class ProjectorConfig:
    """TokenPacker projector."""

    raw_grid: int = CLIP_RAW_GRID
    embed_dim: int = 1024
    num_heads: int = 8
    kv_dim: int = 1024
    kv_input_dim: int = 4096
    hidden_size: int = 4096
    scale_factor: int = 2  # {2,3,4} -> 144/64/36 tokens
    ln_eps: float = 1e-6

    def __post_init__(self):
        if self.raw_grid % self.scale_factor != 0:
            raise ValueError("scale_factor must divide raw_grid")

    @property
    def grid_size(self) -> int:
        return self.raw_grid // self.scale_factor

    @property
    def num_queries(self) -> int:
        return self.grid_size**2


@dataclass(frozen=True)
class LMConfig:
    """Decoder-only LM; defaults = Vicuna-7B-v1.5."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int | None = None  # None => MHA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: int = 0
    tie_word_embeddings: bool = False
    model_family: str = "llama"  # "llama" | "mpt"
    alibi: bool = False
    no_bias: bool = True

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class TokenPackerVLMConfig:
    """The composed model. `TokenPackerVLMConfig()` is TokenPacker-7b:
    ViT-L/14-336, projector s=2 (144 tokens), Vicuna-7B."""

    vision: VisionConfig = field(default_factory=VisionConfig)
    lm: LMConfig = field(default_factory=LMConfig)
    scale_factor: int = 2
    patch_num: int = 9
    image_aspect_ratio: str = "pad"
    mm_projector_type: str = "tokenpacker"
    mm_use_im_start_end: bool = False
    mm_use_im_patch_token: bool = False
    tune_mm_mlp_adapter: bool = False
    model_max_length: int = 2048
    dtype: torch.dtype = torch.bfloat16

    @property
    def projector(self) -> ProjectorConfig:
        return ProjectorConfig(
            raw_grid=self.vision.grid,
            embed_dim=self.vision.hidden_size,
            kv_dim=self.vision.hidden_size,
            kv_input_dim=self.vision.multi_dim,
            hidden_size=self.lm.hidden_size,
            scale_factor=self.scale_factor,
        )

    @property
    def tokens_per_view(self) -> int:
        return (self.vision.grid // self.scale_factor) ** 2


def vicuna_13b() -> LMConfig:
    """Vicuna-13B-v1.5 geometry (TokenPacker-13b checkpoints)."""
    return LMConfig(
        hidden_size=5120,
        intermediate_size=13824,
        num_hidden_layers=40,
        num_attention_heads=40,
    )


# Named presets of the released checkpoint family; patch_num applies to
# the HD variants only.
MODEL_PRESETS: dict[str, dict] = {
    "tokenpacker-7b-144token": dict(scale_factor=2),
    "tokenpacker-7b-64token": dict(scale_factor=3),
    "tokenpacker-7b-36token": dict(scale_factor=4),
    "tokenpacker-13b-144token": dict(scale_factor=2, lm_preset="13b"),
    "tokenpacker-hd-7b-9patch-144token": dict(
        scale_factor=2, patch_num=9, image_aspect_ratio="slice"
    ),
    "tokenpacker-hd-13b-9patch-144token": dict(
        scale_factor=2, patch_num=9, image_aspect_ratio="slice", lm_preset="13b"
    ),
    "tokenpacker-hd-13b-16patch-144token": dict(
        scale_factor=2, patch_num=16, image_aspect_ratio="slice", lm_preset="13b"
    ),
    "tokenpacker-hd-13b-16patch-64token": dict(
        scale_factor=3, patch_num=16, image_aspect_ratio="slice", lm_preset="13b"
    ),
    "tokenpacker-hd-13b-16patch-36token": dict(
        scale_factor=4, patch_num=16, image_aspect_ratio="slice", lm_preset="13b"
    ),
}


def preset_config(name: str) -> TokenPackerVLMConfig:
    """A config from a released-checkpoint preset name (case-insensitive;
    `sunshine-lwt/TokenPacker-*` naming, a leading org path is dropped)."""
    key = name.lower().lstrip("/").split("/")[-1]
    if key not in MODEL_PRESETS:
        raise KeyError(f"unknown preset {name!r}; known: {sorted(MODEL_PRESETS)}")
    spec = dict(MODEL_PRESETS[key])
    lm = vicuna_13b() if spec.pop("lm_preset", None) == "13b" else LMConfig()
    return TokenPackerVLMConfig(lm=lm, **spec)


def tiny_vlm_config(**overrides) -> TokenPackerVLMConfig:
    """The tiny geometry every CPU parity test runs on (same numbers as the
    JAX package's `tiny_vlm_config`)."""
    vision = VisionConfig(
        hidden_size=32,
        intermediate_size=64,
        num_hidden_layers=4,
        num_attention_heads=4,
        image_size=56,
        patch_size=14,
        multi_layers=(1, 2, 3, 4),
    )
    lm = LMConfig(
        vocab_size=256,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        max_position_embeddings=512,
    )
    base = dict(vision=vision, lm=lm, scale_factor=2, dtype=torch.float32)
    base.update(overrides)
    return TokenPackerVLMConfig(**base)
