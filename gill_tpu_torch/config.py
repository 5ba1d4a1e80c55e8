"""Configuration dataclasses (counterpart of gill_tpu/config.py and of the
config classes that live in gill_tpu's jax-importing model modules).

`GILLConfig` round-trips the reference `model_args.json`. The SD configs
(`UNetConfig`, `VAEConfig`, `CLIPTextConfig`, `SchedulerConfig`,
`SDPipelineConfig`), `MapperConfig` and the `tiny_*_config()` helpers keep
the fields and defaults of their gill_tpu originals; a CPU test holds
`dataclasses.asdict` of each equal to the original. This package imports
nothing of gill_tpu, so the classes are declared here.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


# Known model-size ladder (reference: main.py:51-52). Sizes are architecture
# presets so no network access is needed: (hidden, ffn, layers, heads,
# word_embed_proj_dim, vocab).
OPT_PRESETS = {
    "facebook/opt-125m": dict(hidden_size=768, ffn_dim=3072, num_layers=12,
                              num_heads=12, word_embed_proj_dim=768,
                              vocab_size=50272, max_positions=2048,
                              do_layer_norm_before=True),
    "facebook/opt-350m": dict(hidden_size=1024, ffn_dim=4096, num_layers=24,
                              num_heads=16, word_embed_proj_dim=512,
                              vocab_size=50272, max_positions=2048,
                              do_layer_norm_before=False),
    "facebook/opt-1.3b": dict(hidden_size=2048, ffn_dim=8192, num_layers=24,
                              num_heads=32, word_embed_proj_dim=2048,
                              vocab_size=50272, max_positions=2048,
                              do_layer_norm_before=True),
    "facebook/opt-2.7b": dict(hidden_size=2560, ffn_dim=10240, num_layers=32,
                              num_heads=32, word_embed_proj_dim=2560,
                              vocab_size=50272, max_positions=2048,
                              do_layer_norm_before=True),
    "facebook/opt-6.7b": dict(hidden_size=4096, ffn_dim=16384, num_layers=32,
                              num_heads=32, word_embed_proj_dim=4096,
                              vocab_size=50272, max_positions=2048,
                              do_layer_norm_before=True),
    "facebook/opt-13b": dict(hidden_size=5120, ffn_dim=20480, num_layers=40,
                             num_heads=40, word_embed_proj_dim=5120,
                             vocab_size=50272, max_positions=2048,
                             do_layer_norm_before=True),
    "facebook/opt-30b": dict(hidden_size=7168, ffn_dim=28672, num_layers=48,
                             num_heads=56, word_embed_proj_dim=7168,
                             vocab_size=50272, max_positions=2048,
                             do_layer_norm_before=True),
    "facebook/opt-66b": dict(hidden_size=9216, ffn_dim=36864, num_layers=64,
                             num_heads=72, word_embed_proj_dim=9216,
                             vocab_size=50272, max_positions=2048,
                             do_layer_norm_before=True),
    # tiny preset for tests / CI smoke of the full load_gill path
    "test/opt-tiny": dict(hidden_size=16, ffn_dim=32, num_layers=2,
                          num_heads=2, word_embed_proj_dim=16,
                          vocab_size=300, max_positions=96,
                          do_layer_norm_before=True),
}

CLIP_VISION_PRESETS = {
    "openai/clip-vit-base-patch16": dict(hidden_size=768, intermediate_size=3072,
                                         num_layers=12, num_heads=12,
                                         image_size=224, patch_size=16),
    "openai/clip-vit-base-patch32": dict(hidden_size=768, intermediate_size=3072,
                                         num_layers=12, num_heads=12,
                                         image_size=224, patch_size=32),
    "openai/clip-vit-large-patch14": dict(hidden_size=1024, intermediate_size=4096,
                                          num_layers=24, num_heads=16,
                                          image_size=224, patch_size=14),
    "test/clip-tiny": dict(hidden_size=16, intermediate_size=32,
                           num_layers=1, num_heads=2, image_size=16,
                           patch_size=8),
}


@dataclasses.dataclass
class OPTConfig:
    """Architecture of an OPT decoder (frozen backbone)."""
    vocab_size: int = 50272
    hidden_size: int = 4096
    ffn_dim: int = 16384
    num_layers: int = 32
    num_heads: int = 32
    word_embed_proj_dim: int = 4096
    max_positions: int = 2048
    do_layer_norm_before: bool = True
    layer_norm_eps: float = 1e-5
    # Learned positional embeddings are offset by 2 (HF OPT convention).
    position_offset: int = 2

    @classmethod
    def from_name(cls, name: str, vocab_size: Optional[int] = None) -> "OPTConfig":
        if name not in OPT_PRESETS:
            raise ValueError(f"Unknown OPT preset {name!r}")
        kw = dict(OPT_PRESETS[name])
        if vocab_size is not None:
            kw["vocab_size"] = vocab_size
        return cls(**kw)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass
class CLIPVisionConfig:
    """Architecture of a CLIP ViT vision tower (frozen backbone)."""
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_name(cls, name: str) -> "CLIPVisionConfig":
        if name not in CLIP_VISION_PRESETS:
            raise ValueError(f"Unknown CLIP vision preset {name!r}")
        return cls(**CLIP_VISION_PRESETS[name])

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + [CLS]


@dataclasses.dataclass
class GILLConfig:
    """Model hyperparameters; round-trips reference `model_args.json`.

    Mirrors GILLArgs (reference gill/models.py:21-37) plus the extra keys
    found in shipped checkpoints ("share_ret_gen", "norm_image_embed").
    """
    opt_version: str = "facebook/opt-6.7b"
    visual_encoder: str = "openai/clip-vit-large-patch14"
    freeze_lm: bool = True
    freeze_vm: bool = True
    n_visual_tokens: int = 4
    task: str = "captioning"
    ret_emb_dim: int = 256
    gen_emb_dim: int = 768
    text_emb_layers: Tuple[int, ...] = (-1,)
    gen_token_idx: Tuple[int, ...] = (0,)
    retrieval_token_idx: Tuple[int, ...] = (0,)
    text_fc_mode: str = "gill_mapper"
    ret_text_fc_mode: str = "linear"
    num_tokens: int = 8
    num_clip_tokens: int = 77
    share_ret_gen: bool = True
    norm_image_embed: str = "none"

    # TPU-native extras (not in the reference; safe defaults keep JSON compat).
    max_len: int = 32                 # training sequence length (captions)
    image_size: int = 224

    def to_json(self, path: Optional[str] = None) -> str:
        d = dataclasses.asdict(self)
        # Serialize in the reference's format (lists, not tuples).
        for k in ("text_emb_layers", "gen_token_idx", "retrieval_token_idx"):
            d[k] = list(d[k])
        s = json.dumps(d, indent=4)
        if path is not None:
            with open(path, "w") as f:
                f.write(s)
        return s

    @classmethod
    def from_json(cls, path_or_str: str) -> "GILLConfig":
        if path_or_str.lstrip().startswith("{"):
            d = json.loads(path_or_str)
        else:
            with open(path_or_str) as f:
                d = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in d.items():
            if k not in known:
                continue  # forward/backward compat: ignore unknown keys
            if k in ("text_emb_layers", "gen_token_idx", "retrieval_token_idx"):
                v = tuple(v)
            kw[k] = v
        return cls(**kw)

    @property
    def opt(self) -> OPTConfig:
        return OPTConfig.from_name(self.opt_version)

    @property
    def vision(self) -> CLIPVisionConfig:
        return CLIPVisionConfig.from_name(self.visual_encoder)


@dataclasses.dataclass
class TrainConfig:
    """Trainer flags (reference: main.py argparse); the fields and defaults
    of gill_tpu's `TrainConfig`."""
    dataset: str = "cc3m"
    val_dataset: str = "cc3m"
    dataset_dir: str = "datasets"
    image_dir: str = "data/"
    log_base_dir: str = "./runs"
    exp_name: str = "gill_tpu"

    epochs: int = 10
    steps_per_epoch: int = 2000
    start_epoch: int = 0
    val_steps_per_epoch: int = -1
    batch_size: int = 200
    val_batch_size: Optional[int] = None
    lr: float = 1e-3
    lr_warmup_steps: int = 2000
    lr_schedule_step_size: int = 5       # epochs between LR decays
    lr_schedule_gamma: float = 0.1
    grad_accumulation_steps: int = 1
    grad_clip: float = 1.0
    precision: str = "bf16"              # fp32 | bf16
    cap_loss_scale: float = 1.0
    ret_loss_scale: float = 1.0
    gen_loss_scale: float = 1.0
    concat_captions_prob: float = 0.5
    input_prompt: str = "A picture of"
    max_len: int = 32
    beta1: float = 0.9
    beta2: float = 0.95
    weight_decay: float = 0.01
    print_freq: int = 10
    resume: str = ""
    evaluate: bool = False
    seed: Optional[int] = None
    workers: int = 4

    # Recompute each frozen-LM layer in the backward of the train forwards
    # instead of keeping its activations (models/opt.py forward(remat=)).
    remat: bool = False

    # Mesh layout (data, model); the port trains on one device, and the
    # CLI refuses sizes above 1.
    dp_size: int = -1
    tp_size: int = 1

    def to_json(self, path: Optional[str] = None) -> str:
        s = json.dumps(dataclasses.asdict(self), indent=4)
        if path is not None:
            with open(path, "w") as f:
                f.write(s)
        return s

    @classmethod
    def from_json(cls, path_or_str: str) -> "TrainConfig":
        if path_or_str.lstrip().startswith("{"):
            d = json.loads(path_or_str)
        else:
            with open(path_or_str) as f:
                d = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


# ---------------------------------------------------------------------------
# adapter and Stable Diffusion configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MapperConfig:
    in_dim: int
    out_dim: int
    num_input_tokens: int = 1
    num_output_tokens: int = 1
    mode: str = "linear"          # 'linear' | 'gill_mapper'
    hidden_dim: int = 512
    num_heads: int = 4
    ffn_dim: int = 2048
    num_encoder_layers: int = 4
    num_decoder_layers: int = 4
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    num_heads: int = 8
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D")
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D")
    norm_groups: int = 32
    freq_shift: int = 0
    flip_sin_to_cos: bool = True

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


def tiny_unet_config() -> UNetConfig:
    return UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                      cross_attention_dim=24, num_heads=2,
                      down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                      up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                      norm_groups=8)


@dataclasses.dataclass
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32


def tiny_vae_config() -> VAEConfig:
    return VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                     norm_groups=4)


@dataclasses.dataclass
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407


@dataclasses.dataclass
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    steps_offset: int = 1
    set_alpha_to_one: bool = False
    prediction_type: str = "epsilon"


@dataclasses.dataclass
class SDPipelineConfig:
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    text: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig)
    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig)
    vae_scale: int = 8
    default_size: int = 512


def tiny_sd_config() -> SDPipelineConfig:
    return SDPipelineConfig(
        unet=tiny_unet_config(),
        vae=tiny_vae_config(),
        text=CLIPTextConfig(vocab_size=600, hidden_size=24,
                            intermediate_size=48, num_layers=2,
                            num_heads=2, max_positions=16,
                            eos_token_id=513),
        vae_scale=2, default_size=16)
