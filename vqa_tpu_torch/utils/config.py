"""Model, inference and path configuration of the port.

Copies of ``PathConfig``/``PATHS``, ``ModelConfig``, ``TrainingConfig``,
``InferenceConfig``, ``MeshConfig``, ``tiny_model_config`` and the dict
round-trip of ``vqa_tpu/utils/config.py`` (same fields, same defaults), so
configs and checkpoint config dicts move between the two packages
unchanged. ``DecoderConfig``, the port's own, extends ``ModelConfig``
with the decoder tower's fields (the JAX package has no such model). The
kernel-toggle config is not ported: the port's kernels are not behind
toggles.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Tuple

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclass
class PathConfig:
    """Filesystem layout, relative to the repository (counterpart of
    ``vqa_tpu.utils.config.PathConfig``); the serving CLI's default
    ``--checkpoint-dir`` is ``PATHS.checkpoint_dir``."""

    data_root: str = os.path.join(_REPO_ROOT, "data_store")
    # VQA v2 layout
    questions_file: str = "questions.json"
    annotations_file: str = "annotations.json"
    images_dir: str = "images"
    # artifacts
    checkpoint_dir: str = os.path.join(_REPO_ROOT, "checkpoints")
    log_dir: str = os.path.join(_REPO_ROOT, "logs")
    tokenizer_file: str = "tokenizer.json"
    answer_vocab_file: str = "answer_vocab.json"

    def __post_init__(self):
        for d in (self.checkpoint_dir, self.log_dir):
            os.makedirs(d, exist_ok=True)

    @property
    def questions_path(self) -> str:
        return os.path.join(self.data_root, self.questions_file)

    @property
    def annotations_path(self) -> str:
        return os.path.join(self.data_root, self.annotations_file)

    @property
    def images_path(self) -> str:
        return os.path.join(self.data_root, self.images_dir)

    @property
    def tokenizer_path(self) -> str:
        return os.path.join(self.checkpoint_dir, self.tokenizer_file)

    @property
    def answer_vocab_path(self) -> str:
        return os.path.join(self.checkpoint_dir, self.answer_vocab_file)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (counterpart of
    ``vqa_tpu.utils.config.ModelConfig``)."""

    # image encoder
    image_size: int = 224
    in_channels: int = 3
    base_channels: int = 64
    # None derives the (1, 2, 4, 8)·base_channels ramp in __post_init__
    stage_channels: Tuple[int, int, int, int] = None
    blocks_per_stage: Tuple[int, int, int, int] = (2, 2, 2, 2)
    feature_spatial_size: int = 7  # 224 / 32
    use_se_attention: bool = True
    use_spatial_attention: bool = True
    se_reduction: int = 16
    spatial_kernel_size: int = 7

    # text encoder
    vocab_size: int = 10000
    embed_dim: int = 256
    num_transformer_layers: int = 4
    num_attention_heads: int = 8
    ffn_hidden_dim: int = 1024
    max_question_length: int = 20
    pad_idx: int = 0

    # fusion
    num_cross_layers: int = 2
    use_gating: bool = True
    def __post_init__(self):
        if self.stage_channels is None:
            object.__setattr__(  # frozen dataclass
                self,
                "stage_channels",
                tuple(self.base_channels * m for m in (1, 2, 4, 8)),
            )

    # answer head
    num_answers: int = 1000
    answer_hidden_dim: int = 512  # embed_dim * 2
    answer_dropout: float = 0.3

    dropout: float = 0.1


@dataclass(frozen=True)
class DecoderConfig(ModelConfig):
    """A ``ModelConfig`` whose fusion tower is a DeepSeek-V3 style decoder
    over the image tokens, then the question's (``models/decoder.py``):
    the backbone, ``vocab_size``, ``max_question_length`` and the answer
    head's fields are read as the reference model reads them, the text
    encoder's and the cross-attention's are not. The names in comments are
    the published ``config.json``'s."""

    fusion: str = "decoder"             # the sidecar's mark of this class
    decoder_hidden: int = 2048          # hidden_size
    decoder_layers: int = 27            # num_hidden_layers
    decoder_heads: int = 16             # num_attention_heads
    decoder_dense_layers: int = 1       # first_k_dense_replace
    decoder_ffn_dim: int = 11264        # intermediate_size
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 800000.0
    rms_norm_eps: float = 1e-5
    moe_intermediate_size: int = 1408
    router_experts: int = 64            # n_routed_experts: the router's outputs
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    routed_scaling_factor: float = 2.446
    # this rank's routed experts: [expert_offset, expert_offset + experts_held)
    experts_held: int = 64
    expert_offset: int = 0
    # layers (0-based) whose attention is Kimi Delta Attention, a gated
    # delta-rule linear attention (``models/decoder.py:KDA``); the others
    # take MLA. ``linear_attn_config``'s ``kda_layers`` count from 1.
    kda_layers: Tuple[int, ...] = ()
    kda_heads: int = 32                 # linear_attn_config.num_heads
    kda_head_dim: int = 128             # linear_attn_config.head_dim
    short_conv_kernel_size: int = 4
    # MLA without a rotary embedding: its rope dims are used as they are
    mla_use_nope: bool = False


@dataclass
class TrainingConfig:
    """Training hyperparameters (counterpart of
    ``vqa_tpu.utils.config.TrainingConfig``, field for field).

    ``use_bf16`` asks for bf16 compute where the device is the card (the
    JAX trainer's TPU), f32 elsewhere; ``remat`` is ``"none"``, ``"full"``
    or ``"stages"`` (``training/train.py``)."""

    num_samples: int = 25000
    train_split: float = 0.8
    batch_size: int = 32
    eval_batch_size: int = 64
    seed: int = 42

    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    min_lr: float = 1e-6
    # linear warmup before the cosine (0 = cosine only)
    warmup_epochs: int = 2
    # "step": the cosine decays every optimizer step; "epoch": constant
    # within an epoch, stepped once per epoch
    lr_schedule_granularity: str = "step"

    num_epochs: int = 30
    label_smoothing: float = 0.0
    # microbatches per optimizer step, gradients averaged
    grad_accum: int = 1
    remat: str = "none"
    grad_clip_norm: float = 1.0
    early_stop_patience: int = 10
    checkpoint_every: int = 5
    log_interval: int = 50

    use_bf16: bool = True


@dataclass
class InferenceConfig:
    """Inference/serving settings (counterpart of
    ``vqa_tpu.utils.config.InferenceConfig``)."""

    top_k: int = 5
    confidence_threshold: float = 0.1
    host: str = "0.0.0.0"
    port: int = 8000
    max_batch_size: int = 32
    batch_timeout_ms: float = 5.0
    batch_buckets: Tuple[int, ...] = (1, 4, 16, 32)
    max_request_batch: int = 128
    max_body_mb: int = 256


@dataclass
class MeshConfig:
    """Parallelism settings (counterpart of ``vqa_tpu.utils.config.MeshConfig``):
    the degrees of the (data, model) grid of ranks that
    ``vqa_tpu_torch.parallel.mesh_from_config`` builds."""

    data_axis: str = "data"
    model_axis: str = "model"
    # -1 = every rank (or device) not taken by model_parallel goes to data
    data_parallel: int = -1
    model_parallel: int = 1


PATHS = PathConfig()


def tiny_model_config() -> ModelConfig:
    """The shared `--tiny` model of smoke runs and CPU tests."""
    return ModelConfig(
        vocab_size=1000, embed_dim=32, num_answers=16,
        num_transformer_layers=1, num_attention_heads=2,
        ffn_hidden_dim=64, max_question_length=8, image_size=64,
        base_channels=8, stage_channels=(8, 16, 32, 64),
        feature_spatial_size=2,
    )


def model_config_dict(cfg: ModelConfig) -> dict:
    """Serialize a ModelConfig (tuples as lists) for checkpoint sidecars."""
    d = dataclasses.asdict(cfg)
    d["stage_channels"] = list(d["stage_channels"])
    d["blocks_per_stage"] = list(d["blocks_per_stage"])
    if "kda_layers" in d:
        d["kda_layers"] = list(d["kda_layers"])
    return d


def model_config_from_dict(d: dict) -> ModelConfig:
    """The ModelConfig of a sidecar's dict: a ``DecoderConfig`` where it says
    ``fusion: decoder``."""
    cls = DecoderConfig if d.get("fusion") == "decoder" else ModelConfig
    known = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in d.items() if k in known}
    for k in ("stage_channels", "blocks_per_stage", "kda_layers"):
        if k in kwargs:
            kwargs[k] = tuple(kwargs[k])
    return cls(**kwargs)
