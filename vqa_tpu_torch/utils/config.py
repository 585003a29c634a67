"""Model, inference and path configuration of the port.

Copies of ``PathConfig``/``PATHS``, ``ModelConfig``, ``InferenceConfig``,
``tiny_model_config`` and the dict round-trip of
``vqa_tpu/utils/config.py`` (same fields, same defaults), so configs and
checkpoint config dicts move between the two packages unchanged. The
training, mesh and kernel-toggle configs are not ported yet: the port's
kernels are not behind toggles.
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
    return d


def model_config_from_dict(d: dict) -> ModelConfig:
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    kwargs = {k: v for k, v in d.items() if k in known}
    for k in ("stage_channels", "blocks_per_stage"):
        if k in kwargs:
            kwargs[k] = tuple(kwargs[k])
    return ModelConfig(**kwargs)
