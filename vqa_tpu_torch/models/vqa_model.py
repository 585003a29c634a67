"""The complete VQA model: CNN + text encoder + fusion + answer head.

Counterpart of ``vqa_tpu/models/vqa_model.py``. Images come in NHWC
[B, S, S, 3], as in the JAX package. The module tree reproduces the
reference state_dict layout that ``vqa_tpu.compat.torch_export`` emits
(``image_encoder.stem.0.weight`` … ``answer_head.classifier.6.bias``), so
an exported checkpoint loads with ``strict=True``.

``create_vqa_model`` builds on ``device="cuda"`` by default and raises when
no CUDA device is present; the CPU is used only when asked for. The
backbone's activations are in ``torch.channels_last`` memory (the stem
kernel writes NHWC and the convs keep that layout). Weights are initialised
from a seeded ``torch.Generator`` on the CPU with the JAX package's schemes
(Kaiming-normal fan-out convs, Xavier-uniform attention and answer head,
LeCun-normal other dense layers, N(0, d^-1/2) embeddings with a zero PAD
row, N(0, 0.02) position embeddings), then moved to the device.

``dtype`` is the JAX model's compute dtype (``vqa_model.py:151``): f32, or
bf16 for inference (``models/layers.py``: parameters stay f32 in the
state_dict, every Linear/Conv/Embedding computes from a bf16 copy of its
weights made at build or load, norms take f32 statistics, the stem, SE and
cross-attention kernels run their bf16 forms, and the logits are f32).
Training a bf16 model is not ported: ``train()`` raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from vqa_tpu_torch.models.cnn_backbone import CustomResNet
from vqa_tpu_torch.models.fusion import MultimodalFusion, attention_visualization
from vqa_tpu_torch.models.layers import COMPUTE_DTYPES, Linear
from vqa_tpu_torch.models.text_encoder import TransformerTextEncoder
from vqa_tpu_torch.utils.config import ModelConfig


class AnswerHead(nn.Module):
    """3-layer MLP classifier 256→512→256→1000 with ReLU + Dropout(0.3)."""

    def __init__(self, input_dim: int, hidden_dim: int, num_answers: int,
                 dropout: float = 0.3):
        super().__init__()
        self.classifier = nn.Sequential(
            Linear(input_dim, hidden_dim), nn.ReLU(), nn.Dropout(dropout),
            Linear(hidden_dim, hidden_dim // 2), nn.ReLU(), nn.Dropout(dropout),
            Linear(hidden_dim // 2, num_answers),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(x)


class VQAModel(nn.Module):
    """``logits, aux = model(images, token_ids, mask, return_aux=...)`` with
    images [B, H, W, 3] NHWC f32 (normalized), cast to the compute dtype
    as the JAX model's first conv casts them; logits are f32."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        cfg = self.config = config
        self.dtype = torch.float32
        # weights loaded into a bf16 model refresh its bf16 copies
        self.register_load_state_dict_post_hook(VQAModel._refresh_copies)
        self.image_encoder = CustomResNet(
            in_channels=cfg.in_channels, base_channels=cfg.base_channels,
            stage_channels=tuple(cfg.stage_channels),
            num_blocks=tuple(cfg.blocks_per_stage), use_se=cfg.use_se_attention,
            use_spatial=cfg.use_spatial_attention, se_reduction=cfg.se_reduction,
        )
        self.text_encoder = TransformerTextEncoder(
            vocab_size=cfg.vocab_size, embed_dim=cfg.embed_dim,
            num_layers=cfg.num_transformer_layers, num_heads=cfg.num_attention_heads,
            ffn_hidden_dim=cfg.ffn_hidden_dim, max_length=cfg.max_question_length,
            dropout=cfg.dropout,
        )
        self.fusion = MultimodalFusion(
            image_channels=cfg.stage_channels[-1],
            image_spatial_size=cfg.feature_spatial_size, embed_dim=cfg.embed_dim,
            num_heads=cfg.num_attention_heads, num_cross_layers=cfg.num_cross_layers,
            dropout=cfg.dropout, use_gating=cfg.use_gating,
        )
        self.answer_head = AnswerHead(
            cfg.embed_dim, cfg.embed_dim * 2, cfg.num_answers, cfg.answer_dropout)

    def _refresh_copies(self, _incompatible_keys) -> None:
        self.set_compute_dtype(self.dtype)

    def set_compute_dtype(self, dtype: torch.dtype) -> "VQAModel":
        """Compute in ``dtype`` (f32 or bf16) from now on: (re)make every
        layer's copy of its weights in it from the current f32 weights."""
        if dtype not in COMPUTE_DTYPES:
            raise ValueError(f"the port computes in float32 or bfloat16, got {dtype}")
        if dtype != torch.float32 and self.training:
            raise NotImplementedError(
                "training in bf16 is not ported (ROADMAP A.7b); train in float32")
        self.dtype = dtype
        for m in self.modules():
            if m is not self and hasattr(m, "set_compute_dtype"):
                m.set_compute_dtype(dtype)
        return self

    def train(self, mode: bool = True) -> "VQAModel":
        if mode and self.dtype != torch.float32:
            raise NotImplementedError(
                "training in bf16 is not ported (ROADMAP A.7b); build the model in float32")
        return super().train(mode)

    def forward(self, images: torch.Tensor, token_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                return_aux: bool = False):
        image_features = self.image_encoder(images.to(self.dtype))
        text_features, text_pooled = self.text_encoder(token_ids, attention_mask)
        fused, fusion_aux = self.fusion(image_features, text_features, attention_mask)
        # logits always f32 for a stable softmax
        logits = self.answer_head(fused).float()
        if return_aux:
            aux = {
                "image_features": image_features,
                "text_features": text_features,
                "text_pooled": text_pooled,
                "fused": fused,
                **fusion_aux,
            }
            return logits, aux
        return logits, None


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises for CUDA without a card.

    A bare ``"cuda"`` becomes the current device with its index, so a
    thread that later uses the result (whose own current device is 0) still
    lands on the same card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on an NVIDIA GPU "
            "unless device='cpu' is asked for")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@torch.no_grad()
def init_parameters(model: VQAModel, generator: torch.Generator) -> None:
    """Seeded initialisation with the JAX package's schemes (see the module
    docstring). Runs on the CPU; call before moving the model."""

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    def xavier(p):
        fan_out, fan_in = p.shape
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)

    pad_idx = model.config.pad_idx
    for name, p in model.named_parameters():
        parts = name.split(".")
        if p.dim() == 4:  # conv OIHW: Kaiming normal, fan_out = O·kh·kw
            normal(p, math.sqrt(2.0 / (p.shape[0] * p.shape[2] * p.shape[3])))
        elif name.endswith("token_embedding.weight"):
            normal(p, model.config.embed_dim ** -0.5)
            if pad_idx is not None:
                p[pad_idx] = 0.0
        elif name.endswith("position_embedding"):
            normal(p, 0.02)
        elif p.dim() == 2 and (
            parts[0] == "answer_head"
            or (parts[0] == "fusion" and "cross_attention" in parts
                and parts[-2].startswith("W_"))
        ):
            xavier(p)
        elif p.dim() == 2:  # other dense layers: LeCun normal
            normal(p, math.sqrt(1.0 / p.shape[1]))
        elif parts[-1] == "bias":
            p.zero_()
        # LayerNorm / BN weights keep torch's ones


def create_vqa_model(
    config: Optional[ModelConfig] = None,
    use_attention: Optional[bool] = None,
    device="cuda",
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    **overrides,
) -> VQAModel:
    """Build a seeded model in eval mode on ``device``, computing in
    ``dtype`` (f32, or bf16 for inference).

    ``use_attention=False`` disables both SE and spatial attention (the
    ``--no-attention`` ablation); ``overrides`` replace config fields.
    """
    device = resolve_device(device)
    cfg = config or ModelConfig()
    if overrides:
        if "base_channels" in overrides and "stage_channels" not in overrides:
            overrides = {**overrides, "stage_channels": None}
        cfg = dataclasses.replace(cfg, **overrides)
    if use_attention is not None:
        cfg = dataclasses.replace(
            cfg, use_se_attention=use_attention, use_spatial_attention=use_attention)
    model = VQAModel(cfg)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval().set_compute_dtype(dtype)


def count_parameters(model: VQAModel) -> Dict[str, int]:
    """Per-component parameter counts (buffers excluded)."""
    counts = {
        name: sum(p.numel() for p in getattr(model, name).parameters())
        for name in ("image_encoder", "text_encoder", "fusion", "answer_head")
    }
    counts["total"] = sum(counts.values())
    return counts


@torch.inference_mode()
def forward_logits(model: VQAModel, images: torch.Tensor, token_ids: torch.Tensor,
                   attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward pass → [B, num_answers] f32 logits."""
    logits, _ = model(images, token_ids, attention_mask)
    return logits


@torch.inference_mode()
def predict_topk(model: VQAModel, images: torch.Tensor, token_ids: torch.Tensor,
                 attention_mask: Optional[torch.Tensor] = None, top_k: int = 5
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k answer indices and probabilities."""
    probs = torch.softmax(forward_logits(model, images, token_ids, attention_mask), -1)
    top_probs, top_idx = torch.topk(probs, top_k, dim=-1)
    return top_idx, top_probs


@torch.inference_mode()
def get_attention_maps(model: VQAModel, images: torch.Tensor, token_ids: torch.Tensor,
                       attention_mask: Optional[torch.Tensor] = None
                       ) -> Dict[str, object]:
    """Cross-attention maps for visualization."""
    _, aux = model(images, token_ids, attention_mask, return_aux=True)
    weights = aux["cross_attention_weights"]
    return {
        "cross_attention": weights,
        "cross_attention_spatial": attention_visualization(
            weights, model.config.feature_spatial_size),
    }
