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

``dtype`` is the JAX model's compute dtype (``vqa_model.py:151``): f32 or
bf16 (``models/layers.py``: parameters, BN's running statistics and the
state_dict stay f32; every Linear/Conv/Embedding computes from a bf16 copy
of its weights in eval mode, remade whenever the model leaves training
mode, and from a differentiable bf16 cast of the f32 parameter in training
mode; norms take f32 statistics; in eval mode the stem, SE and
cross-attention kernels run their bf16 forms; the logits are f32).
``stem_s2d`` runs the stem conv as the JAX ``StemConv(s2d=True)`` does
(``models/cnn_backbone.py``).

``shard_model`` places a model built from a full state_dict on a (data,
model) grid of ranks (``vqa_tpu_torch.parallel``), as JAX's
``shard_variables`` places variables on a mesh: the tensor-parallel blocks
split over the model group (``models/layers.py``; attention with H/mp
local heads, the fused cross-attention kernel then runs on
``[B, H/mp, L, d_h]``), BN's training statistics joined over the data
group. The answer head's fc1 is column-parallel, fc2 row-parallel, fc3
whole (``vqa_tpu/models/vqa_model.py:42-50``). The model computes the
function of the unsplit one; ``full_state_dict`` gathers the reference
layout back and ``load_full_state_dict`` takes one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from vqa_tpu_torch.models.cnn_backbone import BatchNorm2d, CustomResNet, run_segment
from vqa_tpu_torch.models.cross_attention import CrossAttention
from vqa_tpu_torch.models.fusion import MultimodalFusion, attention_visualization
from vqa_tpu_torch.models.layers import (
    ColumnParallelLinear,
    ComputeDtypeRoot,
    Embedding,
    Linear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from vqa_tpu_torch.models.text_encoder import MultiHeadSelfAttention, TransformerTextEncoder
from vqa_tpu_torch.parallel import mesh as mesh_lib
from vqa_tpu_torch.utils.config import DecoderConfig, ModelConfig


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


class VQAModel(ComputeDtypeRoot):
    """``logits, aux = model(images, token_ids, mask, return_aux=...)`` with
    images [B, H, W, 3] NHWC f32 (normalized), cast to the compute dtype
    as the JAX model's first conv casts them; logits are f32."""

    def __init__(self, config: ModelConfig, stem_s2d: bool = False):
        super().__init__()
        cfg = self.config = config
        # set by shard_model: the grid, and the state_dict entries split on it
        self.mesh = None
        self.tp_splits: Dict[str, int] = {}
        self.image_encoder = CustomResNet(
            in_channels=cfg.in_channels, base_channels=cfg.base_channels,
            stage_channels=tuple(cfg.stage_channels),
            num_blocks=tuple(cfg.blocks_per_stage), use_se=cfg.use_se_attention,
            use_spatial=cfg.use_spatial_attention, se_reduction=cfg.se_reduction,
            stem_s2d=stem_s2d,
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

    def forward(self, images: torch.Tensor, token_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                return_aux: bool = False, segment=None):
        """``segment(fn, *args)``, when given, runs each of the model's
        remat segments: the stem, each backbone stage and the rest of the
        model after the backbone, so that only their outputs are kept
        between them (the stage-boundary tags of the JAX backbone)."""
        image_features = self.image_encoder(images.to(self.dtype), segment=segment)
        return (segment or run_segment)(self._after_backbone, image_features, token_ids,
                                        attention_mask, return_aux)

    def _after_backbone(self, image_features: torch.Tensor, token_ids: torch.Tensor,
                        attention_mask: Optional[torch.Tensor], return_aux: bool):
        text_features, text_pooled = self.text_encoder(token_ids, attention_mask)
        fused, fusion_aux = self.fusion(image_features, text_features, attention_mask)
        # logits always f32 for a stable softmax
        logits = self.answer_head(fused).float()
        if return_aux:
            if any(k.endswith("cross_attention.W_q.weight") for k in self.tp_splits):
                m = self.mesh  # this rank's heads → all heads
                fusion_aux["cross_attention_weights"] = [
                    mesh_lib.gather(w, 1, m.model_index, m.model_parallel, m.model_group)
                    for w in fusion_aux["cross_attention_weights"]]
            aux = {
                "image_features": image_features,
                "text_features": text_features,
                "text_pooled": text_pooled,
                "fused": fused,
                **fusion_aux,
            }
            return logits, aux
        return logits, None


    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The state_dict in the reference layout: a sharded model's split
        entries gathered over its model group (every rank of it must call)."""
        state = self.state_dict()
        if not self.tp_splits:
            return state
        return mesh_lib.full_state_dict(state, self.tp_splits, self.mesh)

    def load_full_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Load a reference-layout state_dict strictly, taking this rank's
        slices where the model is sharded."""
        if self.tp_splits:
            state = mesh_lib.shard_state_dict(state, self.tp_splits, self.mesh)
        self.load_state_dict(state, strict=True)


def shard_model(model: VQAModel, mesh) -> VQAModel:
    """Place ``model`` (built, and loaded from a full state_dict, the same
    on every rank) on ``mesh``, in place: each tensor-parallel block whose
    split dimensions divide by the model degree
    (``parallel.mesh.variables_shardings``)
    takes its split layers, holding this rank's slices; the others stay
    whole; every BatchNorm takes its training statistics over the data
    group. Returns the model."""
    if model.mesh is not None:
        raise ValueError("the model is already placed on a mesh")
    if not isinstance(model, VQAModel):
        raise ValueError("only the cross-attention model is placed on a mesh")
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    splits = mesh_lib.variables_shardings(shapes, mesh, model.config.num_attention_heads)
    place = (mesh.model_index, mesh.model_parallel, mesh.model_group)
    modules = dict(model.named_modules())
    for key, dim in splits.items():
        path, leaf = key.rsplit(".", 1)
        if leaf != "weight":
            continue  # a bias moves with its layer
        layer = modules[path]
        cls = (VocabParallelEmbedding if isinstance(layer, Embedding)
               else ColumnParallelLinear if dim == 0 else RowParallelLinear)
        parent, name = path.rsplit(".", 1)
        setattr(modules[parent], name, cls.from_full(layer, *place))
    for path, m in modules.items():
        if isinstance(m, (MultiHeadSelfAttention, CrossAttention)) and f"{path}.W_q.weight" in splits:
            m.num_heads //= mesh.model_parallel
        if isinstance(m, BatchNorm2d) and mesh.data_parallel > 1:
            m.data_group = mesh.data_group
    model.mesh, model.tp_splits = mesh, splits
    return model.set_compute_dtype(model.dtype)


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
        elif p.dim() == 3:  # a depthwise conv1d [C, 1, W]: normal, fan_in = W
            normal(p, math.sqrt(1.0 / p.shape[2]))
        elif parts[-1] == "A_log":  # KDA's decay rates, log U(1, 16) as fla draws them
            p.copy_(torch.log(1 + 15 * torch.rand(p.shape, generator=generator)))
        elif parts[-1] == "dt_bias":  # softplus^-1 of a log-uniform dt in [1e-3, 0.1]
            u = torch.rand(p.shape, generator=generator)
            dt = torch.exp(math.log(1e-3) + math.log(100) * u)
            p.copy_(dt + torch.log(-torch.expm1(-dt)))
        elif parts[-1] == "bias":
            p.zero_()
        # LayerNorm / BN weights keep torch's ones


def create_vqa_model(
    config: Optional[ModelConfig] = None,
    use_attention: Optional[bool] = None,
    device="cuda",
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    stem_s2d: bool = False,
    init: bool = True,
    **overrides,
) -> VQAModel:
    """Build a seeded model in eval mode on ``device``, computing in
    ``dtype`` (f32 or bf16).

    ``use_attention=False`` disables both SE and spatial attention (the
    ``--no-attention`` ablation); ``stem_s2d`` takes the space-to-depth
    stem conv (same parameters, same function); ``overrides`` replace
    config fields. A ``DecoderConfig`` builds the decoder tower's model
    (``models/decoder.py``), which takes the same inputs. ``init=False``,
    for a caller that loads a whole state over the model, skips the seeded
    initialisation and builds the model on ``device`` directly (its
    parameters hold torch's default initialisation, or nothing in
    particular).
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
    if isinstance(cfg, DecoderConfig):
        from vqa_tpu_torch.models.decoder import DecoderVQAModel

        build = lambda: DecoderVQAModel(cfg)  # noqa: E731
    else:
        build = lambda: VQAModel(cfg, stem_s2d=stem_s2d)  # noqa: E731
    if init:
        model = build()
        init_parameters(model, torch.Generator().manual_seed(seed))
    else:
        with torch.device(device):
            model = build()
    return model.to(device).eval().set_compute_dtype(dtype)


def count_parameters(model: nn.Module) -> Dict[str, int]:
    """Per-component parameter counts (buffers excluded): one per child of
    the model, in order."""
    counts = {name: sum(p.numel() for p in child.parameters())
              for name, child in model.named_children()}
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
