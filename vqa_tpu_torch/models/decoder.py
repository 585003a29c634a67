"""A VQA model whose fusion tower is a DeepSeek-V3 style decoder over the
image tokens, then the question's: Kimi-VL-A3B's language model (MLA in
every layer), or Kimi-Linear-48B-A3B's (Kimi Delta Attention in the layers
``kda_layers`` names, MLA without a rotary embedding in the others).

``DecoderVQAModel`` (``utils/config.py:DecoderConfig``; built by
``create_vqa_model``) takes ``(images, token_ids, attention_mask)`` as
``VQAModel`` does and returns ``(logits, {"route_counts": ...})``, f32
logits over the answers:

- the backbone of the reference model (``CustomResNet``) gives a
  [B, S, S, C] map; the projector, LayerNorm(C) → Linear(C → D) → GELU →
  Linear(D → D), turns it into S·S image tokens (Kimi-VL's projector
  without its 2 × 2 pixel shuffle, which a 7 × 7 map cannot take);
- the question's tokens are looked up in ``embed_tokens`` and follow the
  image tokens; the joint sequence runs through the decoder under a causal
  mask, with the question's padding masked as keys by MLA;
- ``decoder_dense_layers`` layers with a dense SwiGLU MLP, then MoE layers
  (``models/moe.py``), each pre-norm with residuals: RMSNorm → attention →
  add, RMSNorm → MLP → add; the attention of layer i is ``KDA`` where i is
  in ``kda_layers``, else ``MLA``;
- the answer head (``AnswerHead``) reads the last real question token
  after the final RMSNorm.

Multi-head latent attention (DeepSeek-V3's ``DeepseekV3Attention`` with
``q_lora_rank`` null), in the expanded form of a forward with no cache:
``q_proj`` gives each head ``qk_nope_head_dim`` + ``qk_rope_head_dim``
query dims; ``kv_a_proj_with_mqa`` gives a latent of ``kv_lora_rank``
(RMSNorm'd by ``kv_a_layernorm``) and one rotary key of
``qk_rope_head_dim`` that every head shares; ``kv_b_proj`` expands the
latent to each head's key (no rope part) and value. RoPE (theta
``rope_theta``, no scaling) acts on the rotary dims only, in DeepSeek-V3's
layout: the interleaved pairs (2i, 2i+1) are taken apart to
[even, odd] halves and rotated as ``rotate_half`` does. With
``mla_use_nope`` the tables hold cos 1 and sin 0: RoPE is then the same
permutation of q's and k's rotary dims, which leaves every score as it is,
so a model without rotation runs the same kernel. Scores are scaled by
(qk_nope + qk_rope)^-1/2, masked, and take their softmax in f32. The core
between the projections (RoPE, scores, mask, softmax, context) is one
call, ``ops.mla_attention``: on the card a hand-written kernel that reads
the projections' token-major outputs and writes the context token-major
for ``o_proj``, on the CPU its plain version.

Kimi Delta Attention (fla's ``KimiDeltaAttention``; the Kimi Linear report,
arXiv:2510.26692), ``kda_heads`` heads of ``kda_head_dim`` key and value
dims: ``q_proj``, ``k_proj`` and ``v_proj`` of x, each through a causal
depthwise convolution of ``short_conv_kernel_size`` taps and SiLU; q and k
L2-normalised per head; a decay per key channel, exp(-exp(A_log) ·
softplus(f_b_proj(f_a_proj(x)) + dt_bias)), and β = sigmoid(b_proj(x)) per
head; a [K, V] state per head, 0 at each pair's first position, decayed and
updated by the delta rule at each position and read by q. The core between
the projections is one call, ``ops.kda_attention``: on the card a
hand-written kernel, on the CPU its plain version (``ops/kda_kernel.py``
states the recurrence). Its output goes through ``o_norm``, an RMSNorm over
each head's dims, times sigmoid(g_b_proj(g_a_proj(x))) (fla's
``FusedRMSNormGated``), then ``o_proj``. The question's padding comes after
its real tokens and every layer is causal, so KDA needs no key mask: no
padding reaches the readout.

The dtype policy is the port's (``models/layers.py``): weights f32,
products (and RMSNorm's scaling) from bf16 compute copies; RMSNorm's
statistics, RoPE, the scores and the softmax compute in f32; the router
works in f32 from its f32 weight; KDA's convolutions, gates, L2 norms and
state are f32 from the bf16 projections, its output rounded once. Where
DeepSeek-V3's code rounds to bf16 between two steps of RoPE, the port
rounds once. KDA's six products of x (q, k, v, f_a, g_a, b) are one
product with a compute copy of their weights side by side.

State_dict keys follow the published checkpoints'
(``language_model.model.layers.{i}.self_attn.kv_a_proj_with_mqa.weight``,
``language_model.model.layers.{i}.self_attn.q_conv1d.weight``,
``language_model.model.layers.{i}.mlp.gate.e_score_correction_bias``,
``multi_modal_projector.linear_1.weight``); the backbone and the answer
head keep the reference model's (``image_encoder.*``, ``answer_head.*``).
Eager forwards carry ``record_function`` ranges ``decoder.mla``,
``decoder.kda``, ``moe.router``, ``moe.routed`` and ``moe.shared`` for a
profiler.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from vqa_tpu_torch.models.cnn_backbone import CustomResNet
from vqa_tpu_torch.models.layers import (ComputeCopies, ComputeDtypeRoot, Embedding, LayerNorm,
                                          Linear)
from vqa_tpu_torch.models.moe import MoE, SwiGLU
from vqa_tpu_torch.ops.kda_kernel import kda_attention
from vqa_tpu_torch.ops.mla_kernel import mla_attention
from vqa_tpu_torch.utils.config import DecoderConfig


class RMSNorm(ComputeCopies, nn.Module):
    """x / rms(x) · weight, the statistics in f32 (``F.rms_norm``), the
    weight in the compute dtype, as DeepSeek-V3's RMSNorm multiplies by its
    bf16 weight."""

    copied = ("weight",)

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.init_copies()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x, self.weight.shape, self.compute("weight"), self.eps)


def rope_tables(length: int, dim: int, theta: float, nope: bool = False):
    """(cos, sin) [length, dim / 2] f32 of DeepSeek-V3's rotary embedding:
    position p, frequency theta^(-2i/dim); with ``nope``, cos 1 and sin 0
    (no rotation). Computed on the CPU, wherever the model is built."""
    if nope:
        return torch.ones(length, dim // 2), torch.zeros(length, dim // 2)
    inv_freq = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device="cpu") / dim)
    freqs = torch.outer(torch.arange(length, dtype=torch.float32, device="cpu"), inv_freq)
    return freqs.cos(), freqs.sin()


class MLA(nn.Module):
    """Multi-head latent attention (see the module docstring): the four
    projections around the attention core (``ops.mla_attention``), which
    reads the projections' token-major outputs and writes the context
    token-major for ``o_proj``."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        d, h = cfg.decoder_hidden, cfg.decoder_heads
        self.heads, self.nope, self.rope, self.v = (h, cfg.qk_nope_head_dim,
                                                    cfg.qk_rope_head_dim, cfg.v_head_dim)
        self.rank = cfg.kv_lora_rank
        self.q_proj = Linear(d, h * (self.nope + self.rope), bias=False)
        self.kv_a_proj_with_mqa = Linear(d, self.rank + self.rope, bias=False)
        self.kv_a_layernorm = RMSNorm(self.rank, cfg.rms_norm_eps)
        self.kv_b_proj = Linear(self.rank, h * (self.nope + self.v), bias=False)
        self.o_proj = Linear(h * self.v, d, bias=False)

    def forward(self, x: torch.Tensor, keys: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        """x [B, L, D]; keys [B, L] int32, 0 at padding."""
        latent, k_pe = self.kv_a_proj_with_mqa(x).split([self.rank, self.rope], -1)
        kv = self.kv_b_proj(self.kv_a_layernorm(latent))
        return self.o_proj(mla_attention(self.q_proj(x), kv, k_pe, cos, sin, keys, self.heads))


class KDA(ComputeCopies, nn.Module):
    """Kimi Delta Attention (see the module docstring): the projections and
    gates around the core (``ops.kda_attention``), which reads the
    projections' token-major outputs, and the gated output norm. The
    product of x is one, with ``w_in``, a compute copy of ``q_proj``,
    ``k_proj``, ``v_proj``, ``f_a_proj``, ``g_a_proj`` and ``b_proj``'s
    weights side by side (zero rows after them to a multiple of 8, so each
    part's rows start 16-byte aligned)."""

    copied = ("w_in",)

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        d, h, dk = cfg.decoder_hidden, cfg.kda_heads, cfg.kda_head_dim
        width, taps = h * dk, cfg.short_conv_kernel_size
        self.heads, self.head_dim = h, dk
        sizes = (width, width, width, dk, dk, h)  # q, k, v, f_a, g_a, b: w_in's rows
        self.parts = [(sum(sizes[:i]), sum(sizes[:i + 1])) for i in range(len(sizes))]
        self.q_proj = nn.Linear(d, width, bias=False)
        self.k_proj = nn.Linear(d, width, bias=False)
        self.v_proj = nn.Linear(d, width, bias=False)
        self.q_conv1d = nn.Conv1d(width, width, taps, groups=width, bias=False)
        self.k_conv1d = nn.Conv1d(width, width, taps, groups=width, bias=False)
        self.v_conv1d = nn.Conv1d(width, width, taps, groups=width, bias=False)
        self.A_log = nn.Parameter(torch.zeros(h))
        self.dt_bias = nn.Parameter(torch.zeros(width))
        self.f_a_proj = nn.Linear(d, dk, bias=False)
        self.f_b_proj = Linear(dk, width, bias=False)
        self.b_proj = nn.Linear(d, h, bias=False)
        self.g_a_proj = nn.Linear(d, dk, bias=False)
        self.g_b_proj = Linear(dk, width, bias=False)
        self.o_norm = RMSNorm(dk, cfg.rms_norm_eps)
        self.o_proj = Linear(width, d, bias=False)
        self.init_copies()

    @property
    def w_in(self) -> torch.Tensor:
        w = torch.cat([self.q_proj.weight, self.k_proj.weight, self.v_proj.weight,
                       self.f_a_proj.weight, self.g_a_proj.weight, self.b_proj.weight])
        return F.pad(w, (0, 0, 0, -w.shape[0] % 8))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, L, D] → [B, L, D]."""
        proj = F.linear(x, self.compute("w_in"))
        q, k, v, fa, ga, b = (proj[..., a:e] for a, e in self.parts)
        o = kda_attention(q, k, v, self.f_b_proj(fa), b, self.q_conv1d.weight,
                          self.k_conv1d.weight, self.v_conv1d.weight, self.A_log, self.dt_bias,
                          self.heads)
        heads = (*o.shape[:-1], self.heads, self.head_dim)
        o = self.o_norm(o.view(heads)) * torch.sigmoid(self.g_b_proj(ga)).view(heads)
        return self.o_proj(o.flatten(-2))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig, index: int):
        super().__init__()
        d = cfg.decoder_hidden
        self.self_attn = KDA(cfg) if index in cfg.kda_layers else MLA(cfg)
        if index < cfg.decoder_dense_layers:
            self.mlp = SwiGLU(d, cfg.decoder_ffn_dim)
        else:
            self.mlp = MoE(d, cfg.moe_intermediate_size, cfg.router_experts,
                           cfg.num_experts_per_tok, cfg.n_shared_experts,
                           cfg.routed_scaling_factor, cfg.experts_held, cfg.expert_offset)
        self.input_layernorm = RMSNorm(d, cfg.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(d, cfg.rms_norm_eps)

    def forward(self, x, keys, cos, sin):
        """(x after the layer, the rows routed to each held expert, or None
        for a dense layer)."""
        if isinstance(self.self_attn, KDA):
            with record_function("decoder.kda"):
                x = x + self.self_attn(self.input_layernorm(x))
        else:
            with record_function("decoder.mla"):
                x = x + self.self_attn(self.input_layernorm(x), keys, cos, sin)
        h = self.post_attention_layernorm(x)
        if isinstance(self.mlp, MoE):
            out, counts = self.mlp(h.reshape(-1, h.shape[-1]))
            return x + out.view_as(x), counts
        return x + self.mlp(h), None


class DecoderStack(nn.Module):
    """``embed_tokens``, ``layers`` and the final ``norm`` of the language
    model (its ``model``)."""

    def __init__(self, cfg: DecoderConfig, positions: int):
        super().__init__()
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.decoder_hidden)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i) for i in range(cfg.decoder_layers))
        self.norm = RMSNorm(cfg.decoder_hidden, cfg.rms_norm_eps)
        cos, sin = rope_tables(positions, cfg.qk_rope_head_dim, cfg.rope_theta,
                               cfg.mla_use_nope)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, x: torch.Tensor, keys: torch.Tensor):
        """x [B, L, D], keys [B, L] (0 at padding) → (x, the rows routed to
        each held expert of each MoE layer [layers, held] int32, or None)."""
        keys = keys.to(torch.int32)  # the attention kernel's type (the engine's already)
        counts = []
        for layer in self.layers:
            x, c = layer(x, keys, self.rope_cos, self.rope_sin)
            if c is not None:
                counts.append(c)
        return x, (torch.stack(counts) if counts else None)


class LanguageModel(nn.Module):
    def __init__(self, cfg: DecoderConfig, positions: int):
        super().__init__()
        self.model = DecoderStack(cfg, positions)


class Projector(nn.Module):
    """Kimi-VL's multi-modal projector without the pixel shuffle."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.pre_norm = LayerNorm(in_dim, eps=1e-5)
        self.linear_1 = Linear(in_dim, hidden)
        self.linear_2 = Linear(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.gelu(self.linear_1(self.pre_norm(x))))


class DecoderVQAModel(ComputeDtypeRoot):
    """See the module docstring."""

    def __init__(self, config: DecoderConfig):
        super().__init__()
        from vqa_tpu_torch.models.vqa_model import AnswerHead

        cfg = self.config = config
        self.image_tokens = cfg.feature_spatial_size ** 2
        self.image_encoder = CustomResNet(
            in_channels=cfg.in_channels, base_channels=cfg.base_channels,
            stage_channels=tuple(cfg.stage_channels),
            num_blocks=tuple(cfg.blocks_per_stage), use_se=cfg.use_se_attention,
            use_spatial=cfg.use_spatial_attention, se_reduction=cfg.se_reduction)
        self.multi_modal_projector = Projector(cfg.stage_channels[-1], cfg.decoder_hidden)
        self.language_model = LanguageModel(cfg, self.image_tokens + cfg.max_question_length)
        self.answer_head = AnswerHead(cfg.decoder_hidden, cfg.answer_hidden_dim,
                                      cfg.num_answers, cfg.answer_dropout)

    def forward(self, images: torch.Tensor, token_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None):
        feats = self.image_encoder(images.to(self.dtype))
        b, s1, s2, c = feats.shape
        lm = self.language_model.model
        x = torch.cat([self.multi_modal_projector(feats.reshape(b, s1 * s2, c)),
                       lm.embed_tokens(token_ids)], 1)
        if attention_mask is None:
            attention_mask = torch.ones_like(token_ids)
        keys = torch.cat([attention_mask.new_ones((b, s1 * s2)), attention_mask], 1)
        x, counts = lm(x, keys)
        last = s1 * s2 + attention_mask.sum(1) - 1
        read = lm.norm(x[torch.arange(b, device=x.device), last])
        logits = self.answer_head(read).float()
        return logits, (None if counts is None else {"route_counts": counts})
