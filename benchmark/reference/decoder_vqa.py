"""The plain reference of the decoder VQA model: its forward in float32,
plain PyTorch, one rank's share of the routed experts.

A frozen, independent statement of what the benchmark's decoder
configuration computes: Kimi-VL-A3B-Instruct's language model (DeepSeek-V3's
decoder; its `config.json` at
https://huggingface.co/moonshotai/Kimi-VL-A3B-Instruct/blob/main/config.json)
as the fusion tower of the VQA model, in eval mode:

- pixels and backbone: the reference model's (`model.py:Reference.backbone`),
  a [B, 7, 7, C] map;
- projector: LayerNorm(C, eps 1e-5) -> Linear(C -> D) -> exact GELU ->
  Linear(D -> D), 49 image tokens;
- question: the word tokenizer's ids (`prep.py`) looked up in
  `embed_tokens`, after the image tokens; keys: causal, the question's
  padding masked (scores -1e9 before the softmax);
- decoder layers, pre-norm with residuals (RMSNorm, eps `rms_norm_eps`):
  multi-head latent attention, then a SwiGLU MLP (the first
  `decoder_dense_layers` layers) or the mixture of experts;
- attention: q = q_proj(x) per head [nope | rope]; kv_a_proj_with_mqa(x) =
  [latent | k_rope], the latent RMSNorm'd and expanded by kv_b_proj into
  each head's [k_nope | v]; RoPE (theta `rope_theta`, positions 0..L-1)
  on q_rope and on k_rope, which every head shares, with DeepSeek-V3's
  de-interleaving of each (2i, 2i+1) pair into [even | odd] halves and
  rotate_half; softmax((q . k) / sqrt(nope + rope)) v, then o_proj;
- experts: logits = x W_gate^T, scores = sigmoid(logits); each token takes
  the `num_experts_per_tok` experts of highest score +
  e_score_correction_bias (one group: `noaux_tc` with `n_group` 1
  selects over all), weighted by their scores / (their sum + 1e-20) x
  `routed_scaling_factor`; experts [expert_offset, expert_offset +
  experts_held) are computed, each SwiGLU of width
  `moe_intermediate_size`, over the tokens routed to it, and their
  weighted sum plus the shared experts' SwiGLU (width
  moe_intermediate_size x n_shared_experts) is the layer's output;
- readout: the final RMSNorm of the last real question token, then the
  answer head (Linear -> ReLU -> Linear -> ReLU -> Linear).

Departures from Kimi-VL, each listed under `assumed` in the
configuration: the vision tower is the reference model's backbone, not
MoonViT; the projector has no 2 x 2 pixel shuffle; the output is the
1,000-way answer head at the last question token, not the language
model's head; the router's bias is drawn, not trained; the experts held
elsewhere are left out, in the program and here alike.

`quant`, when given, rounds every operand of every product (each linear
layer, the router's among them, and both attention products) before it is
used: the benchmark's lower-precision control. This module imports torch
and the reference model's module only.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .model import NEG_INF, Quant, Reference, param_shapes as backbone_shapes

LM = "language_model.model"


def param_shapes(cfg: dict) -> "OrderedDict[str, Tuple[Tuple[int, ...], str]]":
    """Every state_dict entry of the decoder model: key -> (shape, kind);
    the kind names the rule the benchmark draws it by."""
    out: "OrderedDict[str, Tuple[Tuple[int, ...], str]]" = OrderedDict(
        (k, v) for k, v in backbone_shapes(cfg).items() if k.startswith("image_encoder."))
    d, h = cfg["decoder_hidden"], cfg["decoder_heads"]
    nope, rope, v, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                        cfg["kv_lora_rank"])
    c = cfg["stage_channels"][-1]
    out["multi_modal_projector.pre_norm.weight"] = ((c,), "ln_weight")
    out["multi_modal_projector.pre_norm.bias"] = ((c,), "ln_bias")
    out["multi_modal_projector.linear_1.weight"] = ((d, c), "linear")
    out["multi_modal_projector.linear_1.bias"] = ((d,), "bias")
    out["multi_modal_projector.linear_2.weight"] = ((d, d), "linear")
    out["multi_modal_projector.linear_2.bias"] = ((d,), "bias")
    out[f"{LM}.embed_tokens.weight"] = ((cfg["vocab_size"], d), "embedding")

    def mlp(p, width):
        out[p + ".gate_proj.weight"] = ((width, d), "linear")
        out[p + ".up_proj.weight"] = ((width, d), "linear")
        out[p + ".down_proj.weight"] = ((d, width), "linear")

    for i in range(cfg["decoder_layers"]):
        p = f"{LM}.layers.{i}"
        a = p + ".self_attn"
        out[a + ".q_proj.weight"] = ((h * (nope + rope), d), "linear")
        out[a + ".kv_a_proj_with_mqa.weight"] = ((r + rope, d), "linear")
        out[a + ".kv_a_layernorm.weight"] = ((r,), "rms_weight")
        out[a + ".kv_b_proj.weight"] = ((h * (nope + v), r), "linear")
        out[a + ".o_proj.weight"] = ((d, h * v), "linear")
        if i < cfg["decoder_dense_layers"]:
            mlp(p + ".mlp", cfg["decoder_ffn_dim"])
        else:
            out[p + ".mlp.gate.weight"] = ((cfg["router_experts"], d), "linear")
            out[p + ".mlp.gate.e_score_correction_bias"] = ((cfg["router_experts"],),
                                                            "router_bias")
            for e in held_experts(cfg):
                mlp(f"{p}.mlp.experts.{e}", cfg["moe_intermediate_size"])
            mlp(p + ".mlp.shared_experts", cfg["moe_intermediate_size"] * cfg["n_shared_experts"])
        out[p + ".input_layernorm.weight"] = ((d,), "rms_weight")
        out[p + ".post_attention_layernorm.weight"] = ((d,), "rms_weight")
    out[f"{LM}.norm.weight"] = ((d,), "rms_weight")
    hid = cfg["answer_hidden_dim"]
    out["answer_head.classifier.0.weight"] = ((hid, d), "linear")
    out["answer_head.classifier.0.bias"] = ((hid,), "bias")
    out["answer_head.classifier.3.weight"] = ((hid // 2, hid), "linear")
    out["answer_head.classifier.3.bias"] = ((hid // 2,), "bias")
    out["answer_head.classifier.6.weight"] = ((cfg["num_answers"], hid // 2), "linear")
    out["answer_head.classifier.6.bias"] = ((cfg["num_answers"],), "bias")
    return out


def held_experts(cfg: dict) -> range:
    return range(cfg["expert_offset"], cfg["expert_offset"] + cfg["experts_held"])


class DecoderReference(Reference):
    """The forward of one decoder configuration over one state_dict."""

    def __init__(self, cfg: dict, state: Dict[str, torch.Tensor], quant: Quant = None):
        super().__init__(cfg, state, quant)
        self.routes: List[torch.Tensor] = []  # each MoE layer's choices, [T, k]

    def rms(self, x, key):
        x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.cfg["rms_norm_eps"])
        return x * self.w[key + ".weight"]

    def rope(self, x):
        """x [B, L, h, d] at positions 0..L-1."""
        b, length, h, d = x.shape
        inv_freq = 1.0 / self.cfg["rope_theta"] ** (
            torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
        freqs = torch.outer(torch.arange(length, dtype=torch.float32, device=x.device), inv_freq)
        emb = torch.cat([freqs, freqs], -1)
        cos, sin = emb.cos()[:, None], emb.sin()[:, None]
        x = x.reshape(b, length, h, d // 2, 2).transpose(-1, -2).reshape(b, length, h, d)
        x1, x2 = x[..., : d // 2], x[..., d // 2:]
        return x * cos + torch.cat([-x2, x1], -1) * sin

    def mla(self, x, key, keys):
        cfg = self.cfg
        b, length, _ = x.shape
        h, nope, rope, v, r = (cfg["decoder_heads"], cfg["qk_nope_head_dim"],
                               cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"])
        q = self.linear(x, key + ".q_proj", bias=False).reshape(b, length, h, nope + rope)
        q_nope, q_rope = q[..., :nope], self.rope(q[..., nope:])
        kv_a = self.linear(x, key + ".kv_a_proj_with_mqa", bias=False)
        latent = self.rms(kv_a[..., :r], key + ".kv_a_layernorm")
        k_rope = self.rope(kv_a[..., r:].reshape(b, length, 1, rope)).expand(b, length, h, rope)
        kv = self.linear(latent, key + ".kv_b_proj", bias=False).reshape(b, length, h, nope + v)
        qh = torch.cat([q_nope, q_rope], -1).transpose(1, 2)
        kh = torch.cat([kv[..., :nope], k_rope], -1).transpose(1, 2)
        vh = kv[..., nope:].transpose(1, 2)
        scores = self.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(nope + rope)
        pos = torch.arange(length, device=x.device)
        keep = (pos[None, :] <= pos[:, None])[None] & (keys[:, None, :] != 0)
        scores = scores.masked_fill(~keep[:, None], NEG_INF)
        ctx = self.matmul(torch.softmax(scores, dim=-1), vh)
        return self.linear(ctx.transpose(1, 2).reshape(b, length, h * v), key + ".o_proj",
                           bias=False)

    def swiglu(self, x, key):
        g = self.linear(x, key + ".gate_proj", bias=False)
        u = self.linear(x, key + ".up_proj", bias=False)
        return self.linear(F.silu(g) * u, key + ".down_proj", bias=False)

    def moe(self, x, key):
        """x [T, D] -> this rank's part of the layer's output, [T, D]."""
        cfg = self.cfg
        scores = torch.sigmoid(self.linear(x, key + ".gate", bias=False))
        choice = scores + self.w[key + ".gate.e_score_correction_bias"]
        idx = torch.topk(choice, cfg["num_experts_per_tok"], dim=-1).indices
        weights = scores.gather(1, idx)
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
        self.routes.append(idx)
        out = self.swiglu(x, key + ".shared_experts")
        for e in held_experts(cfg):
            tok, k = torch.nonzero(idx == e, as_tuple=True)
            if tok.numel():
                y = self.swiglu(x[tok], f"{key}.experts.{e}")
                out = out.index_add(0, tok, weights[tok, k, None] * y)
        return out

    def logits(self, pixels: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """uint8 pixels [B, S, S, 3], token ids and mask [B, L] -> logits
        [B, num_answers], float32."""
        cfg = self.cfg
        feats = self.backbone(pixels)
        b, s1, s2, c = feats.shape
        t = s1 * s2
        img = self.ln_eps(feats.reshape(b, t, c), "multi_modal_projector.pre_norm", 1e-5)
        img = self.linear(F.gelu(self.linear(img, "multi_modal_projector.linear_1")),
                          "multi_modal_projector.linear_2")
        txt = F.embedding(ids.long(), self.w[f"{LM}.embed_tokens.weight"])
        x = torch.cat([img, txt], 1)
        keys = torch.cat([torch.ones((b, t), dtype=mask.dtype, device=mask.device), mask], 1)
        for i in range(cfg["decoder_layers"]):
            p = f"{LM}.layers.{i}"
            x = x + self.mla(self.rms(x, p + ".input_layernorm"), p + ".self_attn", keys)
            hid = self.rms(x, p + ".post_attention_layernorm")
            if i < cfg["decoder_dense_layers"]:
                x = x + self.swiglu(hid, p + ".mlp")
            else:
                x = x + self.moe(hid.reshape(-1, hid.shape[-1]), p + ".mlp").reshape(hid.shape)
        last = t + mask.long().sum(1) - 1
        x = self.rms(x[torch.arange(b, device=x.device), last], f"{LM}.norm")
        x = torch.relu(self.linear(x, "answer_head.classifier.0"))
        x = torch.relu(self.linear(x, "answer_head.classifier.3"))
        return self.linear(x, "answer_head.classifier.6")

    def ln_eps(self, x, key, eps):
        return F.layer_norm(x, x.shape[-1:], self.w[key + ".weight"], self.w[key + ".bias"], eps)


@torch.no_grad()
def log_probs_in_blocks(cfg: dict, state: Dict[str, torch.Tensor], pixels: torch.Tensor,
                        ids: torch.Tensor, mask: torch.Tensor, block: int = 128,
                        quant: Quant = None):
    """(log softmax of the reference over rows in blocks of `block`, [n,
    answers] on the CPU; each MoE layer's choices of every token, [layers,
    n, positions, k] int64 on the CPU), with TF32 off; inputs on the
    device the state lives on."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        lps, routes = [], []
        for i in range(0, pixels.shape[0], block):
            ref = DecoderReference(cfg, state, quant)
            lps.append(torch.log_softmax(ref.logits(pixels[i:i + block], ids[i:i + block],
                                                    mask[i:i + block]), -1).cpu())
            n = min(block, pixels.shape[0] - i)
            routes.append(torch.stack([r.reshape(n, -1, r.shape[-1]) for r in ref.routes]).cpu())
        return torch.cat(lps), torch.cat(routes, 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
