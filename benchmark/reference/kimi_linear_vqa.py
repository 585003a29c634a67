"""The plain reference of the hybrid decoder VQA model: its forward in
float32, plain PyTorch, one rank's share of the routed experts.

A frozen, independent statement of what the benchmark's Kimi-Linear
configuration computes: Kimi-Linear-48B-A3B-Instruct's language model (its
`config.json` at
https://huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct/blob/main/config.json;
Kimi Delta Attention as fla's `KimiDeltaAttention` and the Kimi Linear
report, arXiv:2510.26692) as the fusion tower of the VQA model, in eval
mode. Everything but the attention is `decoder_vqa.py`'s, by import: the
backbone, the projector, the embedding, the pre-norm layers with their
residuals, the dense SwiGLU, the mixture of experts with one rank's share
of the routed experts, the final RMSNorm at the last real question token
and the answer head. The attention of layer i (0-based):

- Kimi Delta Attention where i is in `kda_layers` (`kda_heads` heads of
  `kda_head_dim` key and value dims): q, k and v are `q_proj`, `k_proj`
  and `v_proj` of x, each through its causal depthwise convolution of
  `short_conv_kernel_size` taps, written as the explicit window
  y_t = sum_j w[c, j] x_{t - (W-1) + j} over the pair's own positions
  (zeros before its first), then SiLU; q and k are L2-normalised per head,
  x / sqrt(sum x^2 + 1e-6), and q is scaled by K^-1/2. The decay per key
  channel is g = -exp(A_log[h]) softplus(f_b_proj(f_a_proj(x)) + dt_bias),
  alpha = exp(g); beta = sigmoid(b_proj(x)) per head. Each head's state S
  [K, V] starts at 0 at each pair's first position, and at each position,
  token by token: S <- Diag(alpha) S, then S <- S + beta k (v - S^T k)^T,
  then o = S^T q. The output is RMSNorm(o) over each head's dims (eps
  `rms_norm_eps`, the weight `o_norm`) times sigmoid(g_b_proj(g_a_proj(x))),
  then `o_proj`;
- otherwise multi-head latent attention without rotation (`mla_use_nope`):
  `decoder_vqa.py`'s MLA with q's and the shared key's 64 rope dims used as
  they are, scores scaled by (nope + rope)^-1/2.

Departures from Kimi-Linear, each listed under `assumed` in the
configuration: the vision side is that of the Kimi-VL configuration (the
reference model's backbone, the projector without pixel shuffle, the
1,000-way answer head at the last question token, 20 question positions
after 49 image tokens); the router's bias and KDA's A_log, dt_bias and
convolution weights are drawn, not trained; the experts held elsewhere are
left out, in the program and here alike. The question's padding comes after
its real tokens and every layer is causal, so neither the recurrence nor
its convolution carries padding into the readout: KDA takes no key mask.
MLA masks the padding as keys, as in `decoder_vqa.py`.

Routing can be pinned: each token then takes the experts given for it in
each MoE layer (the program's, read from it) in place of its own top k,
with the weights the reference computes for them. At 256 experts and 8 a
token the sigmoid scores lie so close together that rounding alone moves a
token's top k in some layer nearly everywhere; pinned, the reference and
the program compute the same function of the same choices, and what they
differ by is how they compute it. The reference's own choices are still
recorded, so the share of choices that rounding moved stays in view.

`quant`, when given, rounds every operand of every product (each linear
layer, both attention products, each convolution tap, and the recurrence's
products S^T k, k (x) u and S^T q) before it is used: the benchmark's
lower-precision control. This module imports torch and the other reference
modules only.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .decoder_vqa import LM, DecoderReference, held_experts, param_shapes as decoder_shapes
from .model import Quant

L2_EPS = 1e-6


def kda_shapes(cfg: dict, key: str) -> "OrderedDict[str, Tuple[Tuple[int, ...], str]]":
    """The state_dict entries of one KDA layer's attention under `key`."""
    d, h, dk, taps = (cfg["decoder_hidden"], cfg["kda_heads"], cfg["kda_head_dim"],
                      cfg["short_conv_kernel_size"])
    width = h * dk
    out: "OrderedDict[str, Tuple[Tuple[int, ...], str]]" = OrderedDict()
    for name in ("q", "k", "v"):
        out[f"{key}.{name}_proj.weight"] = ((width, d), "linear")
    for name in ("q", "k", "v"):
        out[f"{key}.{name}_conv1d.weight"] = ((width, 1, taps), "short_conv")
    out[key + ".A_log"] = ((h,), "a_log")
    out[key + ".dt_bias"] = ((width,), "dt_bias")
    out[key + ".f_a_proj.weight"] = ((dk, d), "linear")
    out[key + ".f_b_proj.weight"] = ((width, dk), "linear")
    out[key + ".b_proj.weight"] = ((h, d), "linear")
    out[key + ".g_a_proj.weight"] = ((dk, d), "linear")
    out[key + ".g_b_proj.weight"] = ((width, dk), "linear")
    out[key + ".o_norm.weight"] = ((dk,), "rms_weight")
    out[key + ".o_proj.weight"] = ((d, width), "linear")
    return out


def param_shapes(cfg: dict) -> "OrderedDict[str, Tuple[Tuple[int, ...], str]]":
    """Every state_dict entry of the model: key -> (shape, kind), in
    `decoder_vqa.py`'s order, each KDA layer's attention entries in place
    of MLA's; the kind names the rule the benchmark draws it by."""
    out: "OrderedDict[str, Tuple[Tuple[int, ...], str]]" = OrderedDict()
    kda = {f"{LM}.layers.{i}.self_attn" for i in cfg["kda_layers"]}
    for k, v in decoder_shapes(cfg).items():
        attn = k.rsplit(".", 2)[0]
        if attn in kda:
            if attn + ".q_proj.weight" not in out:
                out.update(kda_shapes(cfg, attn))
        else:
            out[k] = v
    return out


class KimiLinearReference(DecoderReference):
    """The forward of one Kimi-Linear configuration over one state_dict;
    with `pinned` (each MoE layer's choices [T, k], in `routes`' order),
    every token takes the pinned experts in place of its own top k."""

    def __init__(self, cfg: dict, state: Dict[str, torch.Tensor], quant: Quant = None,
                 pinned: Optional[torch.Tensor] = None):
        super().__init__(cfg, state, quant)
        self.pinned = pinned

    def moe(self, x, key):
        """`decoder_vqa.py`'s mixture of experts. Pinned, a token's experts
        are the pinned ones, weighted by its own scores of them as its own
        would be; its own top k is still what `routes` records."""
        if self.pinned is None:
            return super().moe(x, key)
        cfg = self.cfg
        scores = torch.sigmoid(self.linear(x, key + ".gate", bias=False))
        choice = scores + self.w[key + ".gate.e_score_correction_bias"]
        self.routes.append(torch.topk(choice, cfg["num_experts_per_tok"], dim=-1).indices)
        idx = self.pinned[len(self.routes) - 1].to(x.device, torch.long)
        weights = scores.gather(1, idx)
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
        out = self.swiglu(x, key + ".shared_experts")
        for e in held_experts(cfg):
            tok, k = torch.nonzero(idx == e, as_tuple=True)
            if tok.numel():
                y = self.swiglu(x[tok], f"{key}.experts.{e}")
                out = out.index_add(0, tok, weights[tok, k, None] * y)
        return out

    def rope(self, x):
        """No rotary embedding (`mla_use_nope`): the rope dims as they are."""
        return x

    def mla(self, x, key, keys):
        """Layer i's attention: KDA where i is in `kda_layers`, else MLA
        without rotation."""
        if int(key.split(".")[-2]) in self.cfg["kda_layers"]:
            return self.kda(x, key)
        return super().mla(x, key, keys)

    def short_conv(self, y, key):
        """SiLU of the causal depthwise convolution of y [B, L, C] over each
        pair's positions, as the explicit window of its taps."""
        w = self.q(self.w[key + ".weight"][:, 0])  # [C, W]
        y = self.q(y)
        taps, length = w.shape[1], y.shape[1]
        out = torch.zeros_like(y)
        for j in range(taps):
            shift = taps - 1 - j  # tap j multiplies position t - shift
            out[:, shift:] = out[:, shift:] + w[:, j] * y[:, :length - shift]
        return F.silu(out)

    def kda(self, x, key):
        cfg = self.cfg
        b, length, _ = x.shape
        h, dk = cfg["kda_heads"], cfg["kda_head_dim"]

        def qkv(name):
            y = self.linear(x, f"{key}.{name}_proj", bias=False)
            return self.short_conv(y, f"{key}.{name}_conv1d").reshape(b, length, h, dk)

        q, k, v = qkv("q"), qkv("k"), qkv("v")
        q = q / torch.sqrt(q.pow(2).sum(-1, keepdim=True) + L2_EPS) * dk ** -0.5
        k = k / torch.sqrt(k.pow(2).sum(-1, keepdim=True) + L2_EPS)
        f = self.linear(self.linear(x, key + ".f_a_proj", bias=False), key + ".f_b_proj",
                        bias=False).reshape(b, length, h, dk)
        g = -torch.exp(self.w[key + ".A_log"])[:, None] * F.softplus(
            f + self.w[key + ".dt_bias"].reshape(h, dk))
        alpha = torch.exp(g)
        beta = torch.sigmoid(self.linear(x, key + ".b_proj", bias=False))  # [B, L, h]
        state = torch.zeros(b, h, dk, dk, device=x.device)
        outs = []
        for t in range(length):
            state = alpha[:, t, :, :, None] * state
            kt = k[:, t]
            u = beta[:, t, :, None] * (v[:, t] - self.matmul(kt[:, :, None], state)[:, :, 0])
            state = state + self.q(kt)[..., :, None] * self.q(u)[..., None, :]
            outs.append(self.matmul(q[:, t, :, None], state)[:, :, 0])
        o = torch.stack(outs, 1)  # [B, L, h, V]
        o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + cfg["rms_norm_eps"])
        o = o * self.w[key + ".o_norm.weight"]
        gate = torch.sigmoid(self.linear(self.linear(x, key + ".g_a_proj", bias=False),
                                         key + ".g_b_proj", bias=False))
        o = o * gate.reshape(b, length, h, dk)
        return self.linear(o.reshape(b, length, h * dk), key + ".o_proj", bias=False)


@torch.no_grad()
def log_probs_in_blocks(cfg: dict, state: Dict[str, torch.Tensor], pixels: torch.Tensor,
                        ids: torch.Tensor, mask: torch.Tensor, block: int = 128,
                        quant: Quant = None, routes: Optional[torch.Tensor] = None):
    """(log softmax of the reference over rows in blocks of `block`, [n,
    answers] on the CPU; each MoE layer's own choices of every token,
    [layers, n, positions, k] int64 on the CPU), with TF32 off; inputs on
    the device the state lives on. `routes`, of the shape returned, pins
    every token's experts to the given choices (`KimiLinearReference`)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        lps, chosen = [], []
        for i in range(0, pixels.shape[0], block):
            n = min(block, pixels.shape[0] - i)
            pinned = (None if routes is None else
                      routes[:, i:i + n].reshape(routes.shape[0], -1, routes.shape[-1]))
            ref = KimiLinearReference(cfg, state, quant, pinned)
            lps.append(torch.log_softmax(ref.logits(pixels[i:i + block], ids[i:i + block],
                                                    mask[i:i + block]), -1).cpu())
            chosen.append(torch.stack([r.reshape(n, -1, r.shape[-1]) for r in ref.routes]).cpu())
        return torch.cat(lps), torch.cat(chosen, 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
