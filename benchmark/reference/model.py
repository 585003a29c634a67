"""The plain reference of the VQA model: its forward in float32, plain PyTorch.

A frozen, independent statement of the model the benchmark measures (the
reference repository's `models/vqa_model.py`, `cnn_backbone.py`,
`text_encoder.py`, `fusion.py` and `attention_modules.py`, in eval mode):

- pixels: uint8 [B, S, S, 3] -> x / 255 -> ImageNet mean and std;
- backbone: 7x7/2 conv -> BN -> ReLU -> 3x3/2 max pool, then four stages of
  residual blocks (3x3 conv -> BN -> ReLU -> 3x3 conv -> BN, a 1x1 conv + BN
  shortcut where the shape changes, add, ReLU), each stage followed by
  squeeze-and-excitation (mean over H, W -> C/r -> ReLU -> C -> sigmoid ->
  scale) and, in stages 3 and 4, spatial attention (channel max and mean ->
  7x7 conv 2 -> 1 -> sigmoid -> scale); either is left out where the
  configuration turns it off;
- text: embedding * sqrt(d) + the sinusoidal table, pre-norm layers of
  multi-head self-attention (scores masked with -1e9) and a ReLU FFN, a
  final LayerNorm (eps 1e-6 everywhere in the text and fusion parts);
- fusion: the 7x7 feature map projected to 49 tokens (Linear, LayerNorm,
  + a learned position table), cross-attention layers with the question
  as query (pre-norm on query and key/value, residual, 4d FFN), masked
  means of the attended and of the text features, a sigmoid gate, LayerNorm;
- head: Linear -> ReLU -> Linear -> ReLU -> Linear, then softmax.

Weights come as a state_dict in the reference layout (the keys that
`param_shapes` lists); the forward reads nothing else. `quant`, when given,
rounds every operand of a convolution, a linear layer and an attention
product before it is used: the lower-precision control of the benchmark's
comparison (`fp8`).

This module imports torch and numpy only.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
LN_EPS = 1e-6
NEG_INF = -1e9
FP8_MAX = 448.0  # the largest finite float8_e4m3fn

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to the format's largest finite value, then scaled
    back to float32: what an fp8 operand of a product holds."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def stage_specs(cfg: dict):
    """(stage, in channels, out channels, stride, spatial attention) per
    stage."""
    c = list(cfg["stage_channels"])
    spatial = cfg["use_spatial_attention"]
    return [(1, c[0], c[0], 1, False), (2, c[0], c[1], 2, False),
            (3, c[1], c[2], 2, spatial), (4, c[2], c[3], 2, spatial)]


def param_shapes(cfg: dict) -> "OrderedDict[str, Tuple[Tuple[int, ...], str]]":
    """Every state_dict entry of the model: key -> (shape, kind). The kind
    says how the benchmark draws it (`harness/weights.py`)."""
    out: "OrderedDict[str, Tuple[Tuple[int, ...], str]]" = OrderedDict()

    def conv(key, cout, cin, k):
        out[key + ".weight"] = ((cout, cin, k, k), "conv")

    def bn(key, c):
        for leaf, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                           ("running_mean", "bn_mean"), ("running_var", "bn_var")):
            out[f"{key}.{leaf}"] = ((c,), kind)
        out[key + ".num_batches_tracked"] = ((), "count")

    def linear(key, fout, fin, bias=True, kind="linear"):
        out[key + ".weight"] = ((fout, fin), kind)
        if bias:
            out[key + ".bias"] = ((fout,), "bias")

    def ln(key, d):
        out[key + ".weight"] = ((d,), "ln_weight")
        out[key + ".bias"] = ((d,), "ln_bias")

    c0 = cfg["stage_channels"][0]
    conv("image_encoder.stem.0", c0, cfg["in_channels"], 7)
    bn("image_encoder.stem.1", c0)
    for i, cin, cout, stride, spatial in stage_specs(cfg):
        for b in range(cfg["blocks_per_stage"][i - 1]):
            p = f"image_encoder.stage{i}.blocks.{b}"
            bin_ = cin if b == 0 else cout
            conv(p + ".conv1", cout, bin_, 3)
            bn(p + ".bn1", cout)
            conv(p + ".conv2", cout, cout, 3)
            bn(p + ".bn2", cout)
            if b == 0 and (stride != 1 or cin != cout):
                conv(p + ".downsample.0", cout, cin, 1)
                bn(p + ".downsample.1", cout)
        if cfg["use_se_attention"]:
            r = max(cout // cfg["se_reduction"], 1)
            linear(f"image_encoder.stage{i}.attention.se.fc1", r, cout, bias=False)
            linear(f"image_encoder.stage{i}.attention.se.fc2", cout, r, bias=False)
        if spatial:
            k = cfg["spatial_kernel_size"]
            out[f"image_encoder.stage{i}.attention.spatial.conv.weight"] = ((1, 2, k, k), "conv")

    d, L = cfg["embed_dim"], cfg["max_question_length"]
    out["text_encoder.token_embedding.weight"] = ((cfg["vocab_size"], d), "embedding")
    out["text_encoder.positional_encoding.pe"] = ((1, L, d), "sinusoid")
    for n in range(cfg["num_transformer_layers"]):
        p = f"text_encoder.layers.{n}"
        ln(p + ".norm1", d)
        for w in ("W_q", "W_k", "W_v", "W_o"):
            linear(f"{p}.self_attention.{w}", d, d, bias=False)
        ln(p + ".norm2", d)
        linear(p + ".ffn.fc1", cfg["ffn_hidden_dim"], d)
        linear(p + ".ffn.fc2", d, cfg["ffn_hidden_dim"])
    ln("text_encoder.final_norm", d)

    s = cfg["feature_spatial_size"]
    out["fusion.image_projector.position_embedding"] = ((1, s * s, d), "position")
    linear("fusion.image_projector.projection.0", d, cfg["stage_channels"][-1])
    ln("fusion.image_projector.projection.1", d)
    for n in range(cfg["num_cross_layers"]):
        p = f"fusion.cross_attention.layers.{n}"
        ln(p + ".norm_query", d)
        ln(p + ".norm_kv", d)
        for w in ("W_q", "W_k", "W_v", "W_o"):
            linear(f"{p}.cross_attention.{w}", d, d, bias=False, kind="xavier")
        ln(p + ".norm_ffn", d)
        linear(p + ".ffn.0", 4 * d, d)
        linear(p + ".ffn.3", d, 4 * d)
    if cfg["use_gating"]:
        linear("fusion.gate.gate.0", d, 2 * d)
    ln("fusion.output_norm", d)
    h = cfg["answer_hidden_dim"]
    linear("answer_head.classifier.0", h, d, kind="xavier")
    linear("answer_head.classifier.3", h // 2, h, kind="xavier")
    linear("answer_head.classifier.6", cfg["num_answers"], h // 2, kind="xavier")
    return out


def sinusoid(max_length: int, d: int) -> np.ndarray:
    """[max_length, d]: sin at even, cos at odd columns, wavelength
    10000^(2i/d)."""
    pe = np.zeros((max_length, d), dtype=np.float32)
    pos = np.arange(max_length, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32) * (-math.log(10000.0) / d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: d // 2])
    return pe


class Reference:
    """The forward of one configuration over one state_dict."""

    def __init__(self, cfg: dict, state: Dict[str, torch.Tensor], quant: Quant = None):
        self.cfg = cfg
        self.w = state
        self.q = quant or (lambda t: t)

    # -- products, each operand through `quant` --------------------------
    def conv(self, x, key, stride=1, padding=0):
        return F.conv2d(self.q(x), self.q(self.w[key + ".weight"]), None, stride, padding)

    def linear(self, x, key, bias=True):
        b = self.w[key + ".bias"] if bias else None
        return F.linear(self.q(x), self.q(self.w[key + ".weight"]), b)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))

    # -- norms -------------------------------------------------------------
    def bn(self, x, key):
        w = self.w
        scale = w[key + ".weight"] / torch.sqrt(w[key + ".running_var"] + BN_EPS)
        shift = w[key + ".bias"] - w[key + ".running_mean"] * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]

    def ln(self, x, key):
        return F.layer_norm(x, x.shape[-1:], self.w[key + ".weight"], self.w[key + ".bias"],
                            LN_EPS)

    # -- the model ----------------------------------------------------------
    def backbone(self, pixels: torch.Tensor) -> torch.Tensor:
        """uint8 [B, S, S, 3] -> features [B, S/32, S/32, C4]."""
        cfg = self.cfg
        x = pixels.to(torch.float32) / 255.0
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        std = torch.tensor(IMAGENET_STD, device=x.device)
        x = ((x - mean) / std).permute(0, 3, 1, 2)
        x = torch.relu(self.bn(self.conv(x, "image_encoder.stem.0", 2, 3), "image_encoder.stem.1"))
        x = F.max_pool2d(x, 3, 2, 1)
        for i, cin, cout, stride, spatial in stage_specs(cfg):
            for b in range(cfg["blocks_per_stage"][i - 1]):
                p = f"image_encoder.stage{i}.blocks.{b}"
                s = stride if b == 0 else 1
                y = torch.relu(self.bn(self.conv(x, p + ".conv1", s, 1), p + ".bn1"))
                y = self.bn(self.conv(y, p + ".conv2", 1, 1), p + ".bn2")
                if b == 0 and (stride != 1 or cin != cout):
                    x = self.bn(self.conv(x, p + ".downsample.0", stride), p + ".downsample.1")
                x = torch.relu(y + x)
            a = f"image_encoder.stage{i}.attention"
            if cfg["use_se_attention"]:
                pooled = x.mean(dim=(2, 3))
                hidden = torch.relu(self.linear(pooled, a + ".se.fc1", bias=False))
                x = x * torch.sigmoid(self.linear(hidden, a + ".se.fc2", bias=False))[:, :, None, None]
            if spatial:
                k = cfg["spatial_kernel_size"]
                m = torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], 1)
                x = x * torch.sigmoid(self.conv(m, a + ".spatial.conv", 1, k // 2))
        return x.permute(0, 2, 3, 1)

    def attention(self, query, kv, key, heads, mask=None):
        """Multi-head attention with bias-free projections; `mask` [B, Lkv]
        hides keys where it is 0."""
        b, lq, d = query.shape
        lkv, dh = kv.shape[1], d // heads

        def split(t, n):
            return t.reshape(b, n, heads, dh).transpose(1, 2)

        q = split(self.linear(query, key + ".W_q", bias=False), lq)
        k = split(self.linear(kv, key + ".W_k", bias=False), lkv)
        v = split(self.linear(kv, key + ".W_v", bias=False), lkv)
        scores = self.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
        if mask is not None:
            scores = scores.masked_fill(mask[:, None, None, :] == 0, NEG_INF)
        ctx = self.matmul(torch.softmax(scores, dim=-1), v)
        return self.linear(ctx.transpose(1, 2).reshape(b, lq, d), key + ".W_o", bias=False)

    @staticmethod
    def masked_mean(x, mask):
        m = mask[..., None].to(x.dtype)
        return (x * m).sum(1) / m.sum(1).clamp(min=1)

    def text(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg, d = self.cfg, self.cfg["embed_dim"]
        x = F.embedding(ids.long(), self.w["text_encoder.token_embedding.weight"]) * math.sqrt(d)
        x = x + self.w["text_encoder.positional_encoding.pe"][:, : ids.shape[1]]
        for n in range(cfg["num_transformer_layers"]):
            p = f"text_encoder.layers.{n}"
            h = self.ln(x, p + ".norm1")
            x = x + self.attention(h, h, p + ".self_attention", cfg["num_attention_heads"], mask)
            h = torch.relu(self.linear(self.ln(x, p + ".norm2"), p + ".ffn.fc1"))
            x = x + self.linear(h, p + ".ffn.fc2")
        return self.ln(x, "text_encoder.final_norm")

    def logits(self, pixels: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """uint8 pixels [B, S, S, 3], token ids and mask [B, L] -> logits
        [B, num_answers], float32."""
        cfg = self.cfg
        feats = self.backbone(pixels)
        b, h, w, c = feats.shape
        text = self.text(ids, mask)
        img = self.linear(feats.reshape(b, h * w, c), "fusion.image_projector.projection.0")
        img = self.ln(img, "fusion.image_projector.projection.1")
        img = img + self.w["fusion.image_projector.position_embedding"][:, : h * w]
        query = text
        for n in range(cfg["num_cross_layers"]):
            p = f"fusion.cross_attention.layers.{n}"
            query = query + self.attention(self.ln(query, p + ".norm_query"),
                                           self.ln(img, p + ".norm_kv"),
                                           p + ".cross_attention", cfg["num_attention_heads"])
            hidden = torch.relu(self.linear(self.ln(query, p + ".norm_ffn"), p + ".ffn.0"))
            query = query + self.linear(hidden, p + ".ffn.3")
        attended, pooled = self.masked_mean(query, mask), self.masked_mean(text, mask)
        if cfg["use_gating"]:
            g = torch.sigmoid(self.linear(torch.cat([attended, pooled], -1), "fusion.gate.gate.0"))
            fused = g * attended + (1 - g) * pooled
        else:
            fused = attended + pooled
        x = self.ln(fused, "fusion.output_norm")
        x = torch.relu(self.linear(x, "answer_head.classifier.0"))
        x = torch.relu(self.linear(x, "answer_head.classifier.3"))
        return self.linear(x, "answer_head.classifier.6")

    def log_probs(self, pixels, ids, mask) -> torch.Tensor:
        return torch.log_softmax(self.logits(pixels, ids, mask), dim=-1)


@torch.no_grad()
def log_probs_in_blocks(cfg: dict, state: Dict[str, torch.Tensor], pixels: torch.Tensor,
                        ids: torch.Tensor, mask: torch.Tensor, block: int = 256,
                        quant: Quant = None) -> torch.Tensor:
    """log softmax of the reference over rows in blocks of `block`, with
    TF32 off; inputs on the device the state lives on; result on the CPU."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = Reference(cfg, state, quant)
        return torch.cat([ref.log_probs(pixels[i:i + block], ids[i:i + block],
                                        mask[i:i + block]).cpu()
                          for i in range(0, pixels.shape[0], block)])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
