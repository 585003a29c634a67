"""The decoder configuration's weights, drawn from the seed on the device.

One `torch.Generator` on the device, seeded once, draws each tensor of
`reference/decoder_vqa.py:param_shapes` in its order, by its kind:

- convolutions: N(0, 2 / fan_out) (Kaiming, fan-out); BatchNorm: weight
  uniform in [0.5, 1.5), bias N(0, 0.1), running mean N(0, 0.1), running
  variance uniform in [0.5, 1.5) (the reference model's rules,
  `harness/weights.py`);
- linear layers (every projection, expert, router and head weight):
  N(0, 1 / fan_in); biases N(0, 0.02);
- the token embedding N(0, 1), of the image tokens' scale;
- RMSNorm weights (`rms_weight`) 1 + 0.1 z; the projector's LayerNorm:
  weight 1 + 0.1 z, bias 0.05 z;
- the router's `e_score_correction_bias` N(0, 0.1).

Tensor by tensor, so that no more than the largest tensor's draw is held
beside the state, and stored in `dtype`: bfloat16 for the deployment, as
Kimi-VL publishes its weights, so the program and the reference read the
same values.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.decoder_vqa import param_shapes


def make_state(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for key, (shape, kind) in param_shapes(cfg).items():
        if kind == "count":
            out[key] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        if kind in ("bn_weight", "bn_var"):
            t = 0.5 + torch.rand(shape, generator=g, device=device)
        else:
            z = torch.randn(shape, generator=g, device=device)
            if kind == "conv":
                t = z * math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
            elif kind == "linear":
                t = z * math.sqrt(1.0 / shape[1])
            elif kind == "bias":
                t = z * 0.02
            elif kind == "embedding":
                t = z
            elif kind in ("ln_weight", "rms_weight"):
                t = 1.0 + 0.1 * z
            elif kind == "ln_bias":
                t = 0.05 * z
            elif kind in ("bn_bias", "bn_mean", "router_bias"):
                t = 0.1 * z
            else:
                raise ValueError(f"{key}: no rule to draw a {kind!r} entry")
        out[key] = t.to(dtype)
    return out
