"""The Kimi-Linear configuration's weights, drawn from the seed on the device.

One `torch.Generator` on the device, seeded once, draws each tensor of
`reference/kimi_linear_vqa.py:param_shapes` in its order, by its kind: the
rules of `harness/decoder_weights.py` for the kinds it knows (convolutions,
BatchNorm, linear layers, biases, the embedding, RMSNorm and LayerNorm
weights, the router's bias), and for Kimi Delta Attention's own:

- the short convolutions' weights [C, 1, W]: N(0, 1/W), 1/4 at 4 taps;
- `A_log`: log U(1, 16), as fla initialises it;
- `dt_bias`: the inverse softplus of dt, log-uniform in [0.001, 0.1], as
  fla initialises it.

Tensor by tensor, stored in `dtype` (bfloat16 for the deployment), so the
program and the reference read the same values.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.kimi_linear_vqa import param_shapes


def _draw(kind: str, shape, g: torch.Generator, device) -> torch.Tensor:
    if kind in ("bn_weight", "bn_var"):
        return 0.5 + torch.rand(shape, generator=g, device=device)
    if kind == "a_log":
        return torch.log(1.0 + 15.0 * torch.rand(shape, generator=g, device=device))
    if kind == "dt_bias":
        u = torch.rand(shape, generator=g, device=device)
        dt = torch.exp(math.log(1e-3) + u * (math.log(0.1) - math.log(1e-3)))
        return dt + torch.log(-torch.expm1(-dt))
    z = torch.randn(shape, generator=g, device=device)
    if kind == "conv":
        return z * math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    if kind == "short_conv":
        return z * math.sqrt(1.0 / shape[-1])
    if kind == "linear":
        return z * math.sqrt(1.0 / shape[1])
    if kind == "bias":
        return z * 0.02
    if kind == "embedding":
        return z
    if kind in ("ln_weight", "rms_weight"):
        return 1.0 + 0.1 * z
    if kind == "ln_bias":
        return 0.05 * z
    if kind in ("bn_bias", "bn_mean", "router_bias"):
        return 0.1 * z
    raise ValueError(f"no rule to draw a {kind!r} entry")


def make_state(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for key, (shape, kind) in param_shapes(cfg).items():
        if kind == "count":
            out[key] = torch.zeros((), dtype=torch.int64, device=device)
        else:
            out[key] = _draw(kind, shape, g, device).to(dtype)
    return out
