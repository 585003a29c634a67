"""Operations of the hybrid decoder VQA model's forward per pair, and the
bound of its linear attention core, from a configuration's widths.

`forward_flops(cfg, routed_rows=None)` counts every multiply-add of a
product as 2 operations, as `costs/decoder_flops.py` does, by part: the
backbone, the projector, the KDA layers' six products of x and their
f_b, g_b and o projections (`kda_projections`), the KDA core's two
products a position, S^T k and S^T q (`kda_core`, 4·K·V a token a head), its
rank-1 update S + k u^T (`kda_update`, 2·K·V), the MLA layers (the four
projections and both attention products over the image and question
positions), the dense MLP, the router, the shared experts, the routed
experts and the answer head (at the last position only). The routed
experts compute `routed_rows` rows per pair summed over the MoE layers,
where the caller counted them; else the expected count, each token's
`num_experts_per_tok` choices falling on the `experts_held` of
`router_experts` evenly (8 x 32/256 a token at the benchmark's cut). The
convolutions' taps, the gates, the norms and the decay multiply are not
products and are left out. `tests/test_bench_kda.py` holds the count,
`kda_update` aside (the reference writes that update as an elementwise
product, which the counter does not count), to
`torch.utils.flop_counter.FlopCounterMode` on a CPU forward of the plain
reference.

`kda_bound_s(cfg, tokens)` is the least time the KDA core of one forward
of `tokens` tokens could take on the H100: for each KDA layer, the larger
of its bytes at 3.35 TB/s and its 6·K·V operations a token a head at the
bf16 peak. Bytes: its inputs read once (q, k and v before their
convolutions, the decay's low-rank output f_b_proj(f_a_proj(x)) and β's
logits) and o written once, in bf16. A function of the widths, not of an
implementation.

`KDA_KERNELS` names the device functions of the KDA core in a profiler
trace (compared whole with `harness/trace.py:kernel_base`), with the
launches each makes per KDA layer of one forward.
"""

from __future__ import annotations

from typing import Dict, Optional

from benchmark.costs.decoder_flops import expected_rows, moe_layers, positions
from benchmark.costs.flops import forward_flops as reference_flops
from benchmark.costs.peaks import BF16_FLOP_PER_S, HBM_BYTES_PER_S

KDA_KERNELS = {"kda_recurrence_bf16": 1}
BF16_BYTES = 2


def kda_layers(cfg: dict) -> int:
    return len(cfg["kda_layers"])


def forward_flops(cfg: dict, routed_rows: Optional[float] = None) -> Dict[str, float]:
    """Operations per pair of one forward, by part; `total` sums them."""
    parts = {k: v for k, v in reference_flops(cfg).items() if k.startswith(("stem", "stage"))}
    d, c, t = cfg["decoder_hidden"], cfg["stage_channels"][-1], cfg["feature_spatial_size"] ** 2
    n = positions(cfg)
    parts["projector"] = 2 * t * (c * d + d * d)
    hk, dk = cfg["kda_heads"], cfg["kda_head_dim"]
    width, kda = hk * dk, kda_layers(cfg)
    parts["kda_projections"] = kda * 2 * n * (d * (3 * width + 2 * dk + hk) + 2 * dk * width
                                              + width * d)
    parts["kda_core"] = kda * 2 * n * hk * 2 * dk * dk
    parts["kda_update"] = kda * 2 * n * hk * dk * dk
    h, nope, rope, v, r = (cfg["decoder_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                           cfg["v_head_dim"], cfg["kv_lora_rank"])
    parts["mla"] = (cfg["decoder_layers"] - kda) * 2 * (
        n * d * h * (nope + rope) + n * d * (r + rope) + n * r * h * (nope + v)
        + n * h * v * d + h * n * n * (nope + rope) + h * n * n * v)
    parts["dense_mlp"] = cfg["decoder_dense_layers"] * 2 * 3 * n * d * cfg["decoder_ffn_dim"]
    width_e = cfg["moe_intermediate_size"]
    parts["router"] = moe_layers(cfg) * 2 * n * d * cfg["router_experts"]
    parts["shared_experts"] = moe_layers(cfg) * 2 * 3 * n * d * width_e * cfg["n_shared_experts"]
    rows = expected_rows(cfg) if routed_rows is None else routed_rows
    parts["routed_experts"] = 2 * 3 * rows * d * width_e
    a = cfg["answer_hidden_dim"]
    parts["head"] = 2 * (d * a + a * (a // 2) + (a // 2) * cfg["num_answers"])
    parts["total"] = sum(parts.values())
    return parts


def kda_bound_s(cfg: dict, tokens: int) -> float:
    """The least seconds of the KDA cores of one forward of `tokens`
    tokens (module docstring)."""
    hk, dk = cfg["kda_heads"], cfg["kda_head_dim"]
    width = hk * dk
    nbytes = tokens * BF16_BYTES * ((3 + 1) * width + hk + width)
    flops = tokens * hk * 6 * dk * dk
    return kda_layers(cfg) * max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
