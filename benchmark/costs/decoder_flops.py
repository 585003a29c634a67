"""Operations of the decoder VQA model's forward per pair, and the bound of
its routed experts, from a configuration's widths.

`forward_flops(cfg, routed_rows=None)` counts every multiply-add of a
product as 2 operations, as `costs/flops.py` does, by part: the backbone
(`costs/flops.py`'s stem and stages), the projector, each decoder layer's
attention (the four projections and both attention products over the
image and question positions), the dense MLP, the router, the shared
experts, the routed experts and the answer head (at the last position
only). The routed experts compute the rows routed to the held experts:
`routed_rows`, the rows per pair summed over the MoE layers, where the
caller counted them; else the expected count, each token's
`num_experts_per_tok` choices falling on the `experts_held` of
`router_experts` evenly. `tests/test_bench_decoder.py` holds the
count to `torch.utils.flop_counter.FlopCounterMode` on a CPU forward of
the plain reference, with the reference's own routed rows.

`routed_bound_s(cfg, tokens, rows)` is the least time the routed path of
one forward could take on the H100: for each MoE layer, with `rows`
routed rows (the forward's, spread evenly over the MoE layers), the sum
of each step's bound, the larger of its bytes at 3.35 TB/s and its
operations at the bf16 peak: the permute (each routed row read and
written), the first grouped GEMM (the rows, the held experts' gate and up
weights, its output), the SwiGLU, the second grouped GEMM and the
unpermute (the rows, the shared experts' output and the layer's output,
`tokens` rows each). Each input read once, each output written once, in
bf16.

`ROUTED_KERNELS` names the device functions of the routed path in a
profiler trace (compared whole with `harness/trace.py:kernel_base`), with
the launches each makes per MoE layer: the port's gather and combine and
the grouped GEMM's set-up kernel; `ROUTED_SWIGLU` finds the port's SwiGLU
kernel in its routed form by its template argument (the dense SwiGLUs
launch the same kernel as `swiglu_bf16<false>`); `GROUPED_GEMM` finds the
grouped GEMM that PyTorch's `grouped_mm` launches on the H100 by marks in
its mangled name. A change that swaps the grouped GEMM's implementation
changes those names; the benchmark's lists have to follow.
"""

from __future__ import annotations

from typing import Dict, Optional

from benchmark.costs.flops import forward_flops as reference_flops
from benchmark.costs.peaks import BF16_FLOP_PER_S, HBM_BYTES_PER_S

# device functions of the routed path by the name `harness/trace.py:kernel_base`
# gives them -> launches per MoE layer of one forward
ROUTED_KERNELS = {"moe_gather_bf16": 1, "moe_combine_bf16": 1, "prepare_grouped_gemm_data": 2}
# the SwiGLU of the routed rows: the name that holds this mark, and its
# launches per MoE layer
ROUTED_SWIGLU = ("swiglu_bf16<true>", 1)
# the grouped GEMM, PyTorch's CUTLASS kernel for sm90, whose name a trace
# gives mangled, with no base name: the name that holds each of these
# marks, and its launches per MoE layer
GROUPED_GEMM = (("cutlass13device_kernel", "GroupProblemShape"), 2)


def positions(cfg: dict) -> int:
    return cfg["feature_spatial_size"] ** 2 + cfg["max_question_length"]


def moe_layers(cfg: dict) -> int:
    return cfg["decoder_layers"] - cfg["decoder_dense_layers"]


def expected_rows(cfg: dict) -> float:
    """Routed rows per pair over the MoE layers, the choices spread evenly."""
    return (positions(cfg) * moe_layers(cfg) * cfg["num_experts_per_tok"]
            * cfg["experts_held"] / cfg["router_experts"])


def forward_flops(cfg: dict, routed_rows: Optional[float] = None) -> Dict[str, float]:
    """Operations per pair of one forward, by part; `total` sums them."""
    parts = {k: v for k, v in reference_flops(cfg).items() if k.startswith(("stem", "stage"))}
    d, c, t = cfg["decoder_hidden"], cfg["stage_channels"][-1], cfg["feature_spatial_size"] ** 2
    n = positions(cfg)
    h, nope, rope, v, r = (cfg["decoder_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                           cfg["v_head_dim"], cfg["kv_lora_rank"])
    parts["projector"] = 2 * t * (c * d + d * d)
    parts["attention"] = cfg["decoder_layers"] * 2 * (
        n * d * h * (nope + rope) + n * d * (r + rope) + n * r * h * (nope + v)
        + n * h * v * d + h * n * n * (nope + rope) + h * n * n * v)
    parts["dense_mlp"] = cfg["decoder_dense_layers"] * 2 * 3 * n * d * cfg["decoder_ffn_dim"]
    width = cfg["moe_intermediate_size"]
    parts["router"] = moe_layers(cfg) * 2 * n * d * cfg["router_experts"]
    parts["shared_experts"] = moe_layers(cfg) * 2 * 3 * n * d * width * cfg["n_shared_experts"]
    rows = expected_rows(cfg) if routed_rows is None else routed_rows
    parts["routed_experts"] = 2 * 3 * rows * d * width
    a = cfg["answer_hidden_dim"]
    parts["head"] = 2 * (d * a + a * (a // 2) + (a // 2) * cfg["num_answers"])
    parts["total"] = sum(parts.values())
    return parts


def routed_bound_s(cfg: dict, tokens: int, rows: float) -> float:
    """The least seconds of the routed path of one forward of `tokens`
    tokens that routed `rows` rows to the held experts (module docstring)."""
    d, width, held, e = (cfg["decoder_hidden"], cfg["moe_intermediate_size"],
                         cfg["experts_held"], 2)
    layers = moe_layers(cfg)
    r = rows / layers

    def bound(nbytes, flops=0.0):
        return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)

    per_layer = (bound(2 * r * d * e)
                 + bound(e * (r * d + held * 2 * width * d + r * 2 * width), 2 * r * d * 2 * width)
                 + bound(e * (r * 2 * width + r * width))
                 + bound(e * (r * width + held * d * width + r * d), 2 * r * width * d)
                 + bound(e * (r * d + 2 * tokens * d)))
    return layers * per_layer
