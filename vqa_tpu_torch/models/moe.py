"""DeepSeek-V3's mixture of experts: a sigmoid router over every routed
expert, the experts this rank holds, and shared experts.

``MoE`` is DeepSeek-V3's ``DeepseekV3MoE`` in inference, the MoE layer of
both decoders ``models/decoder.py`` builds: Kimi-VL-A3B's (64 experts, 6 a
token, 2 shared) and Kimi-Linear-48B-A3B's (256 experts, 8 a token, 1
shared; its ``moe_router_activation_func`` sigmoid and ``moe_renormalize``
are this rule), told which experts it holds:

- the router (``MoEGate``, ``topk_method="noaux_tc"`` with one group)
  computes its logits and their sigmoid in f32 from the f32 weight, picks
  each token's top ``num_experts_per_tok`` by the score plus
  ``e_score_correction_bias``, and weights them by the unbiased scores,
  normalised to sum to 1 and scaled by ``routed_scaling_factor``; on the
  card as one kernel (``ops.moe_route``), from a compute copy of the
  weight as three bf16 planes that sum to it exactly (``route_tiles``);
- the layer holds experts ``[expert_offset, expert_offset + experts_held)``
  of the router's ``router_experts`` and computes their part of the result
  for the tokens routed to them: the layer of one rank of an
  expert-parallel group, run without the exchange. What the experts held
  elsewhere would add is left out;
- the shared experts (one SwiGLU of ``n_shared_experts`` experts' width)
  see every token, and their output is added once.

The routed path on the card (bf16) runs inside a CUDA graph, since nothing
in it waits on the host: the (token, choice) pairs are sorted on the
device by held expert, in a stable order, with the pairs of experts held
elsewhere last (``ops.moe_plan``); ``ops.moe_gather`` permutes the routed
rows, two grouped GEMMs (``torch.nn.functional.grouped_mm`` or
``torch._grouped_mm``) read each expert's end row from the device,
``ops.fused_swiglu`` applies the SwiGLU to the routed rows and
``ops.moe_combine`` weights each token's rows, sums them in f32 and adds
its shared row. The buffers have a row for
every pair, the most that can come; only the rows routed here are
computed. On the CPU the layer runs its plain form, a loop over the held
experts, in any dtype; on the card it takes bf16 only and refuses any
other dtype (the grouped GEMMs and the kernels are bf16).

Each forward also returns the rows routed to each held expert (int32),
which the serving engine reads with the probabilities. State_dict keys
follow the published checkpoint's: ``gate.weight``,
``gate.e_score_correction_bias``, ``experts.{e}.gate_proj.weight`` (``e``
the expert's global index), ``shared_experts.up_proj.weight``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from vqa_tpu_torch.models.layers import ComputeCopies, Linear
from vqa_tpu_torch.ops.moe_kernel import (fused_swiglu, moe_combine, moe_gather, moe_plan,
                                           moe_route, route_tiles)


def on_card_in_bf16(t: torch.Tensor, what: str) -> bool:
    """Whether ``t`` takes the card's path: True for a bf16 tensor off the
    CPU, False on the CPU; raises for any other dtype off the CPU."""
    if t.device.type == "cpu":
        return False
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{what} runs on {t.device.type} in bfloat16 only, got {t.dtype}")
    return True


def swiglu(h: torch.Tensor) -> torch.Tensor:
    """[..., 2I] (gate, then up) → silu(gate) * up, in f32 and rounded
    once: ``ops.fused_swiglu`` on the card (bf16 only)."""
    if on_card_in_bf16(h, "the SwiGLU"):
        out = fused_swiglu(h.reshape(-1, h.shape[-1]))
        return out.view(*h.shape[:-1], out.shape[-1])
    width = h.shape[-1] // 2
    return (F.silu(h[..., :width].float()) * h[..., width:].float()).to(h.dtype)


class SwiGLU(ComputeCopies, nn.Module):
    """DeepSeek-V3's MLP, down(silu(gate(x)) * up(x)), its gate and up
    projections computed as one product (a compute copy of both weights,
    ``w13``)."""

    copied = ("w13",)

    def __init__(self, hidden: int, width: int):
        super().__init__()
        self.gate_proj = nn.Linear(hidden, width, bias=False)
        self.up_proj = nn.Linear(hidden, width, bias=False)
        self.down_proj = Linear(width, hidden, bias=False)
        self.init_copies()

    @property
    def w13(self) -> torch.Tensor:
        return torch.cat([self.gate_proj.weight, self.up_proj.weight])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(swiglu(F.linear(x, self.compute("w13"))))


class Expert(nn.Module):
    """One routed expert's weights; ``MoE`` computes with them."""

    def __init__(self, hidden: int, width: int):
        super().__init__()
        self.gate_proj = nn.Linear(hidden, width, bias=False)
        self.up_proj = nn.Linear(hidden, width, bias=False)
        self.down_proj = nn.Linear(width, hidden, bias=False)


class MoEGate(ComputeCopies, nn.Module):
    """The router: (expert ids [T, k] int32, weights [T, k] f32) of each
    token (see the module docstring). On the card its weight is computed
    with as a compute copy of its three bf16 planes, laid out for the
    kernel (``route_tiles``); the CPU computes from the f32 weight."""

    copied = ("tiles",)

    def __init__(self, hidden: int, experts: int, top_k: int, scaling: float):
        super().__init__()
        self.top_k, self.scaling = top_k, scaling
        self.weight = nn.Parameter(torch.empty(experts, hidden))
        self.e_score_correction_bias = nn.Parameter(torch.zeros(experts))
        self.init_copies()

    @property
    def tiles(self) -> torch.Tensor:
        return route_tiles(self.weight.detach())

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        tiles = self.compute("tiles") if on_card_in_bf16(x, "the router") else None
        return moe_route(x, self.weight, self.e_score_correction_bias, self.top_k,
                         self.scaling, tiles)


def grouped_mm(a: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Rows [ends[e-1], ends[e]) of ``a`` times ``w[e]``ᵀ ([G, N, K], each a
    Linear's weight) for each group e; rows past ``ends[-1]`` are not
    computed."""
    fn = getattr(F, "grouped_mm", None) or torch._grouped_mm
    return fn(a, w.transpose(1, 2), offs=ends)


class MoE(ComputeCopies, nn.Module):
    """``forward(x [T, D]) -> (out [T, D], rows routed to each held expert
    [experts_held] int32)``. The held experts' weights are computed with as
    two stacked compute copies, ``w13`` [held, 2I, D] (gate, then up) and
    ``w2`` [held, D, I]."""

    copied = ("w13", "w2")

    def __init__(self, hidden: int, width: int, experts: int, top_k: int, shared: int,
                 scaling: float, held: int, offset: int):
        super().__init__()
        if not 0 <= offset < offset + held <= experts:
            raise ValueError(f"experts [{offset}, {offset + held}) are not among the "
                             f"router's {experts}")
        self.held, self.offset = held, offset
        self.gate = MoEGate(hidden, experts, top_k, scaling)
        self.experts = nn.ModuleDict({str(e): Expert(hidden, width)
                                      for e in range(offset, offset + held)})
        self.shared_experts = SwiGLU(hidden, width * shared)
        self.init_copies()

    @property
    def w13(self) -> torch.Tensor:
        return torch.stack([torch.cat([e.gate_proj.weight, e.up_proj.weight])
                            for e in self.experts.values()])

    @property
    def w2(self) -> torch.Tensor:
        return torch.stack([e.down_proj.weight for e in self.experts.values()])

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        grouped = on_card_in_bf16(x, "the MoE layer")
        with record_function("moe.router"):
            idx, w = self.gate(x)
        with record_function("moe.shared"):
            shared = self.shared_experts(x)
        with record_function("moe.routed"):
            if grouped:
                return self._grouped(x, idx, w, shared)
            return self._loop(x, idx, w, shared)

    def _grouped(self, x, idx, w, shared):
        """The routed path on the card (module docstring): no host sync."""
        src, ends, slot, counts = moe_plan(idx, self.offset, self.held)
        total = ends[-1:]
        h = grouped_mm(moe_gather(x, src, total), self.compute("w13"), ends)
        y = grouped_mm(fused_swiglu(h, total), self.compute("w2"), ends)
        return moe_combine(y, slot, w, shared), counts

    def _loop(self, x, idx, w, shared):
        """The plain form: each held expert over the tokens routed to it."""
        w13, w2 = self.compute("w13"), self.compute("w2")
        acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        counts = torch.zeros(self.held, dtype=torch.int32, device=x.device)
        for e in range(self.held):
            tok, choice = torch.nonzero(idx == self.offset + e, as_tuple=True)
            counts[e] = tok.numel()
            if tok.numel():
                y = F.linear(swiglu(F.linear(x[tok], w13[e])), w2[e])
                acc.index_add_(0, tok, w[tok, choice, None] * y.float())
        return acc.to(x.dtype) + shared, counts
