"""The port's kernels: each a hand-written CUDA kernel for Hopper behind a
wrapper, with its plain PyTorch version beside it.

Each wrapper counts its kernel launches in a plain integer attribute
(``fused_stem.launches``, ``fused_stem_bf16.launches`` …), under one lock, since kernels launch from
several threads; ``launch_counts`` reads them and ``reset_launch_counts``
zeroes them, so a run can show which kernels the main path went through.
A CUDA graph's replay launches kernels without calling a wrapper, so the
serving engine adds the launches it recorded at capture on every replay
(``add_launch_counts``).
"""

from vqa_tpu_torch.ops._build import add_launches, reset_launches
from vqa_tpu_torch.ops.cross_attention_kernel import (  # noqa: F401
    fused_cross_attention,
    fused_cross_attention_bf16,
    plain_cross_attention,
)
from vqa_tpu_torch.ops.kda_kernel import kda_attention, plain_kda_attention  # noqa: F401
from vqa_tpu_torch.ops.mla_kernel import mla_attention, plain_mla_attention  # noqa: F401
from vqa_tpu_torch.ops.moe_kernel import (  # noqa: F401
    fused_swiglu,
    moe_combine,
    moe_gather,
    moe_plan,
    moe_route,
)
from vqa_tpu_torch.ops.se_kernel import fused_se, fused_se_bf16, plain_se  # noqa: F401
from vqa_tpu_torch.ops.stem_kernel import fused_stem, fused_stem_bf16, plain_stem  # noqa: F401

# each kernel's f32 and bf16 forms, counted apart (the f32 wrappers route
# bf16 inputs to the bf16 forms), the MoE kernels and the decoder's attention
KERNELS = {
    "stem": fused_stem,
    "se": fused_se,
    "cross_attention": fused_cross_attention,
    "stem_bf16": fused_stem_bf16,
    "se_bf16": fused_se_bf16,
    "cross_attention_bf16": fused_cross_attention_bf16,
    # the MoE layer's router and route plan, its routed rows, and every
    # SwiGLU (routed and dense), bf16 only
    "moe_route": moe_route,
    "moe_plan": moe_plan,
    "moe_gather": moe_gather,
    "swiglu": fused_swiglu,
    "moe_combine": moe_combine,
    # the decoder's attention cores, bf16 only: latent and linear attention
    "mla_attention": mla_attention,
    "kda_attention": kda_attention,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` ({name: launches}, names of ``KERNELS``) to the counters."""
    add_launches((KERNELS[name], n) for name, n in counts.items())


def reset_launch_counts() -> None:
    reset_launches(KERNELS.values())
