"""The port's kernels: each a hand-written CUDA kernel for Hopper behind a
wrapper, with its plain PyTorch version beside it.

Each wrapper counts its kernel launches in a plain integer attribute
(``fused_stem.launches`` …), under one lock, since kernels launch from
several threads; ``launch_counts`` reads them and ``reset_launch_counts``
zeroes them, so a run can show which kernels the main path went through.
"""

from vqa_tpu_torch.ops._build import reset_launches
from vqa_tpu_torch.ops.cross_attention_kernel import (  # noqa: F401
    fused_cross_attention,
    plain_cross_attention,
)
from vqa_tpu_torch.ops.se_kernel import fused_se, plain_se  # noqa: F401
from vqa_tpu_torch.ops.stem_kernel import fused_stem, plain_stem  # noqa: F401

KERNELS = {
    "stem": fused_stem,
    "se": fused_se,
    "cross_attention": fused_cross_attention,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    reset_launches(KERNELS.values())
