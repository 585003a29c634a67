"""Layers that follow the JAX model's dtype policy.

``create_vqa_model(config, dtype=...)`` in the JAX package keeps every
parameter f32 and computes in ``dtype`` as flax does: each Dense, Conv and
Embed casts its kernel to ``dtype`` before the op, and LayerNorm and
BatchNorm take their statistics in f32 and return ``dtype``.

Here the layers that hold weights (``Linear``, ``Conv2d``, ``Embedding``,
and the positional tables through ``ComputeCopies``) keep one copy of them
in the compute dtype, made once by ``set_compute_dtype`` when the model is
built or its weights are loaded, as non-persistent buffers
(``compute_weight`` …): the state_dict holds the f32 parameters and nothing
else, and no forward casts a weight. In f32 there is no copy and each layer
computes exactly as its torch base class. ``LayerNorm`` normalises a
low-precision input in f32 with its f32 affine and rounds once, as flax's
LayerNorm does; BatchNorm needs no change (``F.batch_norm`` takes a bf16
input with f32 statistics and returns bf16).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# the compute dtypes the port's kernels take
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


class ComputeCopies:
    """Mixin for a module that keeps a compute-dtype copy of each tensor
    named in ``copied``; call ``init_copies`` at the end of ``__init__``."""

    copied: Tuple[str, ...] = ("weight", "bias")

    def init_copies(self) -> None:
        for name in self.copied:
            self.register_buffer("compute_" + name, None, persistent=False)

    def set_compute_dtype(self, dtype: torch.dtype) -> None:
        """(Re)make the copies from the current f32 tensors; f32 drops them."""
        for name in self.copied:
            t = getattr(self, name)
            copy = None if t is None or dtype == torch.float32 else t.detach().to(dtype)
            self.register_buffer("compute_" + name, copy, persistent=False)

    def compute(self, name: str) -> Optional[torch.Tensor]:
        """The tensor ``name`` in the compute dtype."""
        copy = getattr(self, "compute_" + name)
        return getattr(self, name) if copy is None else copy


class Linear(ComputeCopies, nn.Linear):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.init_copies()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.compute("weight"), self.compute("bias"))


class Conv2d(ComputeCopies, nn.Conv2d):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.init_copies()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.compute("weight"), self.compute("bias"))


class Embedding(ComputeCopies, nn.Embedding):
    copied = ("weight",)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.init_copies()

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.compute("weight"), self.padding_idx, self.max_norm,
                           self.norm_type, self.scale_grad_by_freq, self.sparse)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm``; an input in another dtype than the (f32) affine is
    normalised in f32 and the result cast back to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)
