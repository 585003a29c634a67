"""Layers that follow the JAX model's dtype policy.

``create_vqa_model(config, dtype=...)`` in the JAX package keeps every
parameter f32 and computes in ``dtype`` as flax does: each Dense, Conv and
Embed casts its kernel to ``dtype`` before the op, and LayerNorm and
BatchNorm take their statistics in f32 and return ``dtype``.

Here the layers that hold weights (``Linear``, ``Conv2d``, ``Embedding``,
and the positional tables through ``ComputeCopies``) take each weight in
the compute dtype from ``compute(name)``. In eval mode that is a copy made
once by ``set_compute_dtype`` (when the model is built, its weights are
loaded, or it leaves training mode), kept as a non-persistent buffer
(``compute_weight`` …), so no forward casts a weight. In training mode
there is no copy: each forward casts the f32 parameter, a differentiable
cast, so the gradient reaches the f32 parameter as flax's
``kernel.astype(dtype)`` carries it. The state_dict holds the f32
parameters and nothing else. In f32 there is no copy and each layer
computes exactly as its torch base class. ``LayerNorm`` normalises a
low-precision input in f32 with its f32 affine and rounds once, as flax's
LayerNorm does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# the compute dtypes the port's kernels take
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


class ComputeCopies:
    """Mixin for a module that computes with ``copied`` tensors in the
    compute dtype; call ``init_copies`` at the end of ``__init__``."""

    copied: Tuple[str, ...] = ("weight", "bias")

    def init_copies(self) -> None:
        self.compute_dtype = torch.float32
        for name in self.copied:
            self.register_buffer("compute_" + name, None, persistent=False)

    def set_compute_dtype(self, dtype: torch.dtype, copies: bool = True) -> None:
        """Compute in ``dtype``; with ``copies`` (eval mode) (re)make the
        copies from the current f32 tensors, else (training mode, or f32)
        drop them."""
        self.compute_dtype = dtype
        keep = copies and dtype != torch.float32
        # a copy made under inference_mode (a validation step) must still be
        # usable by a forward outside it
        with torch.inference_mode(False), torch.no_grad():
            for name in self.copied:
                t = getattr(self, name)
                copy = None if t is None or not keep else t.detach().to(dtype)
                self.register_buffer("compute_" + name, copy, persistent=False)

    def compute(self, name: str) -> Optional[torch.Tensor]:
        """The tensor ``name`` in the compute dtype: the eval copy, or a
        differentiable cast of the f32 tensor."""
        copy = getattr(self, "compute_" + name)
        if copy is not None:
            return copy
        t = getattr(self, name)
        return t if t is None else t.to(self.compute_dtype)


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
