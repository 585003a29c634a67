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
from torch.distributed.nn.functional import all_reduce

from vqa_tpu_torch.parallel.mesh import split

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


class ComputeDtypeRoot(nn.Module):
    """The root of a tree of layers that compute in one dtype (``self.dtype``,
    f32 until ``set_compute_dtype``): the model, or a module used alone.
    Weights loaded into it refresh its layers' copies, and leaving training
    mode remakes them, so an eval forward never sees a stale copy."""

    def __init__(self):
        super().__init__()
        self.dtype = torch.float32
        self.register_load_state_dict_post_hook(ComputeDtypeRoot._refresh_copies)

    def _refresh_copies(self, _incompatible_keys) -> None:
        self.set_compute_dtype(self.dtype)

    def set_compute_dtype(self, dtype: torch.dtype):
        """Compute in ``dtype`` (f32 or bf16) from now on. In eval mode every
        layer (re)makes its copy of its weights in it from the current f32
        weights; in training mode each forward casts them."""
        if dtype not in COMPUTE_DTYPES:
            raise ValueError(f"the port computes in float32 or bfloat16, got {dtype}")
        self.dtype = dtype
        for m in self.modules():
            if m is not self and hasattr(m, "set_compute_dtype"):
                m.set_compute_dtype(dtype, copies=not self.training)
        return self

    def train(self, mode: bool = True):
        """Entering training mode drops the eval copies of the weights (the
        optimizer is about to change the weights); leaving it remakes them
        from the weights as they are then."""
        was = self.training
        super().train(mode)
        if mode != was:
            self.set_compute_dtype(self.dtype)
        return self


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


def _from_full(cls, full: nn.Module, splits, index: int, degree: int, group):
    """A ``cls`` holding this rank's slices of ``full``'s tensors (``splits``:
    tensor name → split dim; the others whole) and its other attributes
    (the compute dtype among them)."""
    new = cls.__new__(cls)
    nn.Module.__init__(new)
    new.__dict__.update({k: v for k, v in full.__dict__.items() if not k.startswith("_")})
    new.init_copies()
    for name, p in full.named_parameters(recurse=False):
        t = split(p.detach(), splits[name], index, degree) if name in splits else p.detach()
        setattr(new, name, nn.Parameter(t, requires_grad=p.requires_grad))
    if "bias" in full._parameters and full.bias is None:
        new.register_parameter("bias", None)
    new.group = group
    return new


class ColumnParallelLinear(Linear):
    """Output features [index·n/degree, (index+1)·n/degree) of a Linear:
    weight rows and bias split; the output is this rank's feature slice."""

    @classmethod
    def from_full(cls, full: Linear, index: int, degree: int, group):
        new = _from_full(cls, full, {"weight": 0, "bias": 0}, index, degree, group)
        new.out_features = new.weight.shape[0]
        return new


class RowParallelLinear(Linear):
    """Input features split: the weight's columns; the partial products
    are summed over the model group, then the whole bias is added."""

    @classmethod
    def from_full(cls, full: Linear, index: int, degree: int, group):
        new = _from_full(cls, full, {"weight": 1}, index, degree, group)
        new.in_features = new.weight.shape[1]
        return new

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = all_reduce(F.linear(x, self.compute("weight")), group=self.group)
        bias = self.compute("bias")
        return y if bias is None else y + bias


class VocabParallelEmbedding(Embedding):
    """Vocabulary rows [index·V/degree, (index+1)·V/degree): a lookup of
    the ids inside them (zero rows elsewhere), summed over the model
    group."""

    @classmethod
    def from_full(cls, full: Embedding, index: int, degree: int, group):
        if full.padding_idx is not None or full.max_norm is not None:
            raise ValueError("the vocab-parallel embedding takes no padding_idx or max_norm")
        new = _from_full(cls, full, {"weight": 0}, index, degree, group)
        new.num_embeddings = new.weight.shape[0]
        new.vocab_start = index * new.num_embeddings
        return new

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local = ids - self.vocab_start
        inside = (local >= 0) & (local < self.num_embeddings)
        rows = F.embedding(torch.where(inside, local, 0), self.compute("weight"))
        return all_reduce(rows.masked_fill(~inside[..., None], 0), group=self.group)
