"""The routed rows of an MoE layer around its grouped GEMMs: permute,
SwiGLU, unpermute (``models/moe.py``).

``moe_gather``, ``fused_swiglu`` and ``moe_combine`` launch the
hand-written CUDA kernels of ``csrc/moe.cu`` on bf16 CUDA tensors and
compute their plain versions (``plain_*``) on CPU tensors;
``fused_swiglu`` without a ``total`` is the SwiGLU of every row, for the
dense layer and the shared experts. They replace no TPU kernel (the JAX
package has no mixture of experts): they are what lets the layer's routed
path run inside a CUDA graph, since the number of rows the held experts
got lives on the device. The routed buffers have a row
for every (token, choice) pair, the most that can come; ``total``, a
one-element int32 tensor on the device, says how many are routed here,
and the gather and the SwiGLU neither read nor write a row at or past it.
Each is bound by bytes. Launches are counted as the other kernels' are
(``ops``).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from vqa_tpu_torch.ops._build import check, count_launch, load_library, stream_of

# blocks per SM of the grid that strides over the rows
BLOCKS_PER_SM = 8


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _blocks(t: torch.Tensor, rows: int) -> int:
    return max(1, min(rows, BLOCKS_PER_SM * _sms(t.device.index or 0)))


def _check(t: torch.Tensor, name: str, dtype, dim: int) -> None:
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-d {dtype} tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.shape[-1] % 8 and dtype == torch.bfloat16:
        raise ValueError(f"{name}'s last dimension must be a multiple of 8, got {t.shape[-1]}")


def plain_moe_gather(x: torch.Tensor, src: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """[rows, D]: row r is x[src[r]] for r < total, 0 past it."""
    n = int(total.reshape(-1)[0])
    out = x.new_zeros((src.shape[0], x.shape[1]))
    out[:n] = x[src[:n].long()]
    return out


def plain_swiglu(h: torch.Tensor, total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[rows, I] from [rows, 2I]: silu(gate) * up in f32, rounded once, for
    the rows before total (every row without one), 0 past them."""
    n = h.shape[0] if total is None else int(total.reshape(-1)[0])
    width = h.shape[1] // 2
    gate, up = h[:n, :width].float(), h[:n, width:].float()
    out = h.new_zeros((h.shape[0], width))
    out[:n] = (F.silu(gate) * up).to(h.dtype)
    return out


def plain_moe_combine(y: torch.Tensor, slot: torch.Tensor, w: torch.Tensor,
                      shared: torch.Tensor) -> torch.Tensor:
    """[T, D]: the weighted sum, in f32 over j in order, of each token's
    routed rows (slot[t, j] >= 0), rounded to y's dtype, plus its shared
    row, rounded again. Each step of the sum is a fused multiply-add, as
    the kernel's are: w·y + acc rounded once to f32 (computed in f64, where
    the product is exact)."""
    acc = torch.zeros(shared.shape, dtype=torch.float32, device=shared.device)
    for j in range(slot.shape[1]):
        routed = slot[:, j] >= 0
        rows = y[slot[:, j].clamp(min=0).long()].double()
        step = (acc.double() + w[:, j, None].double() * rows).float()
        acc = torch.where(routed[:, None], step, acc)
    return (acc.to(y.dtype).float() + shared.float()).to(y.dtype)


def moe_gather(x: torch.Tensor, src: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """x [T, D], src [rows] int32 token ids, total [1] int32 → [rows, D],
    row r = x[src[r]] for r < total (past it, on the card, left as
    allocated)."""
    if x.device.type == "cpu":
        return plain_moe_gather(x, src, total)
    _check(x, "x", torch.bfloat16, 2)
    _check(src, "src", torch.int32, 1)
    rows, width = src.shape[0], x.shape[1]
    out = torch.empty((rows, width), dtype=x.dtype, device=x.device)
    lib = load_library()
    check(lib.vqa_moe_gather_bf16(x.data_ptr(), src.data_ptr(), total.data_ptr(),
                                  out.data_ptr(), width, _blocks(x, rows), stream_of(x)),
          "moe_gather")
    count_launch(moe_gather)
    return out


def fused_swiglu(h: torch.Tensor, total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h [rows, 2I] (gate, then up) → [rows, I], silu(gate) * up for the
    rows before total (a one-element int32 tensor on the device: the routed
    rows, the kernel's ``<true>`` form), else for every row (a dense
    SwiGLU, ``<false>``); past total, on the card, left as allocated."""
    if h.device.type == "cpu":
        return plain_swiglu(h, total)
    _check(h, "h", torch.bfloat16, 2)
    rows, width = h.shape[0], h.shape[1] // 2
    if width % 8:
        raise ValueError(f"the SwiGLU width must be a multiple of 8, got {width}")
    out = torch.empty((rows, width), dtype=h.dtype, device=h.device)
    lib = load_library()
    check(lib.vqa_swiglu_bf16(h.data_ptr(), None if total is None else total.data_ptr(),
                              out.data_ptr(), rows, width, _blocks(h, rows), stream_of(h)),
          "fused_swiglu")
    count_launch(fused_swiglu)
    return out


def moe_combine(y: torch.Tensor, slot: torch.Tensor, w: torch.Tensor,
                shared: torch.Tensor) -> torch.Tensor:
    """y [rows, D] (the experts' outputs in sorted order), slot [T, k]
    int32 (each choice's row of y, -1 where the expert is not held here),
    w [T, k] f32, shared [T, D] → [T, D]."""
    if y.device.type == "cpu":
        return plain_moe_combine(y, slot, w, shared)
    _check(y, "y", torch.bfloat16, 2)
    _check(shared, "shared", torch.bfloat16, 2)
    _check(slot, "slot", torch.int32, 2)
    _check(w, "w", torch.float32, 2)
    tokens, k = slot.shape
    width = y.shape[1]
    out = torch.empty_like(shared)
    lib = load_library()
    check(lib.vqa_moe_combine_bf16(y.data_ptr(), slot.data_ptr(), w.data_ptr(),
                                   shared.data_ptr(), out.data_ptr(), tokens, k, width,
                                   _blocks(y, tokens), stream_of(y)), "moe_combine")
    count_launch(moe_combine)
    return out


moe_gather.launches = 0
fused_swiglu.launches = 0
moe_combine.launches = 0
