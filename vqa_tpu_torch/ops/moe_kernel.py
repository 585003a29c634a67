"""An MoE layer's routing and the routed rows around its grouped GEMMs:
route, plan, permute, SwiGLU, unpermute (``models/moe.py``).

``moe_route``, ``moe_plan``, ``moe_gather``, ``fused_swiglu`` and
``moe_combine`` launch the hand-written CUDA kernels of ``csrc/router.cu``
and ``csrc/moe.cu`` on CUDA tensors (the activations bf16) and compute
their plain versions (``plain_*``) on CPU tensors; ``fused_swiglu``
without a ``total`` is the SwiGLU of every row, for the dense layer and the
shared experts. They replace no TPU kernel (the JAX package has no mixture
of experts): they are what lets the layer run inside a CUDA graph, since
the number of rows the held experts got lives on the device. The router
computes its logits in f32 from the f32 weight, held as three bf16 planes
that sum to it exactly (``weight_planes``, laid out for the kernel by
``route_tiles``), so nothing of the routing is rounded below f32; the plan
is the stable sort of the pairs by held expert, bit for bit. The routed
buffers have a row for every (token, choice) pair, the most that can come;
``total``, a one-element int32 tensor on the device, says how many are
routed here, and the gather and the SwiGLU neither read nor write a row at
or past it. Each is bound by bytes. Launches are counted as the other
kernels' are (``ops``).
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


# the router's lower two weight planes are stored times 2^12 (``weight_planes``)
PLANE_SCALE = 2.0 ** 12
MAX_EXPERTS = 256
MAX_TOP_K = 8


def weight_planes(weight: torch.Tensor) -> torch.Tensor:
    """[3, N, D] float32 of an f32 weight [N, D]: hi, mid and lo, each of
    whose values is a bfloat16 value, with weight == hi + (mid + lo) /
    PLANE_SCALE exactly for weights of magnitude 2^-122 to 2^123 (the
    lower planes are scaled so their bits stay clear of bf16's subnormals
    and of its overflow); x · weight is then the sum of three products of
    bf16 values, each exact."""
    hi = weight.float().to(torch.bfloat16).float()
    rest = (weight.float() - hi) * PLANE_SCALE
    mid = rest.to(torch.bfloat16).float()
    return torch.stack([hi, mid, (rest - mid).to(torch.bfloat16).float()])


# the router kernel's stage: columns of every plane (csrc/router.cu's BK),
# experts a warpgroup computes (CHUNK)
ROUTE_TILE_K = 64
ROUTE_CHUNK = 64


def route_tiles(weight: torch.Tensor) -> torch.Tensor:
    """``weight_planes`` of an f32 weight [N, D] as the router kernel reads
    them: stage by stage (ROUTE_TILE_K columns), each stage one contiguous
    block that one copy brings into shared memory, laid out for the tensor
    cores' descriptors: [ceil(D / ROUTE_TILE_K), plane, k-step of 16, group
    of 8 experts, half of 8 columns, expert in the group, column] float32
    (bf16 values), the experts padded with zeros to a multiple of
    ROUTE_CHUNK and the columns to one of ROUTE_TILE_K."""
    planes = weight_planes(weight)
    experts, width = weight.shape
    padded = -(-experts // ROUTE_CHUNK) * ROUTE_CHUNK
    stages = -(-width // ROUTE_TILE_K)
    planes = F.pad(planes, (0, stages * ROUTE_TILE_K - width, 0, padded - experts))
    t = planes.view(3, padded // 8, 8, stages, ROUTE_TILE_K // 16, 2, 8)
    return t.permute(3, 0, 4, 1, 5, 2, 6).contiguous()


def plain_moe_route(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, top_k: int,
                    scaling: float):
    """DeepSeek-V3's ``noaux_tc`` router with one group: (expert ids [T, k]
    int32, weights [T, k] f32). The logits and their sigmoid in f32 from
    the f32 weight; each token's top ``top_k`` by the score plus ``bias``;
    their unbiased scores normalised to sum to 1 (+1e-20) and scaled."""
    scores = torch.sigmoid(F.linear(x.float(), weight))
    idx = torch.topk(scores + bias, top_k, dim=-1).indices
    w = scores.gather(1, idx)
    return idx.int(), w / (w.sum(-1, keepdim=True) + 1e-20) * scaling


def plain_moe_plan(idx: torch.Tensor, offset: int, held: int):
    """The permutation of the (token, choice) pairs of ``idx`` [T, k] that
    groups the pairs of held expert ``offset + e`` in the e-th place, the
    others last, each group in (token, choice) order: (``src`` [T·k], the
    token of each sorted row; ``ends`` [held], the end row of each held
    expert's group; ``slot`` [T, k], each pair's sorted row, -1 where its
    expert is held elsewhere; ``counts`` [held], the pairs of each held
    expert), all int32 on idx's device."""
    t, k = idx.shape
    local = idx.long() - offset
    here = (local >= 0) & (local < held)
    key = torch.where(here, local, held).reshape(-1)
    sorted_key, order = torch.sort(key, stable=True)
    ends = torch.searchsorted(sorted_key, torch.arange(held, device=idx.device), right=True)
    pos = torch.empty_like(order).scatter_(0, order, torch.arange(t * k, device=idx.device))
    slot = torch.where(here.reshape(-1), pos, -1).reshape(t, k)
    counts = torch.diff(ends, prepend=ends.new_zeros(1))
    return (order // k).int(), ends.int(), slot.int(), counts.int()


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


def _refuse(name: str, why: str):
    raise ValueError(f"{name}: {why}")


def moe_route(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, top_k: int,
              scaling: float, tiles: Optional[torch.Tensor] = None,
              logits: Optional[torch.Tensor] = None):
    """x [T, D] (bf16 on the card), the router's f32 weight [N, D] and bias
    [N] → (idx [T, k] int32, w [T, k] f32), ``plain_moe_route``'s
    function. On the card the kernel reads ``tiles``, ``route_tiles`` of
    the weight in bf16 (made here where not given), and fills a contiguous
    f32 [T, N] ``logits`` with the logits too; D is a multiple of
    ROUTE_TILE_K, N a multiple of 16 up to 256 and k at most 8 (and N);
    anything else raises."""
    if x.device.type == "cpu":
        return plain_moe_route(x, weight, bias, top_k, scaling)
    name = "moe_route"
    if x.dtype != torch.bfloat16:
        _refuse(name, f"x must be bfloat16 on the card, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous() or x.data_ptr() % 16:
        _refuse(name, f"x must be a contiguous, 16-byte aligned [T, D] tensor, got "
                      f"{tuple(x.shape)} with strides {x.stride()}")
    tokens, width = x.shape
    experts = weight.shape[0]
    if tuple(weight.shape) != (experts, width) or weight.device != x.device:
        _refuse(name, f"the weight must be [N, {width}] on {x.device}, got "
                      f"{tuple(weight.shape)} on {weight.device}")
    if not 16 <= experts <= MAX_EXPERTS or experts % 16:
        _refuse(name, f"the router's experts must be a multiple of 16 up to {MAX_EXPERTS}, "
                      f"got {experts}")
    if not 1 <= top_k <= min(MAX_TOP_K, experts):
        _refuse(name, f"k must be 1 to {min(MAX_TOP_K, experts)}, got {top_k}")
    if width < ROUTE_TILE_K or width % ROUTE_TILE_K or tokens < 1:
        _refuse(name, f"x must have rows, and a width that is a multiple of {ROUTE_TILE_K}, "
                      f"got {tuple(x.shape)}")
    if (bias.dtype != torch.float32 or tuple(bias.shape) != (experts,)
            or not bias.is_contiguous() or bias.device != x.device):
        _refuse(name, f"the bias must be a contiguous f32 [{experts}] tensor on {x.device}")
    if tiles is None:
        tiles = route_tiles(weight).bfloat16()
    padded = -(-experts // ROUTE_CHUNK) * ROUTE_CHUNK
    shape = (width // ROUTE_TILE_K, 3, ROUTE_TILE_K // 16, padded // 8, 2, 8, 8)
    if (tiles.dtype != torch.bfloat16 or tuple(tiles.shape) != shape
            or not tiles.is_contiguous() or tiles.data_ptr() % 16 or tiles.device != x.device):
        _refuse(name, f"the tiles must be route_tiles' contiguous bf16 {shape} on {x.device}, "
                      f"got {tiles.dtype} {tuple(tiles.shape)}")
    if logits is not None and (logits.dtype != torch.float32 or not logits.is_contiguous()
                               or tuple(logits.shape) != (tokens, experts)
                               or logits.device != x.device):
        _refuse(name, f"logits must be a contiguous f32 [{tokens}, {experts}] tensor on "
                      f"{x.device}")
    idx = torch.empty((tokens, top_k), dtype=torch.int32, device=x.device)
    w = torch.empty((tokens, top_k), dtype=torch.float32, device=x.device)
    lib = load_library()
    check(lib.vqa_moe_route_bf16(x.data_ptr(), tiles.data_ptr(), bias.data_ptr(),
                                 idx.data_ptr(), w.data_ptr(),
                                 None if logits is None else logits.data_ptr(), tokens, width,
                                 experts, top_k, scaling, _sms(x.device.index or 0),
                                 stream_of(x)), name)
    count_launch(moe_route)
    return idx, w


def moe_plan(idx: torch.Tensor, offset: int, held: int):
    """idx [T, k] expert ids (int32 on the card) → ``plain_moe_plan``'s
    (src, ends, slot, counts), bit for bit; on the card 1 <= held <= 256."""
    if idx.device.type == "cpu":
        return plain_moe_plan(idx, offset, held)
    if idx.dtype != torch.int32 or idx.dim() != 2 or not idx.is_contiguous():
        _refuse("moe_plan", f"idx must be a contiguous 2-d int32 tensor, got {idx.dtype} "
                            f"{tuple(idx.shape)}")
    if not 1 <= held <= MAX_EXPERTS or offset < 0:
        _refuse("moe_plan", f"held must be 1 to {MAX_EXPERTS} and offset >= 0, got {held}, "
                            f"{offset}")
    tokens, k = idx.shape
    src = torch.empty(tokens * k, dtype=torch.int32, device=idx.device)
    slot = torch.empty((tokens, k), dtype=torch.int32, device=idx.device)
    ends = torch.empty(held, dtype=torch.int32, device=idx.device)
    counts = torch.empty(held, dtype=torch.int32, device=idx.device)
    lib = load_library()
    check(lib.vqa_moe_plan(idx.data_ptr(), tokens, k, offset, held, src.data_ptr(),
                           ends.data_ptr(), slot.data_ptr(), counts.data_ptr(), stream_of(idx)),
          "moe_plan")
    count_launch(moe_plan)
    return src, ends, slot, counts


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


moe_route.launches = 0
moe_plan.launches = 0
moe_gather.launches = 0
fused_swiglu.launches = 0
moe_combine.launches = 0
