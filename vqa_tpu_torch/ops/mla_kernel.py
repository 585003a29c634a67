"""Multi-head latent attention's core (``models/decoder.py:MLA``): RoPE on the
rotary dims, causal and key-padding masked scores, softmax and the context,
from the projections' token-major outputs to the token-major input of
``o_proj``.

``mla_attention`` launches the hand-written CUDA kernel of ``csrc/mla.cu``
on bf16 CUDA tensors and computes ``plain_mla_attention`` on CPU tensors;
on the card any other dtype is refused. The kernel replaces no TPU kernel
(the JAX package has no decoder). It is bound by bytes: it reads q, kv and
the shared rotary key once and writes the context once, with nothing in
between reaching device memory (its source note gives the design). Launches
are counted as the other kernels' are (``ops``).

RoPE is DeepSeek-V3's (``apply_rope``). Scores take bf16 operands (on the
card) with f32 sums, are scaled by (nope + rope)^-1/2 and stay f32 through
the softmax; the probabilities are rounded to the values' dtype for the
context product. Every query is to see at least one key (the model's first
key is an image token, never padding); a query that sees none is not
defined.
"""

from __future__ import annotations

import torch

from vqa_tpu_torch.ops._build import check, count_launch, load_library, stream_of

# (nope, rope, v) head dims the kernel is built for: Kimi-VL-A3B's (and
# DeepSeek-V3's), and the tests' tiny decoder
SHAPES = ((128, 64, 128), (16, 16, 16))
MAX_POSITIONS = 80  # one warp per 16 query rows, at most 5


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, L, h, d] rotated at positions 0..L-1 as DeepSeek-V3 does: its
    interleaved pairs (2i, 2i+1) taken apart to [even, odd] halves, then
    x·cos + rotate_half(x)·sin, so pair i lands at (i, i + d/2); in f32,
    rounded once."""
    length = x.shape[1]
    cos, sin = cos[:length, None], sin[:length, None]
    even, odd = x[..., 0::2].float(), x[..., 1::2].float()
    return torch.cat([even * cos - odd * sin, odd * cos + even * sin], -1).to(x.dtype)


def _dims(q, kv, k_pe, heads):
    rope = k_pe.shape[-1]
    nope = q.shape[-1] // heads - rope
    return nope, rope, kv.shape[-1] // heads - nope


def plain_mla_attention(q: torch.Tensor, kv: torch.Tensor, k_pe: torch.Tensor,
                        cos: torch.Tensor, sin: torch.Tensor, keys: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """The kernel's function in PyTorch calls, on any device (arguments as
    ``mla_attention``'s): the heads' q and k assembled with their rotated
    parts, scores in f32, the mask, softmax in f32, the probabilities in
    the values' dtype times the values."""
    b, length, _ = q.shape
    nope, rope, dv = _dims(q, kv, k_pe, heads)
    q_nope, q_pe = q.view(b, length, heads, nope + rope).split([nope, rope], -1)
    k_nope, v = kv.view(b, length, heads, nope + dv).split([nope, dv], -1)
    k_pe = apply_rope(k_pe.reshape(b, length, 1, rope), cos, sin).expand(-1, -1, heads, -1)
    qh = torch.cat([q_nope, apply_rope(q_pe, cos, sin)], -1).transpose(1, 2).float()
    kh = torch.cat([k_nope, k_pe], -1).transpose(1, 2).float()
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * (nope + rope) ** -0.5
    pos = torch.arange(length, device=q.device)
    keep = (pos[None, :] <= pos[:, None])[None] & (keys[:, None, :] != 0)
    scores = scores.masked_fill(~keep[:, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = torch.matmul(probs, v.transpose(1, 2))
    return ctx.transpose(1, 2).reshape(b, length, heads * dv)


def _refuse(why: str):
    raise ValueError(f"mla_attention: {why}")


def _check(q, kv, k_pe, cos, sin, keys, heads) -> None:
    """What the kernel takes; anything else raises before a launch."""
    for name, t in (("q", q), ("kv", kv), ("k_pe", k_pe)):
        if t.dtype != torch.bfloat16:
            _refuse(f"{name} must be bfloat16 on the card, got {t.dtype}")
        if t.dim() != 3 or t.device != q.device:
            _refuse(f"{name} must be a 3-d tensor on {q.device}, got {tuple(t.shape)} on "
                    f"{t.device}")
    b, length, _ = q.shape
    if tuple(kv.shape[:2]) != (b, length) or tuple(k_pe.shape[:2]) != (b, length):
        _refuse(f"q, kv and k_pe must share [B, L], got {tuple(q.shape)}, {tuple(kv.shape)}, "
                f"{tuple(k_pe.shape)}")
    if q.shape[-1] % heads or kv.shape[-1] % heads:
        _refuse(f"q's and kv's widths must be multiples of the {heads} heads")
    dims = _dims(q, kv, k_pe, heads)
    if dims not in SHAPES:
        _refuse(f"head dims (nope, rope, v) {dims} are not among {SHAPES}")
    if not 1 <= length <= MAX_POSITIONS:
        _refuse(f"L must be 1 to {MAX_POSITIONS}, got {length}")
    for name, t in (("q", q), ("kv", kv)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            _refuse(f"{name} must be contiguous and 16-byte aligned")
    st = k_pe.stride()
    if st[2] != 1 or st[1] % 8 or st[0] != length * st[1] or k_pe.data_ptr() % 16:
        _refuse(f"k_pe must be a 16-byte aligned view of rows [B·L, stride], the stride a "
                f"multiple of 8, got strides {st}")
    for name, t in (("cos", cos), ("sin", sin)):
        if (t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device
                or t.dim() != 2 or t.shape[0] < length or t.shape[1] != dims[1] // 2):
            _refuse(f"{name} must be a contiguous f32 [>= {length}, {dims[1] // 2}] table on "
                    f"{q.device}")
    if keys.dtype != torch.int32 or tuple(keys.shape) != (b, length) or not keys.is_contiguous():
        _refuse(f"keys must be a contiguous int32 [{b}, {length}] tensor, got {keys.dtype} "
                f"{tuple(keys.shape)}")


def mla_attention(q: torch.Tensor, kv: torch.Tensor, k_pe: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor, keys: torch.Tensor, heads: int) -> torch.Tensor:
    """q [B, L, heads·(nope + rope)] (``q_proj``'s output), kv [B, L,
    heads·(nope + v)] (``kv_b_proj``'s: each head's key, then its value),
    k_pe [B, L, rope] (the rotary key every head shares, a view of
    ``kv_a_proj_with_mqa``'s output), cos and sin [>= L, rope / 2] f32 (the
    rope tables), keys [B, L] (0 at padding; int32 on the card) → the
    context [B, L, heads·v]."""
    if q.device.type == "cpu":
        return plain_mla_attention(q, kv, k_pe, cos, sin, keys, heads)
    _check(q, kv, k_pe, cos, sin, keys, heads)
    b, length, _ = q.shape
    nope, rope, dv = _dims(q, kv, k_pe, heads)
    out = torch.empty((b, length, heads * dv), dtype=q.dtype, device=q.device)
    lib = load_library()
    check(lib.vqa_mla_attention_bf16(q.data_ptr(), kv.data_ptr(), k_pe.data_ptr(),
                                     cos.data_ptr(), sin.data_ptr(), keys.data_ptr(),
                                     out.data_ptr(), b, length, heads, nope, rope, dv,
                                     k_pe.stride(1), (nope + rope) ** -0.5, stream_of(q)),
          "mla_attention")
    count_launch(mla_attention)
    return out


mla_attention.launches = 0
