"""Kimi Delta Attention's core (``models/decoder.py:KDA``): the short
convolutions, the L2 norms, the per-channel decay, β and the gated delta
rule, from the projections' token-major outputs to the token-major input of
``o_norm``.

``kda_attention`` launches the hand-written CUDA kernel of ``csrc/kda.cu``
on bf16 CUDA tensors and computes ``plain_kda_attention``, a loop over the
positions, on CPU tensors; on the card any other dtype is refused, and
nothing falls back. The kernel replaces no TPU kernel (the JAX package has
no decoder). Its state never reaches device memory: one block per (pair,
head) keeps its [K, V] f32 state in registers from the first position to
the last (its source note gives the design). Launches are counted as the
other kernels' are (``ops``).

For each pair and head, with the state S [K, V] f32 at 0 before the pair's
first position, at each position t:

- q, k and v: a causal depthwise convolution of ``short_conv_kernel_size``
  taps over the pair's own positions (zeros before its first), then SiLU;
  q and k L2-normalised per head (eps 1e-6), q scaled by K^-1/2;
- the decay α = exp(-exp(A_log[h]) · softplus(g + dt_bias)), one value per
  key channel, and β = sigmoid(b), one per head;
- S ← Diag(α)·S, then S ← S + β·k·(v - Sᵀk)ᵀ, and o = Sᵀq.

Everything between the bf16 inputs and the bf16 output is f32 and rounded
once. The pairs are independent: the convolution does not reach across a
pair's start, and no state passes from one pair to the next, so the
flattened [B·L] rows of a batch give each pair what it would get alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vqa_tpu_torch.ops._build import check, count_launch, load_library, stream_of

# head dims (K = V) the kernel is built for: Kimi-Linear's, and the tests'
# tiny decoder's
HEAD_DIMS = (128, 16)
MAX_POSITIONS = 80
MAX_CONV = 4  # convolution taps
L2_EPS = 1e-6


def short_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x [B, L, C] → SiLU of the causal depthwise convolution with weight
    [C, 1, W] over each pair's positions (W - 1 zeros before the first;
    the last tap multiplies the position itself), f32."""
    width = weight.shape[-1]
    xp = F.pad(x.float().transpose(1, 2), (width - 1, 0))
    return F.silu(F.conv1d(xp, weight.float(), groups=x.shape[-1])).transpose(1, 2)


def plain_kda_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                        b: torch.Tensor, q_conv: torch.Tensor, k_conv: torch.Tensor,
                        v_conv: torch.Tensor, a_log: torch.Tensor, dt_bias: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """The kernel's function as PyTorch calls on any device, one position
    at a time (arguments as ``kda_attention``'s)."""
    batch, length, width = q.shape
    dk = width // heads
    qc, kc, vc = (short_conv(x, w).view(batch, length, heads, dk)
                  for x, w in ((q, q_conv), (k, k_conv), (v, v_conv)))
    qn = qc * torch.rsqrt(qc.square().sum(-1, keepdim=True) + L2_EPS) * dk ** -0.5
    kn = kc * torch.rsqrt(kc.square().sum(-1, keepdim=True) + L2_EPS)
    decay = -a_log.float().exp()[:, None] * F.softplus(
        g.float().view(batch, length, heads, dk) + dt_bias.float().view(heads, dk))
    o = delta_rule(qn, kn, vc, decay.exp(), torch.sigmoid(b.float()))
    return o.reshape(batch, length, heads * dk).to(q.dtype)


def delta_rule(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, alpha: torch.Tensor,
               beta: torch.Tensor) -> torch.Tensor:
    """The gated delta rule, position by position in f32: q, k, alpha [B,
    L, H, K], v [B, L, H, V], beta [B, L, H] → o [B, L, H, V]; each head's
    state [K, V] starts at 0, and at each position S ← Diag(alpha)·S,
    S ← S + beta·k·(v - Sᵀk)ᵀ, o = Sᵀq."""
    batch, length, heads, dk = k.shape
    state = k.new_zeros((batch, heads, dk, v.shape[-1]), dtype=torch.float32)
    out = []
    for t in range(length):
        state = state * alpha[:, t, :, :, None]
        kt = k[:, t]
        u = beta[:, t, :, None] * (v[:, t] - torch.einsum("bhkv,bhk->bhv", state, kt))
        state = state + kt[..., None] * u[..., None, :]
        out.append(torch.einsum("bhkv,bhk->bhv", state, q[:, t]))
    return torch.stack(out, 1)


def _refuse(why: str):
    raise ValueError(f"kda_attention: {why}")


def _rows(t: torch.Tensor, name: str, batch: int, length: int, width: int) -> int:
    """The row stride of a [B, L, width] view of rows [B·L, stride] (what a
    slice of a wider projection's output is); raises for anything else."""
    if t.dtype != torch.bfloat16 or t.dim() != 3 or tuple(t.shape) != (batch, length, width):
        _refuse(f"{name} must be a bfloat16 [{batch}, {length}, {width}] tensor, got "
                f"{t.dtype} {tuple(t.shape)}")
    st = t.stride()
    if st[2] != 1 or st[1] % 8 or st[0] != length * st[1] or t.data_ptr() % 16:
        _refuse(f"{name} must be a 16-byte aligned view of rows [B·L, stride], the stride a "
                f"multiple of 8, got strides {st}")
    return st[1]


def kda_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                  b: torch.Tensor, q_conv: torch.Tensor, k_conv: torch.Tensor,
                  v_conv: torch.Tensor, a_log: torch.Tensor, dt_bias: torch.Tensor,
                  heads: int) -> torch.Tensor:
    """q, k, v [B, L, heads·K] (``q_proj``'s, ``k_proj``'s and ``v_proj``'s
    outputs, before their convolutions), g [B, L, heads·K] (``f_b_proj``'s),
    b [B, L, heads] (``b_proj``'s logits), the convolutions' weights [heads·K,
    1, W], A_log [heads] and dt_bias [heads·K] → o [B, L, heads·K]. On the
    card q, k, v, g and b may be views of rows [B·L, stride] of a wider
    output (a stride a multiple of 8); the rest is f32 and contiguous."""
    if q.device.type == "cpu":
        return plain_kda_attention(q, k, v, g, b, q_conv, k_conv, v_conv, a_log, dt_bias,
                                   heads)
    if q.dim() != 3 or q.shape[-1] % heads:
        _refuse(f"q must be [B, L, heads·K] with {heads} heads, got {tuple(q.shape)}")
    batch, length, width = q.shape
    dk = width // heads
    if dk not in HEAD_DIMS:
        _refuse(f"the head dim {dk} is not among {HEAD_DIMS}")
    if not 1 <= length <= MAX_POSITIONS:
        _refuse(f"L must be 1 to {MAX_POSITIONS}, got {length}")
    strides = [_rows(t, name, batch, length, w) for t, name, w in (
        (q, "q", width), (k, "k", width), (v, "v", width), (g, "g", width), (b, "b", heads))]
    taps = q_conv.shape[-1]
    conv = (width, 1, taps)
    for name, t, shape in (("q_conv", q_conv, conv), ("k_conv", k_conv, conv),
                           ("v_conv", v_conv, conv), ("A_log", a_log, (heads,)),
                           ("dt_bias", dt_bias, (width,))):
        if (t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device
                or tuple(t.shape) != shape):
            _refuse(f"{name} must be a contiguous f32 {shape} tensor on {q.device}, got "
                    f"{t.dtype} {tuple(t.shape)}")
    if not 1 <= taps <= MAX_CONV:
        _refuse(f"the convolutions must have 1 to {MAX_CONV} taps, got {taps}")
    out = torch.empty((batch, length, width), dtype=q.dtype, device=q.device)
    lib = load_library()
    check(lib.vqa_kda_attention_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                                     b.data_ptr(), *strides, q_conv.data_ptr(),
                                     k_conv.data_ptr(), v_conv.data_ptr(), a_log.data_ptr(),
                                     dt_bias.data_ptr(), out.data_ptr(), batch, length, heads,
                                     dk, taps, dk ** -0.5, stream_of(q)), "kda_attention")
    count_launch(kda_attention)
    return out


kda_attention.launches = 0
