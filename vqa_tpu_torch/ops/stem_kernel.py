"""Fused CNN stem: conv 7x7/2 + BN-eval affine + ReLU + maxpool 3x3/2.

Counterpart of ``vqa_tpu/ops/stem_kernel.py``. ``fused_stem`` launches the
hand-written CUDA kernel ``csrc/stem.cu`` on a CUDA tensor — the conv as an
implicit GEMM on the tensor cores in 3xTF32, which keeps f32 accuracy; the
conv output never reaches device memory — and computes ``plain_stem`` on a
CPU tensor.
Activations are NHWC as in the JAX package; the conv weight is the
``nn.Conv2d`` OIHW layout the model stores, read by the kernel as it is.

Shapes: x [B, H, W, 3] → [B, PH, PW, cout] with CH = ceil(H/2) conv rows
and PH = ceil(CH/2) pool rows (224 → 112 → 56). Any H, W; 3 input
channels and cout a multiple of 8 up to 64 (``stem_takes``). Everything
else raises; the backbone routes other stems to its unfused layers.

bf16 x and w launch the kernel's bf16 form (``fused_stem_bf16``): one
bf16 tensor-core product per tap (exact in f32) accumulated in f32, the
folded scale and bias f32, the output rounded once to bf16, as the Pallas
kernel computes with w cast to x's dtype and an f32 affine. Its launch
plan (``stem_plan``: tile, tiles, blocks per SM, shared memory, and
whether the patch arrives by TMA) is computed here in plain
Python and passed to the launcher, which refuses a plan that does not
match its own layout. ``stem_k_taps`` is the bf16 form's K order (the
Pallas kernel's per-row ``kw*3 + c``, in 24 slots a row; ``stem_k_slots``
gives the layout).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from vqa_tpu_torch.ops._build import check, count_launch, load_library, require, stream_of

MAX_COUT = 64

# the bf16 form's tiling (csrc/stem.cu): tiles of TPY x TPX pool outputs,
# 15 x 15 conv positions held as 4 x 15 vertical strips of STRIP conv rows
# (a thread's four GEMM rows), read from a box of BOX_ROWS input rows
TPY = TPX = 7
STRIP = 4
KS, CIN = 7, 3
K_STEPS16 = 11                  # bf16 k-steps of 16: 7 rows x 24 slots = 168, 8 more zeros
KH_ORDER = (0, 2, 4, 6, 1, 3, 5)  # kernel rows in K: a strip keeps fewer A registers live
TCY = TCX = 2 * TPX + 1         # 15
STRIP_ROWS = -(-TCY // STRIP)   # 4
BOX_ROWS = 2 * (STRIP * STRIP_ROWS - 1) + KS  # 37
PITCH = (5 + CIN * (2 * (TCX - 1) + KS) + 7) // 8 * 8  # box row: 112 elements
NUM_SMS = 132                   # H100 SXM
SM_SHARED = 233_472             # shared memory of one SM (228 KB); each block reserves 1 KB
MAX_SMEM = 232_448              # dynamic shared memory one block may use (227 KB)
SMEM_F32 = 201_812              # the f32 form's layout (vqa_stem_smem_bytes)


def stem_k_slots():
    """The bf16 form's K layout: for each of its 176 GEMM columns the
    (kernel row, slot) it reads, or None for the zero group at the end. A
    kernel row's 24 slots are 3 groups of 8; group g (of 21) is slots
    8*(g // 7) .. +7 of row KH_ORDER[g % 7] (csrc/stem.cu: q_of, kh_of)."""
    out = []
    for k in range(16 * K_STEPS16):
        g, e = divmod(k, 8)
        out.append((KH_ORDER[g % KS], 8 * (g // KS) + e) if g < 3 * KS else None)
    return out


def stem_k_taps():
    """The bf16 form's K order: for each of its 176 GEMM columns the OIHW
    tap (c*49 + kh*7 + kw) it multiplies, or -1 for a zero. Slot s of
    kernel row kh holds tap (c, kh, kw) with s = 1 + kw*3 + c: per row the
    Pallas kernel's ``kw*3 + c`` (``pack_stem_weights``), one slot in, so
    that a pair of slots starts at an even element of the kernel's box (see
    ``StemPlan.box_origin``); slots 0, 22 and 23 are zeros."""
    taps = []
    for ks in stem_k_slots():
        if ks is None or not 0 < ks[1] <= KS * CIN:
            taps.append(-1)
            continue
        kw, c = divmod(ks[1] - 1, CIN)
        taps.append(c * KS * KS + ks[0] * KS + kw)
    return taps


def _round(v: int, to: int) -> int:
    return -(-v // to) * to


# dynamic shared memory of the bf16 form (vqa_stem_bf16_smem_bytes): the 11
# B tiles, two boxes, two sets of the strips' E, O and Z planes (64 strip
# slots x 72 bf16 each), scale and bias, two mbarriers
SMEM_BF16 = (K_STEPS16 * 2048 + 2 * _round(2 * BOX_ROWS * PITCH, 128)
             + 2 * 2 * 3 * 64 * (MAX_COUT + 8) + 4 * 2 * MAX_COUT + 16)


@dataclass(frozen=True)
class StemPlan:
    tile: tuple          # pool outputs per tile (rows, cols)
    tiles_x: int         # tiles across an image
    tiles_y: int         # tiles down an image
    tiles: int           # over the batch
    blocks_per_sm: int   # persistent blocks on each SM
    grid: int            # blocks launched on an H100 SXM (132 SMs)
    smem_bytes: int      # dynamic shared memory per block
    tma: bool            # the patch arrives by TMA, else by plain loads

    def origin(self, t: int):
        """(image, first pool row, first pool col) of tile t, in the order the
        persistent blocks walk them."""
        b, r = divmod(t, self.tiles_x * self.tiles_y)
        ty, tx = divmod(r, self.tiles_x)
        return b, ty * self.tile[0], tx * self.tile[1]

    @staticmethod
    def box_origin(py0: int, px0: int):
        """(first input row, first element of the [W*3] image row, shift) of
        the box that holds a tile's patch: conv row 2*py0 - 1 reads input
        row 2*(2*py0 - 1) - 3, and the patch's first element 3*(4*px0 - 5)
        lies ``shift`` elements into the box, whose start is rounded down to
        a multiple of 8 (TMA takes only 16-byte aligned starts along a row).
        Coordinates may be negative: TMA fills zeros outside the image."""
        e = CIN * (4 * px0 - 5)
        return 4 * py0 - 5, e - e % 8, e % 8


@functools.lru_cache(maxsize=256)
def stem_plan(b: int, h: int, w: int, cout: int, esize: int = 2,
              aligned: bool = True) -> StemPlan:
    """The launch plan of one ``fused_stem`` call on x [b, h, w, 3] with
    cout channels and esize-byte elements (4: the f32 form, 2: bf16).

    The f32 form has one plan: tiles of 8 x 7, one block per SM, the patch
    by cp.async. The bf16 form takes tiles of 7 x 7 pool outputs, two
    blocks per SM; its patch arrives by TMA where x's rows can be TMA rows
    (w % 8 == 0: 16-byte multiples) and x is 16-byte aligned (``aligned``;
    a view may carry a storage offset), else by plain loads.
    """
    if min(b, h, w) <= 0 or cout <= 0 or cout % 8 or cout > MAX_COUT:
        raise ValueError(f"stem_plan: takes positive sizes and cout a multiple of 8 up to "
                         f"{MAX_COUT}, got b={b} h={h} w={w} cout={cout}")
    if esize not in (2, 4):
        raise ValueError(f"stem_plan: esize must be 4 (f32) or 2 (bf16), got {esize}")
    ph, pw = stem_output_hw(h, w)
    if esize == 4:
        tile, per_sm, smem, tma = (8, 7), 1, SMEM_F32, False
    else:
        tile, per_sm, smem, tma = (TPY, TPX), 2, SMEM_BF16, w % 8 == 0 and aligned
    tx, ty = -(-pw // tile[1]), -(-ph // tile[0])
    tiles = b * tx * ty
    return StemPlan(tile, tx, ty, tiles, per_sm, min(tiles, per_sm * NUM_SMS), smem, tma)


def stem_output_hw(h: int, w: int):
    """Pool output size of the stem for an H x W input."""
    ch, cw = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return (ch - 1) // 2 + 1, (cw - 1) // 2 + 1


def stem_takes(in_channels: int, cout: int) -> bool:
    """Whether the stem kernel takes this geometry: 3 input channels and
    cout a multiple of 8 up to 64."""
    return in_channels == 3 and 0 < cout <= MAX_COUT and cout % 8 == 0


def _validate(x, w, scale, bias) -> None:
    require(x, "x")
    cout = w.shape[0] if w.dim() == 4 else -1
    if x.dim() != 4 or not stem_takes(x.shape[3], cout):
        raise ValueError(
            f"the stem kernel takes NHWC x [B,H,W,3] and cout a multiple of 8 up to "
            f"{MAX_COUT}, got x {tuple(x.shape)} and weight {tuple(w.shape)}")
    require(w, "w", (cout, 3, 7, 7), x.device, x.dtype)
    require(scale, "scale", (cout,), x.device, torch.float32)
    require(bias, "bias", (cout,), x.device, torch.float32)


def fused_stem(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """relu(conv7x7/2(x, w) * scale + bias), then maxpool 3x3/2 pad 1.

    Args:
        x: [B, H, W, 3] NHWC f32 or bf16 (normalized pixels).
        w: [cout, 3, 7, 7] OIHW conv weight, x's dtype.
        scale: [cout] folded BN scale, gamma / sqrt(var + eps), f32.
        bias: [cout] folded BN bias, beta - mean * scale, f32.

    Returns:
        [B, PH, PW, cout] NHWC in x's dtype, contiguous.
    """
    _validate(x, w, scale, bias)
    if x.device.type == "cpu":
        return plain_stem(x, w, scale, bias)
    if x.dtype == torch.bfloat16:
        return _launch(x, w, scale, bias, "vqa_stem_bf16", fused_stem_bf16)
    return _launch(x, w, scale, bias, "vqa_stem_f32", fused_stem)


def fused_stem_bf16(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """The bf16 form: x, w and the output bf16, scale and bias f32 (the
    plain version on CPU tensors). ``fused_stem`` routes bf16 here."""
    _validate(x, w, scale, bias)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_stem_bf16 takes bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return plain_stem(x, w, scale, bias)
    return _launch(x, w, scale, bias, "vqa_stem_bf16", fused_stem_bf16)


def _launch(x, w, scale, bias, launcher: str, counter) -> torch.Tensor:
    b, h, wd, _ = x.shape
    cout = w.shape[0]
    ph, pw = stem_output_hw(h, wd)
    out = torch.empty((b, ph, pw, cout), dtype=x.dtype, device=x.device)
    args = [x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, h, wd, cout]
    if x.dtype == torch.bfloat16:
        plan = stem_plan(b, h, wd, cout, 2, x.data_ptr() % 16 == 0)
        args += [int(plan.tma), plan.smem_bytes]
    with torch.cuda.device(x.device):  # a new thread's current device is 0
        rc = getattr(load_library(), launcher)(*args, stream_of(x))
    check(rc, "stem")
    count_launch(counter)
    return out


fused_stem.launches = 0
fused_stem_bf16.launches = 0


def plain_stem(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch ops (CPU path and on-card oracle).
    bf16 inputs go through the f32 function on their exact f32 values (each
    bf16 product is exact in f32, the sums f32) and the output is rounded
    once to bf16, as the kernel's bf16 form does."""
    if x.dtype == torch.bfloat16:
        return plain_stem(x.float(), w.float(), scale, bias).to(torch.bfloat16)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=2, padding=3)
    y = torch.relu(y * scale[:, None, None] + bias[:, None, None])
    y = F.max_pool2d(y, kernel_size=3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()
