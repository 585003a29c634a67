"""The bf16 stem kernel's decomposition on the CPU.

``csrc/stem.cu``'s bf16 form walks tiles of 7 x 7 pool outputs (15 x 15
conv positions) in the order ``stem_plan`` gives. Each tile's patch lands
in shared memory as a [37 rows][112 elements] box of x viewed as
[B][H][W*3], cut at the coordinates ``StemPlan.box_origin`` gives (TMA
zero-fills outside the image; the plain-load route fills the same box).
A thread's four GEMM rows are a vertical strip of conv positions
(4*k .. 4*k+3, cx); its A operand reads, for strip position r and kernel
row kh, slots s = 0..23 at box element 6*cx + s - 1 + shift of box row
8*k + 2*r + kh, the padding slots masked to zero; its B operand is w in
the K order ``stem_k_taps``. bf16 products are summed in f32, the BN
affine and ReLU are f32; each strip stores E = max(r0, r1, r2),
O = max(r2, r3) and Z = r0 rounded to bf16, and the pool takes the max of
E over 3 columns for an even pool row and of O and the next strip's Z for
an odd one.

These tests emulate exactly that in numpy, driven by ``stem_plan``, and
hold it to ``plain_stem`` in bf16 within one bf16 ulp (+ the stem's f32
tolerance where the affine nearly cancels the conv, as on the card); they
check the plan's tiles, shared memory and route at the engine's shapes and
at the card tests' odd geometries, the gather's reads against the conv
window, and the K order against the Pallas kernel's ``pack_stem_weights``
on the same weights.
"""

import numpy as np
import pytest
import torch

from vqa_tpu.ops.stem_kernel import pack_stem_weights
from vqa_tpu_torch.ops import plain_stem
from vqa_tpu_torch.ops.stem_kernel import (
    BOX_ROWS, KH_ORDER, MAX_SMEM, PITCH, SM_SHARED, STRIP, STRIP_ROWS, TCX, TCY, stem_k_slots,
    stem_k_taps, stem_output_hw, stem_plan)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ENGINE = [(1, 224, 224, 64), (8, 224, 224, 64), (32, 224, 224, 64)]
ODD = [(1, 37, 50, 16), (2, 17, 9, 24), (1, 1, 1, 8)]
STEM_BF16_ATOL = 1e-5  # chip_smoke.STEM_BF16_ATOL


def bf16(a: np.ndarray) -> np.ndarray:
    """Round f32 to bf16 (nearest even), kept as f32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _inputs(b, h, w, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = bf16(rng.standard_normal((b, h, w, 3)).astype(np.float32))
    wt = bf16((rng.standard_normal((cout, 3, 7, 7)) * 0.05).astype(np.float32))
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, wt, scale, bias


def k_ordered_weights(wt: np.ndarray) -> np.ndarray:
    """[176, cout]: row k holds the weights of tap stem_k_taps()[k], or 0."""
    flat = wt.reshape(wt.shape[0], -1)
    taps = stem_k_taps()
    wk = np.zeros((len(taps), wt.shape[0]), np.float32)
    for k, t in enumerate(taps):
        if t >= 0:
            wk[k] = flat[:, t]
    return wk


def k_layout():
    """(kernel row, slot) of every GEMM column; the zero group reads row 0."""
    return np.array([ks if ks is not None else (0, 0) for ks in stem_k_slots()])


def emulated_stem_bf16(x, wt, scale, bias, plan):
    """The bf16 kernel's tiles, boxes, strip gather, GEMM, epilogue (E, O, Z)
    and pool in numpy; also returns how many times each pool output was
    written."""
    b, h, w, _ = x.shape
    cout = wt.shape[0]
    ch, cw = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    ph, pw = stem_output_hw(h, w)
    tpy, tpx = plan.tile
    taps = np.array(stem_k_taps())
    wk = k_ordered_weights(wt)
    rows = x.reshape(b, h, w * 3)
    out = np.zeros((b, ph, pw, cout), np.float32)
    written = np.zeros((b, ph, pw), np.int64)
    # GEMM row -> conv position: strip (sk, sx), position r: tile row 4*sk + r
    sk, sx, r = np.meshgrid(np.arange(STRIP_ROWS), np.arange(TCX), np.arange(STRIP), indexing="ij")
    sk, sx, r = sk.ravel(), sx.ravel(), r.ravel()
    kh, slot = k_layout().T
    for t in range(plan.tiles):
        img, py0, px0 = plan.origin(t)
        r0, e0, shift = plan.box_origin(py0, px0)
        assert e0 % 8 == 0 and shift % 2 == 1  # a 16-byte aligned start; even pairs
        box = np.zeros((BOX_ROWS, PITCH), np.float32)
        rr, ee = np.arange(BOX_ROWS)[:, None] + r0, np.arange(PITCH)[None, :] + e0
        inside = (rr >= 0) & (rr < h) & (ee >= 0) & (ee < 3 * w)
        box[inside] = rows[img][np.clip(rr, 0, h - 1), np.clip(ee, 0, 3 * w - 1)][inside]
        # A: box row 8*sk + 2*r + kh, element 6*sx + slot - 1 + shift
        br = (2 * STRIP * sk + 2 * r)[:, None] + kh[None, :]
        er = (6 * sx)[:, None] + slot[None, :] - 1 + shift
        assert br.max() < BOX_ROWS and er.min() >= 0 and er.max() < PITCH
        a = np.where(taps >= 0, box[br, er], np.float32(0))
        acc = a @ wk  # bf16 products exact in f32, summed in f32
        y = np.maximum(acc * scale + bias, np.float32(0))
        gy, gx = 2 * py0 - 1 + STRIP * sk + r, 2 * px0 - 1 + sx
        y[~((gy >= 0) & (gy < ch) & (gx >= 0) & (gx < cw))] = 0  # the pool's padding
        y = y.reshape(STRIP_ROWS, TCX, STRIP, cout)
        e_ = bf16(y[:, :, :3].max(axis=2))                     # [strip, col, cout]
        o_ = bf16(y[:, :, 2:].max(axis=2))
        z_ = bf16(y[:, :, 0])
        for ly in range(tpy):
            k = ly // 2
            for lx in range(tpx):
                py, px = py0 + ly, px0 + lx
                if py >= ph or px >= pw:
                    continue
                cols = slice(2 * lx, 2 * lx + 3)
                v = e_[k, cols] if ly % 2 == 0 else np.maximum(o_[k, cols], z_[k + 1, cols])
                out[img, py, px] = v.max(axis=0)
                written[img, py, px] += 1
    return out, written


def _within_one_ulp(got, want, atol):
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    return np.abs(got - want) <= ulp + atol


def _plain_bf16(x, wt, scale, bias):
    t = [torch.from_numpy(a) for a in (x, wt, scale, bias)]
    return plain_stem(t[0].bfloat16(), t[1].bfloat16(), t[2], t[3]).float().numpy()


@pytest.mark.parametrize("b,h,w,cout", ENGINE + ODD + [(2, 224, 222, 64)])
def test_plan_tiles_cover_every_pool_output_once(b, h, w, cout):
    plan = stem_plan(b, h, w, cout)
    ph, pw = stem_output_hw(h, w)
    seen = np.zeros((b, ph, pw), np.int64)
    for t in range(plan.tiles):
        img, py0, px0 = plan.origin(t)
        seen[img, py0:py0 + plan.tile[0], px0:px0 + plan.tile[1]] += 1
    assert (seen == 1).all()
    assert plan.tiles == b * plan.tiles_x * plan.tiles_y
    assert plan.grid == min(plan.tiles, plan.blocks_per_sm * 132)


@pytest.mark.parametrize("b,h,w,cout", ENGINE)
def test_plan_at_the_engine_shapes(b, h, w, cout):
    plan = stem_plan(b, h, w, cout)
    assert plan.tma and plan.tile == (7, 7) and plan.blocks_per_sm == 2
    assert (plan.tiles_x, plan.tiles_y) == (8, 8) and plan.tiles == 64 * b
    assert plan.smem_bytes == 94_992 <= MAX_SMEM
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= SM_SHARED
    assert plan.grid == min(64 * b, 2 * 132)
    # an unaligned x (a view with a storage offset) takes the plain loads
    assert not stem_plan(b, h, w, cout, aligned=False).tma


@pytest.mark.parametrize("b,h,w,cout", ODD + [(2, 224, 222, 64)])
def test_plan_at_odd_geometries_takes_plain_loads(b, h, w, cout):
    plan = stem_plan(b, h, w, cout)
    assert not plan.tma  # rows of W*6 bytes that are no multiple of 16
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= SM_SHARED


def test_strips_cover_the_tile_and_its_pool_windows():
    """4 strips of 4 conv rows hold the tile's 15 rows; pool row ly takes
    conv rows 2*ly .. 2*ly+2: rows 0-2 of strip ly/2 for an even ly, rows
    2-3 of strip ly//2 and row 0 of the next for an odd one."""
    assert STRIP * STRIP_ROWS >= TCY and STRIP_ROWS * TCX <= 64
    for ly in range(7):
        k = ly // 2
        held = ({4 * k, 4 * k + 1, 4 * k + 2} if ly % 2 == 0
                else {4 * k + 2, 4 * k + 3, 4 * (k + 1)})
        assert held == {2 * ly, 2 * ly + 1, 2 * ly + 2}
        assert max(held) < TCY


def test_f32_plan_is_the_f32_kernel():
    plan = stem_plan(32, 224, 224, 64, esize=4)
    assert (plan.tile, plan.blocks_per_sm, plan.tma) == ((8, 7), 1, False)
    assert plan.smem_bytes == 201_812


@pytest.mark.parametrize("args", [(0, 224, 224, 64), (1, 224, 224, 12), (1, 224, 224, 72),
                                  (1, 224, 224, 64, 3)])
def test_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        stem_plan(*args)


def test_k_order_is_the_pallas_kernels_per_row_order():
    rng = np.random.default_rng(3)
    wt = rng.standard_normal((64, 3, 7, 7)).astype(np.float32)
    packed = np.asarray(pack_stem_weights(wt.transpose(2, 3, 1, 0)))  # HWIO -> [7, 32, 64]
    wk = k_ordered_weights(wt)
    assert wk.shape == (176, 64) and sorted(KH_ORDER) == list(range(7))
    layout = stem_k_slots()
    column = {ks: k for k, ks in enumerate(layout) if ks is not None}
    assert sorted(column) == [(kh, s) for kh in range(7) for s in range(24)]
    for kh in range(7):
        # slot s of row kh holds Pallas tap s - 1 (kw*3 + c); slots 0, 22, 23 zero
        np.testing.assert_array_equal(wk[[column[kh, s] for s in range(1, 22)]], packed[kh, :21])
        assert not wk[[column[kh, s] for s in (0, 22, 23)]].any()
        assert not packed[kh, 21:].any()
    assert all(ks is None for ks in layout[168:]) and not wk[168:].any()
    taps = [t for t in stem_k_taps() if t >= 0]
    assert sorted(taps) == list(range(147))


@pytest.mark.parametrize("b,h,w,cout", ODD + [(1, 224, 224, 64)])
def test_emulated_bf16_kernel_matches_plain(b, h, w, cout):
    x, wt, scale, bias = _inputs(b, h, w, cout)
    plan = stem_plan(b, h, w, cout)
    got, written = emulated_stem_bf16(x, wt, scale, bias, plan)
    want = _plain_bf16(x, wt, scale, bias)
    assert (written == 1).all()
    assert got.shape == want.shape == (b, *stem_output_hw(h, w), cout)
    assert _within_one_ulp(got, want, STEM_BF16_ATOL).all()


def test_gather_reads_each_tap_of_the_conv_window():
    """Every non-padding slot of every strip position reads, from the box,
    the pixel and channel of its tap: input row 2*gy - 3 + kh, column
    2*gx - 3 + kw, channel c, for tap kw*3 + c of kernel row kh."""
    plan = stem_plan(2, 224, 224, 64)
    taps = stem_k_taps()
    for t in (0, 1, 5, plan.tiles - 1):
        _, py0, px0 = plan.origin(t)
        r0, e0, shift = plan.box_origin(py0, px0)
        for sk in range(STRIP_ROWS):
            for sx in range(TCX):
                for r in range(STRIP):
                    gy, gx = 2 * py0 - 1 + STRIP * sk + r, 2 * px0 - 1 + sx
                    for (kh, slot), tap in zip(k_layout(), taps):
                        if tap < 0:
                            continue
                        c, rest = divmod(tap, 49)
                        assert rest // 7 == kh
                        row, elem = 2 * STRIP * sk + 2 * r + kh, 6 * sx + slot - 1 + shift
                        assert row < BOX_ROWS and 0 <= elem < PITCH and elem % 2 == slot % 2
                        assert r0 + row == 2 * gy - 3 + kh
                        assert divmod(e0 + elem, 3) == (2 * gx - 3 + rest % 7, c)


def test_phase_tool_stamps_every_phase_of_the_tile_loop():
    """tools/stem_phases.py finds the six ``// phase N:`` lines of the bf16
    kernel's tile loop, in order, and stamps each."""
    import os
    import re

    from vqa_tpu_torch.ops import _build
    from vqa_tpu_torch.tools.stem_phases import PHASES, instrumented_source

    with open(os.path.join(_build.CSRC_DIR, "stem.cu")) as f:
        src = f.read()
    assert [int(n) for n in re.findall(r"^\s*// phase (\d):", src, flags=re.M)] == list(
        range(len(PHASES)))
    out = instrumented_source(src)
    assert [int(n) for n in re.findall(r"VQA_STAMP\((\d)\);", out)] == list(range(len(PHASES)))
    assert "vqa_stem_phases" in out
