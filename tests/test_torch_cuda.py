"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips (from a fixture) where no CUDA device is
present. On a machine with an NVIDIA GPU and no JAX, run them without the
suite's conftest, which imports JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes cover the full-width path and the odd geometries the kernels
accept (tiny widths, odd image sizes, C/r = 1). Tolerances are those of
the Pallas kernels' tests: stem 1e-5, SE 1e-3, cross-attention 1e-5 on
the context and 1e-6 on the weights. The bf16 forms are held to their
bf16 plain versions within one bf16 ulp per element (both compute in f32
and round once), at the same shapes.
"""

import math
from unittest import mock

import numpy as np
import pytest
import torch

from vqa_tpu_torch import ops
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dev, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)


# B = 33 at 224 px: 1,617 tiles, a ragged last wave of the persistent blocks
@pytest.mark.parametrize("b,h,w,cout", [(2, 224, 224, 64), (3, 64, 64, 8),
                                        (1, 37, 50, 16), (2, 17, 9, 24), (1, 1, 1, 8),
                                        (33, 224, 224, 64)])
def test_stem_kernel_matches_plain(cuda, b, h, w, cout):
    rng = np.random.default_rng(0)
    x = _randn(rng, (b, h, w, 3), cuda)
    wt = _randn(rng, (cout, 3, 7, 7), cuda, 0.05)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32)).to(cuda)
    bias = _randn(rng, (cout,), cuda, 0.1)
    before = ops.fused_stem.launches
    got = ops.fused_stem(x, wt, scale, bias)
    torch.cuda.synchronize()
    assert ops.fused_stem.launches == before + 1
    torch.testing.assert_close(got, ops.plain_stem(x, wt, scale, bias),
                               atol=1e-5, rtol=1e-5)


# the four full-width stages at B = 32 and B = 1 (resident, stage 1 at
# B = 32 partly), narrow widths whose images start off 16-byte alignment
# (C = 6, 12 with r = 1, 3; scalar path), C = 1, stage 1 at 448 px
# (streaming), one image of C = 2048
@pytest.mark.parametrize("b,h,w,c,r", [
    (32, 56, 56, 64, 4), (32, 28, 28, 128, 8), (32, 14, 14, 256, 16), (32, 7, 7, 512, 32),
    (1, 56, 56, 64, 4), (1, 28, 28, 128, 8), (1, 14, 14, 256, 16), (1, 7, 7, 512, 32),
    (2, 56, 56, 64, 4), (2, 7, 7, 512, 32), (3, 8, 8, 8, 1), (2, 5, 3, 12, 3),
    (3, 9, 7, 6, 1), (2, 8, 8, 6, 3), (3, 5, 5, 12, 1), (4, 6, 6, 1, 1),
    (32, 112, 112, 64, 4), (1, 7, 7, 2048, 128)])
def test_se_kernel_matches_plain(cuda, b, h, w, c, r):
    from vqa_tpu_torch.ops.se_kernel import se_plan

    rng = np.random.default_rng(1)
    x = torch.relu(_randn(rng, (b, h, w, c), cuda))
    w1, w2 = _randn(rng, (r, c), cuda, 0.2), _randn(rng, (c, r), cuda, 0.2)
    assert (se_plan(b, h * w, c, r).keep_rows == 0) is (h == 112)  # 448 px streams
    before = ops.fused_se.launches
    got = ops.fused_se(x, w1, w2)
    torch.cuda.synchronize()
    assert ops.fused_se.launches == before + 1
    torch.testing.assert_close(got, ops.plain_se(x, w1, w2), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("b,h,w,c,r", [(32, 56, 56, 64, 4), (3, 9, 7, 6, 1),
                                       (32, 112, 112, 64, 4)])
def test_se_kernel_is_deterministic(cuda, b, h, w, c, r):
    """Sums in a fixed order, no atomics: two calls agree bit for bit."""
    rng = np.random.default_rng(7)
    x = _randn(rng, (b, h, w, c), cuda)
    w1, w2 = _randn(rng, (r, c), cuda, 0.2), _randn(rng, (c, r), cuda, 0.2)
    first = ops.fused_se(x, w1, w2)
    second = ops.fused_se(x, w1, w2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# the instantiated widths (d 16/32/64, L_kv <= 64) at the main path's shapes
# (bucket 32 and bucket 1) and the tiny config's, then the general kernel:
# d 4, 6, 8, L_kv 70 and 196 (448 px)
@pytest.mark.parametrize("b,h,lq,lkv,d", [(2, 8, 20, 49, 32), (1, 2, 5, 7, 8),
                                          (3, 1, 1, 1, 4), (1, 2, 6, 70, 16),
                                          (32, 8, 20, 49, 32), (1, 8, 20, 49, 32),
                                          (2, 2, 8, 4, 16), (2, 4, 20, 49, 64),
                                          (1, 8, 20, 196, 32), (2, 3, 7, 33, 6)])
def test_cross_attention_kernel_matches_plain(cuda, b, h, lq, lkv, d):
    rng = np.random.default_rng(2)
    q, k, v = (_randn(rng, (b, h, n, d), cuda) for n in (lq, lkv, lkv))
    before = ops.fused_cross_attention.launches
    ctx, w = ops.fused_cross_attention(q, k, v, math.sqrt(d))
    torch.cuda.synchronize()
    assert ops.fused_cross_attention.launches == before + 1
    pctx, pw = ops.plain_cross_attention(q, k, v, math.sqrt(d))
    torch.testing.assert_close(ctx, pctx, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(w, pw, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("lkv,d,offset", [(49, 32, 0), (49, 32, 1), (4, 16, 0), (70, 8, 2)])
def test_cross_attention_kernel_takes_head_views(cuda, lkv, d, offset):
    """q, k, v as the model passes them: [B,H,L,d] views of [B,L,H,d]
    projections (offset > 0: row starts not 16-byte aligned, scalar
    staging); the context comes back as a view of [B,L_q,H,d] memory."""
    rng = np.random.default_rng(4)
    b, h, lq = 3, 4, 20

    def view(n):
        buf = _randn(rng, (b * n * h * d + offset,), cuda)
        return buf[offset:].view(b, n, h, d).transpose(1, 2)

    q, k, v = view(lq), view(lkv), view(lkv)
    before = ops.fused_cross_attention.launches
    ctx, w = ops.fused_cross_attention(q, k, v, math.sqrt(d))
    torch.cuda.synchronize()
    assert ops.fused_cross_attention.launches == before + 1
    assert ctx.shape == (b, h, lq, d) and ctx.transpose(1, 2).is_contiguous()
    assert w.is_contiguous()
    pctx, pw = ops.plain_cross_attention(q, k, v, math.sqrt(d))
    torch.testing.assert_close(ctx, pctx, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(w, pw, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("h", [1, 2, 4])
def test_cross_attention_kernel_at_local_head_counts(cuda, h, dtype):
    """Tensor parallelism at full width (8 heads of 32) gives each rank
    H/mp heads: H = 4, 2, 1 at mp = 2, 4, 8, as [B,H,L,32] head views of
    the rank's [B,L,H·32] projections (bucket 32); the scale stays
    1/sqrt(32)."""
    rng = np.random.default_rng(6)
    b, lq, lkv, d = 32, 20, 49, 32

    def view(n):
        return _randn(rng, (b, n, h * d), cuda).to(dtype).view(b, n, h, d).transpose(1, 2)

    q, k, v = view(lq), view(lkv), view(lkv)
    counter = ops.fused_cross_attention_bf16 if dtype == torch.bfloat16 else \
        ops.fused_cross_attention
    before = counter.launches
    ctx, w = ops.fused_cross_attention(q, k, v, math.sqrt(d))
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert ctx.shape == (b, h, lq, d) and w.shape == (b, h, lq, lkv)
    pctx, pw = ops.plain_cross_attention(q, k, v, math.sqrt(d))
    if dtype == torch.bfloat16:
        assert _ulps(ctx, pctx) <= 1 and _ulps(w, pw) <= 1
    else:
        torch.testing.assert_close(ctx, pctx, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(w, pw, atol=1e-6, rtol=1e-5)


def test_se_kernel_takes_misaligned_input(cuda):
    """x one float past a 16-byte boundary takes the scalar path."""
    rng = np.random.default_rng(8)
    x = _randn(rng, (2 * 4 * 4 * 8 + 1,), cuda)[1:].view(2, 4, 4, 8)
    w1, w2 = _randn(rng, (2, 8), cuda, 0.2), _randn(rng, (8, 2), cuda, 0.2)
    before = ops.fused_se.launches
    got = ops.fused_se(x, w1, w2)
    torch.cuda.synchronize()
    assert ops.fused_se.launches == before + 1
    torch.testing.assert_close(got, ops.plain_se(x, w1, w2), atol=1e-3, rtol=1e-3)


def test_se_kernel_refuses_an_inconsistent_plan(cuda):
    """The launcher checks the plan against its own layout."""
    from vqa_tpu_torch.ops._build import load_library
    from vqa_tpu_torch.ops.se_kernel import se_plan

    x = torch.zeros(2, 7, 7, 64, device=cuda)
    out = torch.empty_like(x)
    w1, w2 = torch.zeros(4, 64, device=cuda), torch.zeros(64, 4, device=cuda)
    p = se_plan(2, 49, 64, 4)
    lib = load_library()
    args = (x.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(), 2, 49, 64, 4)
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.vqa_se_f32(*args, p.cluster, p.keep_rows, int(p.rows), p.smem_bytes, stream) == 0
    bad = [(p.cluster, p.keep_rows, int(p.rows), p.smem_bytes + 16),
           (17, p.keep_rows, int(p.rows), p.smem_bytes), (p.cluster, 50, int(p.rows), p.smem_bytes),
           (p.cluster, 0, int(p.rows), p.smem_bytes), (p.cluster, p.keep_rows, 2, p.smem_bytes),
           (p.cluster // 2, p.keep_rows, int(p.rows), p.smem_bytes)]
    for plan in bad:
        assert lib.vqa_se_f32(*args, *plan, stream) != 0
    torch.cuda.synchronize()


def test_tiny_model_kernels_match_plain_and_cpu(cuda):
    from vqa_tpu_torch.models import create_vqa_model, forward_logits
    from vqa_tpu_torch.ops import cross_attention_kernel, se_kernel, stem_kernel
    from vqa_tpu_torch.utils.config import tiny_model_config

    cfg = tiny_model_config()
    cpu_model = create_vqa_model(config=cfg, device="cpu", seed=5)
    model = create_vqa_model(config=cfg, device=cuda, seed=5)
    rng = np.random.default_rng(3)
    images = rng.standard_normal((4, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    ids = rng.integers(1, cfg.vocab_size, (4, cfg.max_question_length))
    mask = np.ones_like(ids, dtype=np.int32)
    mask[0, 3:] = 0
    args = [torch.from_numpy(a) for a in (images, ids, mask)]
    counts = ops.launch_counts()
    got = forward_logits(model, *(a.to(cuda) for a in args))
    assert {k: ops.launch_counts()[k] - counts[k] for k in counts} == {
        **dict.fromkeys(ops.KERNELS, 0), "stem": 1, "se": 4, "cross_attention": 2}
    with mock.patch.object(stem_kernel, "fused_stem", stem_kernel.plain_stem), \
            mock.patch.object(se_kernel, "fused_se", se_kernel.plain_se), \
            mock.patch.object(cross_attention_kernel, "fused_cross_attention",
                              cross_attention_kernel.plain_cross_attention):
        plain = forward_logits(model, *(a.to(cuda) for a in args))
    torch.testing.assert_close(got, plain, atol=1e-3, rtol=0)
    torch.testing.assert_close(got.cpu(), forward_logits(cpu_model, *args),
                               atol=1e-3, rtol=0)


def test_micro_batcher_on_the_card_answers_each_request_as_alone(cuda):
    """32 concurrent submits at the tiny width: each answer within 1e-4 of
    ``engine.predict`` on that request alone, whatever group it landed in,
    and the kernels launched 1, 4 and 2 times per forward from the
    batcher's dispatch thread."""
    import io
    import threading

    from PIL import Image

    from vqa_tpu_torch.serving.batcher import MicroBatcher
    from vqa_tpu_torch.serving.engine import VQAInference
    from vqa_tpu_torch.utils.config import tiny_model_config

    engine = VQAInference(model_config=tiny_model_config(), device=cuda, seed=3,
                          dtype=torch.float32).load()
    rng = np.random.default_rng(11)
    requests = []
    for i in range(32):
        buf = io.BytesIO()
        h, w = rng.integers(20, 120, 2)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, "PNG")
        requests.append((buf.getvalue(), ["what color is the cat", "how many dogs"][i % 2]))
    want = [engine.predict(img, q, top_k=5) for img, q in requests]
    batcher = MicroBatcher(engine, batch_timeout_ms=20.0)
    results = [None] * len(requests)
    barrier = threading.Barrier(len(requests))

    def call(i):
        barrier.wait()
        results[i] = batcher.submit(*requests[i], top_k=5)

    ops.reset_launch_counts()
    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    batcher.shutdown()
    assert not any(t.is_alive() for t in threads)
    forwards = batcher.total_batches
    assert forwards < len(requests)
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0), "stem": forwards,
                                   "se": 4 * forwards, "cross_attention": 2 * forwards}
    for got, exp in zip(results, want):
        assert abs(got["confidence"] - exp["confidence"]) <= 1e-4
        for a in got["answers"]:
            match = [b for b in exp["answers"] if b["index"] == a["index"]]
            if match:
                assert abs(a["probability"] - match[0]["probability"]) <= 1e-4


def test_narrow_stem_runs_unfused_and_matches_cpu(cuda):
    """A stem of 12 features is not the stem kernel's geometry: the backbone
    runs its unfused layers (0 stem launches); the four SEs (C = 12, 24, 48,
    96; r = 1, 1, 3, 6) still launch their kernel."""
    import dataclasses

    from vqa_tpu_torch.models import create_vqa_model, forward_logits
    from vqa_tpu_torch.utils.config import tiny_model_config

    cfg = dataclasses.replace(tiny_model_config(), base_channels=12, stage_channels=None)
    assert tuple(cfg.stage_channels) == (12, 24, 48, 96)
    cpu_model = create_vqa_model(config=cfg, device="cpu", seed=6)
    model = create_vqa_model(config=cfg, device=cuda, seed=6)
    rng = np.random.default_rng(9)
    images = rng.standard_normal((3, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    ids = rng.integers(1, cfg.vocab_size, (3, cfg.max_question_length))
    mask = np.ones_like(ids, dtype=np.int32)
    args = [torch.from_numpy(a) for a in (images, ids, mask)]
    counts = ops.launch_counts()
    got = forward_logits(model, *(a.to(cuda) for a in args))
    assert {k: ops.launch_counts()[k] - counts[k] for k in counts} == {
        **dict.fromkeys(ops.KERNELS, 0), "se": 4, "cross_attention": 2}
    torch.testing.assert_close(got.cpu(), forward_logits(cpu_model, *args),
                               atol=1e-3, rtol=0)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One step from the same weights and batch (dropout off), tiny width,
    with chip_smoke.py's bounds: cuDNN off, loss within 1e-4, clipped
    gradients and BN statistics per tensor within 10x the CPU's own f32
    noise (the step on the batch in another order, and without oneDNN)
    plus floors, parameters within 2·lr; with cuDNN, the loss, BN
    statistics (1e-3) and parameters, and the gradients as a whole within
    10x that noise. No kernel launches (training mode takes the plain
    paths)."""
    import dataclasses

    import chip_smoke
    from vqa_tpu_torch.utils.config import tiny_model_config

    cfg = dataclasses.replace(tiny_model_config(), dropout=0.0, answer_dropout=0.0)
    rng = np.random.default_rng(12)
    arrays = [rng.standard_normal((8, 64, 64, 3)).astype(np.float32),
              rng.integers(4, cfg.vocab_size, (8, cfg.max_question_length)).astype(np.int32),
              np.ones((8, cfg.max_question_length), np.int32),
              rng.integers(0, cfg.num_answers, 8).astype(np.int32)]
    perm = np.arange(8)[::-1].copy()
    ops.reset_launch_counts()
    cpu = [chip_smoke.one_train_step(torch, cfg, "cpu", data, 1e-4, seed=4)
           for data in (arrays, [a[perm] for a in arrays])]
    with torch.backends.mkldnn.flags(enabled=False):
        cpu.append(chip_smoke.one_train_step(torch, cfg, "cpu", arrays, 1e-4, seed=4))
    with torch.backends.cudnn.flags(enabled=False):
        native = chip_smoke.one_train_step(torch, cfg, cuda, arrays, 1e-4, seed=4)
    card = chip_smoke.one_train_step(torch, cfg, cuda, arrays, 1e-4, seed=4)
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    out = chip_smoke.compare_train_steps(torch, cpu[0], cpu[1:], native, lr=1e-4)
    assert not out["failures"], out["failures"]
    out = chip_smoke.compare_train_steps(torch, cpu[0], cpu[1:], card, lr=1e-4)
    assert not out["cudnn_failures"], out["cudnn_failures"]


def test_device_augment_on_the_card_matches_the_cpu(cuda):
    """The same draws applied on the card and on the CPU (within 1e-5); the
    draws themselves come from a generator on the card."""
    from vqa_tpu_torch.data.preprocess import apply_augment, device_augment, draw_augment

    rng = np.random.default_rng(13)
    pixels = torch.from_numpy(rng.integers(0, 256, (16, 256, 256, 3), dtype=np.uint8))
    draws = draw_augment(16, 256, 224, torch.Generator().manual_seed(3))
    got = apply_augment(pixels.to(cuda), {k: v.to(cuda) for k, v in draws.items()}, 224)
    torch.testing.assert_close(got.cpu(), apply_augment(pixels, draws, 224),
                               atol=1e-5, rtol=0)
    gen = torch.Generator(device=cuda).manual_seed(3)
    out = device_augment(pixels.to(cuda), gen, image_size=224)
    assert out.device.type == "cuda" and out.shape == (16, 224, 224, 3)
    assert bool(torch.isfinite(out).all())


def _train_batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a) for a in (
        rng.standard_normal((b, cfg.image_size, cfg.image_size, 3)).astype(np.float32),
        rng.integers(4, cfg.vocab_size, (b, cfg.max_question_length)).astype(np.int32),
        np.ones((b, cfg.max_question_length), np.int32),
        rng.integers(0, cfg.num_answers, b).astype(np.int32))]


def test_validation_forward_launches_the_kernels_and_train_steps_none(cuda):
    from vqa_tpu_torch.models import create_vqa_model
    from vqa_tpu_torch.training.train import TrainState, make_train_step, make_val_step
    from vqa_tpu_torch.utils.config import TrainingConfig, tiny_model_config

    cfg = tiny_model_config()
    model = create_vqa_model(config=cfg, device=cuda, seed=5)
    state = TrainState.create(model, TrainingConfig(warmup_epochs=0), 10)
    images, ids, mask, labels = (a.to(cuda) for a in _train_batch(cfg, 4, 14))
    ops.reset_launch_counts()
    step = make_train_step(model)
    for _ in range(2):
        step(state, images, ids, mask, labels)
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    valid = torch.ones(4, dtype=torch.int32, device=cuda)
    out = make_val_step(model)(images, ids, mask, labels, valid)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0), "stem": 1, "se": 4,
                                   "cross_attention": 2}
    assert float(out["n"]) == 4.0 and np.isfinite(float(out["loss_sum"]))


# ---- the bf16 forms ----------------------------------------------------------


def _ulps(got, want) -> float:
    """Largest |got - want| in bf16 spacings at the larger magnitude."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp(min=2.0 ** -126)
    return float(((g - w).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def _stem_ok(got, want) -> bool:
    """Within one bf16 ulp, or the stem's f32 tolerance where the affine
    nearly cancels the conv (chip_smoke.STEM_BF16_ATOL)."""
    import chip_smoke

    return chip_smoke.bf16_compare(torch, got, want, chip_smoke.STEM_BF16_ATOL)["ok"]


def _bf16_stem_case(cuda, b, h, w, cout, offset=0):
    """x [b,h,w,3] bf16 (a view ``offset`` elements into its storage), w,
    scale and bias: the kernel's output against plain_stem, with the route
    stem_plan chose and the launch counters checked."""
    from vqa_tpu_torch.ops.stem_kernel import stem_plan

    rng = np.random.default_rng(0)
    x = _randn(rng, (b, h, w, 3), cuda).bfloat16()
    if offset:
        base = torch.zeros(x.numel() + offset, dtype=torch.bfloat16, device=cuda)
        base[offset:] = x.reshape(-1)
        x = base[offset:].view(b, h, w, 3)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    wt = _randn(rng, (cout, 3, 7, 7), cuda, 0.05).bfloat16()
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32)).to(cuda)
    bias = _randn(rng, (cout,), cuda, 0.1)
    plan = stem_plan(b, h, w, cout, 2, x.data_ptr() % 16 == 0)
    before = ops.fused_stem_bf16.launches, ops.fused_stem.launches
    got = ops.fused_stem(x, wt, scale, bias)
    torch.cuda.synchronize()
    assert (ops.fused_stem_bf16.launches, ops.fused_stem.launches) == (before[0] + 1, before[1])
    assert got.dtype == torch.bfloat16
    assert _stem_ok(got, ops.plain_stem(x, wt, scale, bias))
    return plan


# TMA where W % 8 == 0 and x is 16-byte aligned, else plain loads; B = 1,
# 8, 32 and 64 at 224 px, 33 (a ragged last wave), odd sizes on both routes
@pytest.mark.parametrize("b,h,w,cout", [(2, 224, 224, 64), (3, 64, 64, 8),
                                        (1, 37, 50, 16), (2, 17, 9, 24), (1, 1, 1, 8),
                                        (33, 224, 224, 64), (32, 224, 224, 64),
                                        (2, 224, 222, 64), (1, 224, 224, 64),
                                        (8, 224, 224, 64), (64, 224, 224, 64),
                                        (2, 37, 40, 16)])
def test_bf16_stem_kernel_matches_plain(cuda, b, h, w, cout):
    plan = _bf16_stem_case(cuda, b, h, w, cout)
    assert plan.tma == (w % 8 == 0)


# a view with a storage offset: not 16-byte aligned, so the plain-load route
@pytest.mark.parametrize("b,h,w,cout,offset", [(2, 224, 224, 64, 1), (1, 64, 64, 8, 3)])
def test_bf16_stem_kernel_takes_an_unaligned_x(cuda, b, h, w, cout, offset):
    assert not _bf16_stem_case(cuda, b, h, w, cout, offset).tma


def test_bf16_stem_kernel_refuses_an_inconsistent_plan(cuda):
    """The launcher checks the plan against its own layout and refuses TMA
    where x cannot take it, rather than launching a kernel that faults."""
    from vqa_tpu_torch.ops._build import load_library
    from vqa_tpu_torch.ops.stem_kernel import stem_plan

    lib = load_library()
    stream = torch.cuda.current_stream().cuda_stream
    for w, offset in ((64, 0), (60, 0), (64, 1)):
        base = torch.zeros(2 * 64 * w * 3 + offset, dtype=torch.bfloat16, device=cuda)
        x = base[offset:].view(2, 64, w, 3)
        wt = torch.zeros(64, 3, 7, 7, dtype=torch.bfloat16, device=cuda)
        sb = torch.zeros(64, device=cuda)
        out = torch.empty(2, 16, (w + 3) // 4, 64, dtype=torch.bfloat16, device=cuda)
        p = stem_plan(2, 64, w, 64, 2, x.data_ptr() % 16 == 0)
        args = (x.data_ptr(), wt.data_ptr(), sb.data_ptr(), sb.data_ptr(), out.data_ptr(), 2, 64,
                w, 64)
        assert p.tma == (w == 64 and offset == 0)
        assert lib.vqa_stem_bf16(*args, int(p.tma), p.smem_bytes, stream) == 0
        assert lib.vqa_stem_bf16(*args, int(p.tma), p.smem_bytes + 16, stream) != 0
        if not p.tma:
            assert lib.vqa_stem_bf16(*args, 1, p.smem_bytes, stream) != 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("b,h,w,c,r", [
    (32, 56, 56, 64, 4), (32, 28, 28, 128, 8), (32, 14, 14, 256, 16), (32, 7, 7, 512, 32),
    (1, 56, 56, 64, 4), (1, 7, 7, 512, 32), (3, 8, 8, 8, 1), (2, 5, 3, 12, 3),
    (3, 9, 7, 6, 1), (4, 6, 6, 1, 1), (32, 112, 112, 64, 4), (1, 7, 7, 2048, 128)])
def test_bf16_se_kernel_matches_plain(cuda, b, h, w, c, r):
    rng = np.random.default_rng(1)
    x = torch.relu(_randn(rng, (b, h, w, c), cuda)).bfloat16()
    w1, w2 = _randn(rng, (r, c), cuda, 0.2).bfloat16(), _randn(rng, (c, r), cuda, 0.2).bfloat16()
    before = ops.fused_se_bf16.launches
    got = ops.fused_se(x, w1, w2)
    again = ops.fused_se(x, w1, w2)
    torch.cuda.synchronize()
    assert ops.fused_se_bf16.launches == before + 2 and got.dtype == torch.bfloat16
    assert torch.equal(got, again)  # a fixed order of sums, no atomics
    assert _ulps(got, ops.plain_se(x, w1, w2)) <= 1


def test_bf16_se_kernel_takes_misaligned_input_and_refuses_the_f32_plan(cuda):
    from vqa_tpu_torch.ops._build import load_library
    from vqa_tpu_torch.ops.se_kernel import se_plan

    rng = np.random.default_rng(8)
    x = _randn(rng, (2 * 4 * 4 * 16 + 1,), cuda).bfloat16()[1:].view(2, 4, 4, 16)
    w1, w2 = _randn(rng, (2, 16), cuda, 0.2).bfloat16(), _randn(rng, (16, 2), cuda, 0.2).bfloat16()
    assert _ulps(ops.fused_se(x, w1, w2), ops.plain_se(x, w1, w2)) <= 1
    x = torch.zeros(2, 56, 56, 64, device=cuda, dtype=torch.bfloat16)
    out = torch.empty_like(x)
    w1 = torch.zeros(4, 64, device=cuda, dtype=torch.bfloat16)
    w2 = torch.zeros(64, 4, device=cuda, dtype=torch.bfloat16)
    args = (x.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(), 2, 56 * 56, 64, 4)
    stream = torch.cuda.current_stream().cuda_stream
    for esize, ok in ((2, True), (4, False)):
        p = se_plan(2, 56 * 56, 64, 4, esize)
        rc = load_library().vqa_se_bf16(*args, p.cluster, p.keep_rows, int(p.rows),
                                        p.smem_bytes, stream)
        assert (rc == 0) is ok
    torch.cuda.synchronize()


@pytest.mark.parametrize("b,h,w,c,r", [(32, 56, 56, 64, 4), (3, 9, 7, 6, 1),
                                       (32, 112, 112, 64, 4), (32, 7, 7, 512, 32),
                                       (32, 14, 14, 256, 16)])
def test_bf16_se_kernel_is_deterministic(cuda, b, h, w, c, r):
    """The bf16 form's twin of the f32 test: sums in a fixed order, no
    atomics, so two calls agree bit for bit, a block alone (stage 4), a
    cluster split by channels (stage 3), by rows (stage 1) and streaming
    part of its rows (448 px)."""
    rng = np.random.default_rng(7)
    x = _randn(rng, (b, h, w, c), cuda).bfloat16()
    w1, w2 = _randn(rng, (r, c), cuda, 0.2).bfloat16(), _randn(rng, (c, r), cuda, 0.2).bfloat16()
    first = ops.fused_se(x, w1, w2)
    second = ops.fused_se(x, w1, w2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# the narrow widths of test_torch_models.py::test_narrow_widths_match_jax
# (tiny stages of 8-64 channels, a first stage of 12, a last of 6) and
# CBAMBlock's (reduction 8; chip_smoke's module shapes at reduction 16)
@pytest.mark.parametrize("b,h,w,c,r", [
    (2, 16, 16, 8, 1), (2, 8, 8, 16, 1), (2, 4, 4, 32, 2), (2, 2, 2, 64, 4),
    (2, 16, 16, 12, 1), (2, 2, 2, 6, 1), (2, 7, 7, 32, 4), (2, 5, 3, 16, 2),
    (32, 7, 7, 512, 32), (32, 56, 56, 64, 4)])
def test_bf16_se_kernel_at_narrow_and_cbam_widths(cuda, b, h, w, c, r):
    rng = np.random.default_rng(9)
    x = torch.relu(_randn(rng, (b, h, w, c), cuda)).bfloat16()
    w1, w2 = _randn(rng, (r, c), cuda, 0.2).bfloat16(), _randn(rng, (c, r), cuda, 0.2).bfloat16()
    before = ops.fused_se_bf16.launches
    got = ops.fused_se(x, w1, w2)
    torch.cuda.synchronize()
    assert ops.fused_se_bf16.launches == before + 1
    assert _ulps(got, ops.plain_se(x, w1, w2)) <= 1


@pytest.mark.parametrize("b,side,c,r", [(8, 28, 128, 8), (3, 56, 64, 4), (2, 7, 512, 32)])
def test_bf16_se_kernel_takes_every_plan(cuda, b, side, c, r):
    """Through the launcher, every plan the sweep tool tries: 1 to 16
    blocks per image, split by rows or by channels, every row resident or
    every row streamed from device memory (read twice); each within one
    ulp of plain_se and deterministic."""
    from vqa_tpu_torch.ops._build import load_library
    from vqa_tpu_torch.tools.se_plan_sweep import plans

    rng = np.random.default_rng(10)
    hw = side * side
    x = torch.relu(_randn(rng, (b, side, side, c), cuda)).bfloat16()
    w1, w2 = _randn(rng, (r, c), cuda, 0.2).bfloat16(), _randn(rng, (c, r), cuda, 0.2).bfloat16()
    want = ops.plain_se(x, w1, w2)
    stream = torch.cuda.current_stream().cuda_stream
    tried = set()
    for plan in plans(hw, c, r, 2):
        outs = []
        for _ in range(2):
            out = torch.full_like(x, float("nan"))
            rc = load_library().vqa_se_bf16(
                x.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(), b, hw, c, r,
                plan.cluster, plan.keep_rows, int(plan.rows), plan.smem_bytes, stream)
            assert rc == 0, plan
            outs.append(out)
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1]), plan
        assert _ulps(outs[0], want) <= 1, plan
        tried.add((plan.cluster, plan.keep_rows == 0))
    assert any(streamed for _, streamed in tried) and any(not streamed for _, streamed in tried)
    assert any(n == 1 for n, _ in tried)


def test_bf16_kernels_replay_in_a_cuda_graph(cuda):
    """Each bf16 kernel captured in a CUDA graph (as the engine's and the
    trainer's graphs capture them) replays what an eager call computes on
    the inputs copied into the captured tensors."""
    rng = np.random.default_rng(11)
    xs = [torch.relu(_randn(rng, (32, s, s, c), cuda)).bfloat16()
          for s, c in ((56, 64), (7, 512))]
    ws = [(_randn(rng, (c // 16, c), cuda, 0.2).bfloat16(),
           _randn(rng, (c, c // 16), cuda, 0.2).bfloat16()) for c in (64, 512)]
    q, k, v = (_randn(rng, (32, n, 8, 32), cuda).bfloat16().transpose(1, 2) for n in (20, 49, 49))
    sc = math.sqrt(32)

    def run():
        return ([ops.fused_se(x, *w) for x, w in zip(xs, ws)]
                + list(ops.fused_cross_attention(q, k, v, sc)))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = ops.fused_se_bf16.launches, ops.fused_cross_attention_bf16.launches
    with torch.cuda.graph(graph):
        static = run()
    assert (ops.fused_se_bf16.launches, ops.fused_cross_attention_bf16.launches) == (
        before[0] + 2, before[1] + 1)
    for t in (*xs, q, k, v):
        t.copy_(torch.relu(_randn(rng, tuple(t.shape), cuda)).bfloat16())
    graph.replay()
    eager = run()
    torch.cuda.synchronize()
    for got, want in zip(static, eager):
        assert torch.equal(got, want)


def test_bf16_cross_attention_geometry_matches_the_library(cuda):
    """ops/cross_attention_kernel.py:bf16_geometry mirrors the launcher's
    geometry (warps and threads per block, shared memory) and its
    refusals."""
    import ctypes

    from vqa_tpu_torch.ops._build import load_library
    from vqa_tpu_torch.ops.cross_attention_kernel import bf16_geometry

    lib = load_library()
    out = (ctypes.c_int * 3)()
    for b, h, lq, lkv, d in ((32, 8, 20, 49, 32), (1, 1, 20, 49, 32), (3, 4, 20, 49, 64),
                             (2, 3, 7, 33, 6), (1, 8, 20, 196, 32), (2, 2, 400, 64, 32),
                             (1, 2, 20, 256, 128), (3, 2, 8, 4, 16)):
        g = bf16_geometry(b * h, lq, lkv, d)
        assert lib.vqa_cross_attention_bf16_geometry(b, h, lq, lkv, d, out) == 0
        assert list(out) == [g.warps, g.threads, g.smem_bytes]
    for b, h, lq, lkv, d in ((1, 1, 20, 49, 129), (1, 1, 20, 257, 32), (2, 2, 9000, 49, 32)):
        with pytest.raises(ValueError):
            bf16_geometry(b * h, lq, lkv, d)
        assert lib.vqa_cross_attention_bf16_geometry(b, h, lq, lkv, d, out) != 0


@pytest.mark.parametrize("b,h,lq,lkv,d", [(32, 8, 20, 49, 32), (1, 8, 20, 49, 32),
                                          (1, 2, 5, 7, 8), (3, 1, 1, 1, 4), (1, 2, 6, 70, 16),
                                          (2, 4, 20, 49, 64), (1, 8, 20, 196, 32),
                                          (2, 3, 7, 33, 6), (3, 3, 37, 101, 32),
                                          (1, 1, 20, 49, 32), (1, 2, 40, 192, 128)])
def test_bf16_cross_attention_kernel_matches_plain(cuda, b, h, lq, lkv, d):
    rng = np.random.default_rng(2)
    q, k, v = (_randn(rng, (b, h, n, d), cuda).bfloat16() for n in (lq, lkv, lkv))
    before = ops.fused_cross_attention_bf16.launches
    ctx, w = ops.fused_cross_attention(q, k, v, math.sqrt(d))
    torch.cuda.synchronize()
    assert ops.fused_cross_attention_bf16.launches == before + 1
    assert ctx.dtype == w.dtype == torch.bfloat16
    pctx, pw = ops.plain_cross_attention(q, k, v, math.sqrt(d))
    assert _ulps(ctx, pctx) <= 1 and _ulps(w, pw) <= 1


@pytest.mark.parametrize("lkv,d,offset", [(49, 32, 0), (49, 32, 1), (49, 32, 4), (70, 8, 2)])
def test_bf16_cross_attention_kernel_takes_head_views(cuda, lkv, d, offset):
    """Head views of [B,L,H,d] bf16 projections; offsets of 1 and 2
    elements leave row starts off 8 bytes (single-element staging), 4 on."""
    rng = np.random.default_rng(4)
    b, h, lq = 3, 4, 20

    def view(n):
        buf = _randn(rng, (b * n * h * d + offset,), cuda).bfloat16()
        return buf[offset:].view(b, n, h, d).transpose(1, 2)

    q, k, v = view(lq), view(lkv), view(lkv)
    ctx, w = ops.fused_cross_attention(q, k, v, math.sqrt(d))
    torch.cuda.synchronize()
    assert ctx.shape == (b, h, lq, d) and ctx.transpose(1, 2).is_contiguous()
    pctx, pw = ops.plain_cross_attention(q, k, v, math.sqrt(d))
    assert _ulps(ctx, pctx) <= 1 and _ulps(w, pw) <= 1


def test_tiny_model_bf16_kernels_match_plain_and_f32(cuda):
    """The bf16 model launches the bf16 forms 1, 4 and 2 times; its logits
    through the kernels are no further from its bf16 plain versions than
    those are from the f32 model's."""
    from vqa_tpu_torch.models import create_vqa_model, forward_logits
    from vqa_tpu_torch.ops import cross_attention_kernel, se_kernel, stem_kernel
    from vqa_tpu_torch.utils.config import tiny_model_config

    cfg = tiny_model_config()
    m32 = create_vqa_model(config=cfg, device=cuda, seed=5)
    m16 = create_vqa_model(config=cfg, device=cuda, seed=5, dtype=torch.bfloat16)
    rng = np.random.default_rng(3)
    images = rng.standard_normal((8, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    ids = rng.integers(1, cfg.vocab_size, (8, cfg.max_question_length))
    mask = np.ones_like(ids, dtype=np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in (images, ids, mask)]
    counts = ops.launch_counts()
    got = forward_logits(m16, *args)
    assert {k: ops.launch_counts()[k] - counts[k] for k in counts} == {
        **dict.fromkeys(ops.KERNELS, 0), "stem_bf16": 1, "se_bf16": 4,
        "cross_attention_bf16": 2}
    with mock.patch.object(stem_kernel, "fused_stem", stem_kernel.plain_stem), \
            mock.patch.object(se_kernel, "fused_se", se_kernel.plain_se), \
            mock.patch.object(cross_attention_kernel, "fused_cross_attention",
                              cross_attention_kernel.plain_cross_attention):
        plain = forward_logits(m16, *args)
    f32 = forward_logits(m32, *args)
    assert got.dtype == torch.float32
    assert float((got - plain).abs().max()) <= float((plain - f32).abs().max())


def test_default_engine_on_the_card_is_bf16(cuda):
    from vqa_tpu_torch.serving.engine import VQAInference
    from vqa_tpu_torch.utils.config import tiny_model_config

    engine = VQAInference(model_config=tiny_model_config(), device=cuda).load()
    assert engine.dtype == engine.model.dtype == torch.bfloat16
    counts = ops.launch_counts()
    probs = engine.predict_batch_raw([np.zeros((40, 50, 3), np.uint8)], ["what is this"])
    assert probs.dtype == np.float32 and abs(float(probs.sum()) - 1) < 1e-5
    assert ops.launch_counts()["stem_bf16"] == counts["stem_bf16"] + 1


# ---- bf16 training -----------------------------------------------------------


def test_bf16_train_step_on_the_card_matches_the_cpu(cuda):
    """One bf16 step from the same weights and batch (dropout off), tiny
    width, each side beside its f32 step, with chip_smoke.py's phase 12 (a)
    bound (``compare_bf16_steps``): per tensor within twice the CPU's own
    bf16 noise plus floors (a stated few tensors within four times it),
    the card's own noise at most twice the CPU's, parameters within 2·lr,
    everything f32."""
    import dataclasses

    import chip_smoke
    from vqa_tpu_torch.utils.config import tiny_model_config

    cfg = dataclasses.replace(tiny_model_config(), dropout=0.0, answer_dropout=0.0)
    arrays = [a.numpy() for a in _train_batch(cfg, 8, 15)]
    runs = {name: chip_smoke.one_train_step(torch, cfg, where, arrays, 1e-4, seed=4, dtype=dtype)
            for name, where, dtype in (("cpu32", "cpu", torch.float32),
                                       ("cpu16", "cpu", torch.bfloat16),
                                       ("card32", cuda, torch.float32),
                                       ("card16", cuda, torch.bfloat16))}
    out = chip_smoke.compare_bf16_steps(torch, runs, lr=1e-4)
    assert not out["failures"], out["failures"]


def test_remat_lowers_peak_memory_on_the_card(cuda):
    """Full width, B = 32, bf16: the first step's loss the same for the
    three modes; over the second step (the optimizer state already made),
    the memory taken beyond what the step starts with is under 3/4 of
    none's with "stages", and within 5% of none's with "full", whose one
    segment rematerialises every activation before the backward."""
    from vqa_tpu_torch.models import create_vqa_model
    from vqa_tpu_torch.training.train import TrainState, make_train_step
    from vqa_tpu_torch.utils.config import ModelConfig, TrainingConfig

    cfg = ModelConfig()
    batch = [a.to(cuda) for a in _train_batch(cfg, 32, 16)]
    peak, loss = {}, {}
    for mode in ("none", "stages", "full"):
        model = create_vqa_model(config=cfg, device=cuda, seed=6, dtype=torch.bfloat16)
        state = TrainState.create(model, TrainingConfig(warmup_epochs=0), 10)
        step = make_train_step(model, remat=mode)
        torch.manual_seed(3)
        loss[mode] = float(step(state, *batch)["loss"])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(cuda)
        start = torch.cuda.memory_allocated(cuda)
        step(state, *batch)
        torch.cuda.synchronize()
        peak[mode] = torch.cuda.max_memory_allocated(cuda) - start
        del model, state, step
    assert peak["stages"] < 0.75 * peak["none"], peak
    assert peak["full"] <= 1.05 * peak["none"], peak
    assert loss["stages"] == pytest.approx(loss["none"], abs=1e-6)
    assert loss["full"] == pytest.approx(loss["none"], abs=1e-6)


def test_bf16_trainer_validation_launches_the_bf16_forms_and_train_steps_none(cuda):
    """A tiny bf16 Trainer epoch: no kernel in the train steps; each
    validation forward launches the bf16 stem, SE and cross-attention 1, 4
    and 2 times and the f32 forms none."""
    from vqa_tpu_torch.data.dataset import create_demo_loaders
    from vqa_tpu_torch.models import create_vqa_model
    from vqa_tpu_torch.training.train import Trainer
    from vqa_tpu_torch.utils.config import TrainingConfig, tiny_model_config

    cfg = tiny_model_config()
    train_loader, val_loader = create_demo_loaders(
        batch_size=4, eval_batch_size=4, num_samples=16, image_size=cfg.image_size,
        max_question_length=cfg.max_question_length, vocab_size=cfg.vocab_size,
        num_answers=cfg.num_answers)
    model = create_vqa_model(config=cfg, device=cuda, seed=5, dtype=torch.bfloat16)
    trainer = Trainer(model, train_loader, val_loader,
                      config=TrainingConfig(warmup_epochs=0, num_epochs=1),
                      save_checkpoints=False)
    ops.reset_launch_counts()
    metrics = trainer.train_epoch(0)
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert np.isfinite(metrics["train_loss"])
    assert all(p.dtype == torch.float32 for p in model.parameters())
    out = trainer.validate()
    torch.cuda.synchronize()
    n = len(val_loader)
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0), "stem_bf16": n,
                                   "se_bf16": 4 * n, "cross_attention_bf16": 2 * n}
    assert np.isfinite(out["val_loss"])


def test_cbam_and_self_attention_2d_on_the_card_match_the_cpu(cuda):
    """chip_smoke.py phase 14 (b): CBAMBlock and SelfAttention2D at the
    backbone's stage-output shapes ([32,512,7,7] and [32,64,56,56]), seeded
    weights, SelfAttention2D's gamma 0.5: the card's f32 forward (TF32 off)
    within 1e-4 of the CPU's, and CBAMBlock launching the SE kernel once per
    eval call, in f32 and in bf16."""
    import chip_smoke

    out, launches = chip_smoke.attention_modules_on_card(torch, np.random.default_rng(0))
    assert len(out) == 4
    assert all(r["max_abs_err"] <= chip_smoke.MODULE_TOL for r in out.values())
    assert launches == {"stem": 0, "se": 2, "cross_attention": 0, "stem_bf16": 0,
                        "se_bf16": 2, "cross_attention_bf16": 0}


# ---- the engine's CUDA graphs ------------------------------------------------


def _graphed_engine(cuda, dtype, mesh=None):
    from vqa_tpu_torch.serving.engine import VQAInference
    from vqa_tpu_torch.utils.config import tiny_model_config

    engine = VQAInference(model_config=tiny_model_config(), device=cuda, seed=3, dtype=dtype,
                          mesh=mesh).load()
    assert sorted(engine._graphs) == engine._effective_buckets()
    return engine


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_engine_graphs_replay_the_eager_forward(cuda, dtype):
    """chip_smoke.py phase 15 (a) at the tiny width: at every bucket the
    replayed probabilities against the eager forward on the same new
    inputs, f32 within 1e-4, bf16 within twice the bucket spread (at least
    1e-4)."""
    import chip_smoke

    engine = _graphed_engine(cuda, dtype)
    rng = np.random.default_rng(0)
    tol = chip_smoke.GRAPH_TOL
    if dtype == torch.bfloat16:
        tol = max(tol, 2 * max(chip_smoke.bucket_spread(engine, rng).values()))
    errs = chip_smoke.graphs_match_eager(engine, rng, tol)
    assert sorted(errs) == engine._effective_buckets()


def test_engine_dispatch_records_whether_the_card_had_drained(cuda):
    """``engine.dispatch``'s value: 1 where the card had finished every
    earlier dispatch when it began (after a synchronize), 0 where one was
    still queued (behind ~30 ms of spinning on the stream)."""
    from vqa_tpu_torch.utils.profiling import spans

    engine = _graphed_engine(cuda, torch.bfloat16)
    size = engine.model.config.image_size
    pixels, qs = np.zeros((4, size, size, 3), np.uint8), ["what is this"] * 4
    engine.dispatch_probs_from_pixels(pixels, qs)
    torch.cuda.synchronize()
    total = spans("engine.dispatch")[1]
    torch.cuda._sleep(50_000_000)
    engine.dispatch_probs_from_pixels(pixels, qs)  # the previous one is done
    engine.dispatch_probs_from_pixels(pixels, qs)  # the previous one waits behind the sleep
    torch.cuda.synchronize()
    engine.dispatch_probs_from_pixels(pixels, qs)
    torch.cuda.synchronize()
    assert [r.value for r in spans("engine.dispatch")[0] if r.seq >= total] == [1, 0, 1]


def test_engine_graph_chunks_do_not_alias(cuda):
    """Phase 15 (b): 70 requests in one call (three chunks, all dispatched
    before any is fetched) equal each chunk dispatched alone."""
    import chip_smoke

    engine = _graphed_engine(cuda, torch.float32)
    assert chip_smoke.chunks_do_not_alias(engine, np.random.default_rng(1)) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_engine_graph_replays_count_their_launches(cuda, dtype):
    """Phase 15 (c): each replayed forward adds the dtype's forms 1, 4 and
    2 times (recorded at capture), the capture itself none."""
    import chip_smoke

    before = ops.launch_counts()
    engine = _graphed_engine(cuda, dtype)
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    graphs_per_replica = {k: g[0].launches for k, g in engine._graphs.items()}
    assert all(v == {"stem" + suffix: 1, "se" + suffix: 4, "cross_attention" + suffix: 2}
               for v in graphs_per_replica.values())
    # load counted the capture's eager warm forwards and not the capture
    from vqa_tpu_torch.serving import graphs

    loaded = {k: ops.launch_counts()[k] - before[k] for k in before}
    assert loaded["se" + suffix] == 4 * graphs.WARM_FORWARDS * len(engine._graphs)
    chip_smoke.launches_per_replay(torch, engine)


def test_two_graphed_replicas_on_one_card_match_one(cuda):
    """Phase 13 (c) at the tiny width: two replicas on cuda:0, each with
    graphs of its own, within 1e-4 of one replica at n = 1 (bucket 2) and
    32, each dispatch replaying both replicas' graphs."""
    from vqa_tpu_torch.parallel import mesh_from_config
    from vqa_tpu_torch.utils.config import MeshConfig

    mesh = mesh_from_config(MeshConfig(data_parallel=2), devices=[cuda, cuda])
    one = _graphed_engine(cuda, torch.float32)
    two = _graphed_engine(cuda, torch.float32, mesh=mesh)
    assert all(len(gs) == 2 for gs in two._graphs.values())
    assert len({g.output.data_ptr() for gs in two._graphs.values() for g in gs}) == 8
    rng = np.random.default_rng(8)
    for n in (1, 32):
        pixels = rng.integers(0, 256, (n, 64, 64, 3), np.uint8)
        questions = ["what color is the cat", "is this a man"] * (n // 2) or ["what is this"]
        want = one.predict_probs_from_pixels(pixels, questions[:n])
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        got = two.predict_probs_from_pixels(pixels, questions[:n])
        assert np.abs(got - want).max() <= 1e-4
        assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0), "stem": 2, "se": 8,
                                       "cross_attention": 4}


# ---- the trainer's CUDA graphs -------------------------------------------------


def _graph_batches(cfg, cuda, n=5, b=8):
    return [[t.to(cuda) for t in _train_batch(cfg, b, 40 + i)] for i in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_train_graph_matches_the_eager_step(cuda, dtype):
    """Five steps at tiny width from the same weights, batches and dropout
    generator, eagerly and through one graph (two eager warm steps, the
    capture's replay, two more), deterministic cuDNN: chip_smoke.py phase
    16 (a)'s bounds: within 1e-6 (the same kernels on the same state),
    and bf16 also by ``compare_bf16_steps`` against the two f32 runs; the
    generator's state before each step equal."""
    import chip_smoke
    from vqa_tpu_torch.utils.config import tiny_model_config

    cfg = tiny_model_config()
    batches = _graph_batches(cfg, cuda)
    runs = {}
    for name, dt in (("32", torch.float32), ("16", dtype)):
        runs["eager" + name] = chip_smoke.train_runs(torch, cfg, cuda, batches, dtype=dt)
        runs["graph" + name] = chip_smoke.train_runs(torch, cfg, cuda, batches, dtype=dt,
                                                     graphed=True)
    graph = runs["graph16"]
    assert (graph["step"].calls.eager_calls, graph["step"].calls.replays) == (2, 3)
    r = chip_smoke.compare_runs(torch, graph, runs["eager16"])
    assert r["rng_equal"]
    assert max(r[k] for k in ("loss", "grad_norm", "param", "grad", "bn")) <= 1e-6, r
    if dtype == torch.bfloat16:
        out = chip_smoke.compare_bf16_steps(torch, {k: (run["model"], {"loss": run["losses"][-1]})
                                                    for k, run in (
            ("cpu32", runs["eager32"]), ("cpu16", runs["eager16"]),
            ("card32", runs["graph32"]), ("card16", graph))}, lr=1e-4)
        assert not out["failures"], out["failures"]


def test_train_graph_draws_fresh_dropout_masks_per_replay(cuda):
    """Two replays on one batch at learning rate 0: the weights stay, the
    losses differ (other dropout masks)."""
    import chip_smoke
    from vqa_tpu_torch.utils.config import tiny_model_config

    cfg = tiny_model_config()
    batches = _graph_batches(cfg, cuda)
    run = chip_smoke.train_runs(torch, cfg, cuda, batches, graphed=True)
    losses = chip_smoke.fresh_masks(torch, run, batches[0])["losses"]
    assert losses[0] != losses[1]


def test_train_graph_augment_is_bit_equal_to_eager(cuda):
    """The augmentation graph, its generator seeded before each call, gives
    the eager augmentation's pixels from the same seeds, bit for bit."""
    from vqa_tpu_torch.data.preprocess import device_augment
    from vqa_tpu_torch.utils.graphs import GraphedCalls

    rng = np.random.default_rng(17)
    pixels = torch.from_numpy(rng.integers(0, 256, (8, 96, 96, 3), dtype=np.uint8)).to(cuda)
    gen = torch.Generator(device=cuda)
    graphed = GraphedCalls(lambda px: device_augment(px, gen, image_size=64), generators=(gen,))
    outs = []
    for seed in range(6):
        gen.manual_seed(seed)
        got = graphed(pixels)
        want = device_augment(pixels, torch.Generator(device=cuda).manual_seed(seed),
                              image_size=64)
        assert torch.equal(got, want), seed
        outs.append(got)
    assert graphed.replays == 4 and not torch.equal(outs[-1], outs[-2])


def test_train_graph_validation_after_a_weight_change(cuda):
    """A bf16 Trainer's validation graph, captured before an epoch of
    training, gives the eager validation of the trained weights after it
    (the bf16 copies it reads are refreshed in place), and launches the
    bf16 forms 1, 4 and 2 times per replay."""
    from vqa_tpu_torch.data.dataset import create_demo_loaders
    from vqa_tpu_torch.models import create_vqa_model
    from vqa_tpu_torch.training.train import Trainer, make_val_step
    from vqa_tpu_torch.utils.config import TrainingConfig, tiny_model_config

    cfg = tiny_model_config()
    train_loader, val_loader = create_demo_loaders(
        batch_size=4, eval_batch_size=4, num_samples=80, image_size=cfg.image_size,
        max_question_length=cfg.max_question_length, vocab_size=cfg.vocab_size,
        num_answers=cfg.num_answers)
    model = create_vqa_model(config=cfg, device=cuda, seed=5, dtype=torch.bfloat16)
    trainer = Trainer(model, train_loader, val_loader,
                      config=TrainingConfig(warmup_epochs=0, num_epochs=1),
                      save_checkpoints=False)
    before = trainer.validate()
    trainer.train_epoch(0)
    ops.reset_launch_counts()
    graphed = trainer.validate()
    torch.cuda.synchronize()
    n = len(val_loader)
    assert trainer.val_step.replays == 2 * n - 2
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0), "stem_bf16": n,
                                   "se_bf16": 4 * n, "cross_attention_bf16": 2 * n}
    trainer.val_step = make_val_step(model, num_types=len(trainer.val_type_vocab or ()))
    eager = trainer.validate()
    assert graphed["val_loss"] == pytest.approx(eager["val_loss"], rel=1e-6, abs=1e-6)
    assert graphed["val_top1"] == eager["val_top1"]
    assert graphed["val_loss"] != before["val_loss"]


def test_train_graph_resume_across_the_optimizer_forms(cuda, tmp_path):
    """A checkpoint of the card's capturable AdamW resumes in the CPU's
    plain AdamW and back: each keeps its own form (a rate tensor on the
    card, a float on the CPU), the moments and step counts carry over, and
    the card's next step after the round trip is the one it would have
    taken."""
    import dataclasses

    from vqa_tpu_torch.data.dataset import create_demo_loaders
    from vqa_tpu_torch.models import create_vqa_model
    from vqa_tpu_torch.training.train import Trainer
    from vqa_tpu_torch.utils.config import TrainingConfig, tiny_model_config

    cfg = dataclasses.replace(tiny_model_config(), dropout=0.0, answer_dropout=0.0)

    def trainer(where, ckpt):
        loaders = create_demo_loaders(
            batch_size=4, eval_batch_size=4, num_samples=40, image_size=cfg.image_size,
            max_question_length=cfg.max_question_length, vocab_size=cfg.vocab_size,
            num_answers=cfg.num_answers)
        return Trainer(create_vqa_model(config=cfg, device=where, seed=5), *loaders,
                       config=TrainingConfig(warmup_epochs=0, num_epochs=2),
                       checkpoint_dir=str(ckpt), seed=5)

    card = trainer(cuda, tmp_path / "card")
    card.train_loader.set_epoch(0)
    card.train_epoch(0)
    card.save("latest", 0)
    cpu = trainer("cpu", tmp_path / "card")
    cpu.resume("latest")
    group = cpu.state.optimizer.param_groups[0]
    assert group["capturable"] is False and isinstance(group["lr"], float)
    for p, q in zip(card.model.parameters(), cpu.model.parameters()):
        a, b = card.state.optimizer.state[p], cpu.state.optimizer.state[q]
        assert torch.equal(a["exp_avg"].cpu(), b["exp_avg"])
        assert float(a["step"]) == float(b["step"]) and b["step"].device.type == "cpu"
    cpu.checkpoint_dir = str(tmp_path / "cpu")
    cpu.save("latest", 0)
    back = trainer(cuda, tmp_path / "cpu")
    lr = back.state.optimizer.param_groups[0]["lr"]
    back.resume("latest")
    group = back.state.optimizer.param_groups[0]
    assert group["capturable"] is True and group["lr"] is lr and lr.device.type == "cuda"
    assert all(st["step"].device.type == "cuda" for st in back.state.optimizer.state.values())
    batch = [t.to(cuda) for t in _train_batch(cfg, 4, 19)]
    losses = [float(t.train_step(t.state, *batch)["loss"]) for t in (card, back)]
    assert losses[1] == pytest.approx(losses[0], abs=1e-5)
    for a, b in zip(card.model.parameters(), back.model.parameters()):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_train_graph_resume_after_the_capture(cuda, tmp_path):
    """A resume after the step's graph was captured loads the checkpoint's
    moments and counts into the tensors the graph reads: the graphed
    trainer's next step equals that of a fresh trainer resumed from the
    same checkpoint."""
    import dataclasses

    from vqa_tpu_torch.data.dataset import create_demo_loaders
    from vqa_tpu_torch.models import create_vqa_model
    from vqa_tpu_torch.training.train import Trainer
    from vqa_tpu_torch.utils.config import TrainingConfig, tiny_model_config

    cfg = dataclasses.replace(tiny_model_config(), dropout=0.0, answer_dropout=0.0)

    def trainer():
        loaders = create_demo_loaders(
            batch_size=4, eval_batch_size=4, num_samples=40, image_size=cfg.image_size,
            max_question_length=cfg.max_question_length, vocab_size=cfg.vocab_size,
            num_answers=cfg.num_answers)
        return Trainer(create_vqa_model(config=cfg, device=cuda, seed=5), *loaders,
                       config=TrainingConfig(warmup_epochs=0, num_epochs=3),
                       checkpoint_dir=str(tmp_path), seed=5)

    graphed = trainer()
    graphed.train_loader.set_epoch(0)
    graphed.train_epoch(0)
    graphed.save("latest", 0)
    graphed.train_loader.set_epoch(1)
    graphed.train_epoch(1)  # moves the moments the resume takes back
    replays = graphed.train_step.calls.replays
    graphed.resume("latest")
    fresh = trainer()
    fresh.resume("latest")
    batch = [t.to(cuda) for t in _train_batch(cfg, 4, 23)]
    losses = [float(t.train_step(t.state, *batch)["loss"]) for t in (graphed, fresh)]
    assert graphed.train_step.calls.replays == replays + 1
    assert fresh.train_step.calls.replays == 0  # its first step runs eagerly
    assert losses[0] == pytest.approx(losses[1], abs=1e-5)
    for a, b in zip(graphed.model.parameters(), fresh.model.parameters()):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
