"""The decoder model on the card: the attention kernel, the router's
kernels and the MoE kernels against their plain versions, the grouped
routed path against the plain loop, the graphed bf16 forward against the
eager one, the kernels' launches per forward, and the routing counters.

Marked ``cuda``: each test skips (from a fixture) where no CUDA device is
present. On a machine with an NVIDIA GPU and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_decoder_cuda.py -q

Tolerances: the kernels compute in f32 and round once, as their plain
versions do, so the gather is exact and the SwiGLU and the combine are
held within one bf16 ulp. The grouped path and the loop round the same
products in bf16 but sum the GEMMs' products in other orders, so they are
held to a few bf16 ulps of the output's scale. The router's kernel sums
the f32 logits' exact products in another order than cuBLAS's f32 GEMM,
so logits and weights are held within 1e-5, and its choices and the plan
equal the f32 path's wherever no two of a token's top k + 1 biased scores
lie within 1e-5; the plan kernel equals the plain plan of the same
choices bit for bit. The attention kernel sums its scores in another
order than the plain version's f32 product, so a
probability now and then rounds to the neighbouring bf16 value; with the
context's own rounding that keeps it within 2 bf16 ulps of the output's
scale.
"""

import numpy as np
import pytest
import torch

from vqa_tpu_torch import ops
from vqa_tpu_torch.models.decoder import rope_tables
from vqa_tpu_torch.models.moe import MoE
from vqa_tpu_torch.ops import mla_kernel, moe_kernel
from test_torch_decoder import TINY, tiny_deployment
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.cuda

BF16_ULP = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ulps(got, want):
    """|got - want| in bf16 ulps of want's magnitude (at least that of 1e-3)."""
    if not want.numel():
        return 0.0
    scale = want.float().abs().clamp(min=1e-3)
    return float(((got.float() - want.float()).abs() / (scale * BF16_ULP)).max())


@pytest.mark.parametrize("rows,total,width", [(96, 40, 2048), (96, 0, 64), (96, 96, 1408),
                                              (7, 3, 8)])
def test_moe_kernels_match_their_plain_versions(cuda, rows, total, width):
    g = torch.Generator(device=cuda).manual_seed(rows + total)
    tokens, k = 16, 6
    x = torch.randn(tokens, width, generator=g, device=cuda).bfloat16()
    src = torch.randint(0, tokens, (rows,), generator=g, device=cuda, dtype=torch.int32)
    n = torch.tensor([total], dtype=torch.int32, device=cuda)
    before = ops.launch_counts()
    got = moe_kernel.moe_gather(x, src, n)
    assert torch.equal(got[:total], moe_kernel.plain_moe_gather(x, src, n)[:total])
    h = torch.randn(rows, 2 * width, generator=g, device=cuda).bfloat16()
    got = moe_kernel.fused_swiglu(h, n)
    assert _ulps(got[:total], moe_kernel.plain_swiglu(h, n)[:total]) <= 1.0
    assert _ulps(moe_kernel.fused_swiglu(h), moe_kernel.plain_swiglu(h)) <= 1.0
    y = torch.randn(rows, width, generator=g, device=cuda).bfloat16()
    slot = torch.randint(-1, rows, (tokens, k), generator=g, device=cuda, dtype=torch.int32)
    w = torch.rand(tokens, k, generator=g, device=cuda)
    shared = torch.randn(tokens, width, generator=g, device=cuda).bfloat16()
    got = moe_kernel.moe_combine(y, slot, w, shared)
    assert _ulps(got, moe_kernel.plain_moe_combine(y, slot, w, shared)) <= 1.0
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in ("moe_gather", "swiglu", "moe_combine")} == {
        "moe_gather": 1, "swiglu": 2, "moe_combine": 1}


def mla_inputs(device, batch, heads=16, dims=(128, 64, 128), image=49, question=20, seed=0):
    """bf16 projections' outputs as the model hands them over (k_pe a view
    of kv_a_proj_with_mqa's [B, L, 512 + rope]), the rope tables, and keys
    with the image tokens real and questions of 1 to ``question`` tokens."""
    nope, rope, dv = dims
    g = torch.Generator(device=device).manual_seed(seed)
    length = image + question
    q = torch.randn(batch, length, heads * (nope + rope), generator=g, device=device).bfloat16()
    kv = torch.randn(batch, length, heads * (nope + dv), generator=g, device=device).bfloat16()
    kv_a = torch.randn(batch, length, 512 + rope, generator=g, device=device).bfloat16()
    keys = torch.ones(batch, length, dtype=torch.int32, device=device)
    lengths = torch.randint(1, question + 1, (batch,), generator=g, device=device)
    keys[:, image:] = (torch.arange(question, device=device)[None] < lengths[:, None]).int()
    cos, sin = (t.to(device) for t in rope_tables(length, rope, 800000.0))
    return q, kv, kv_a[..., 512:], cos, sin, keys, heads


@pytest.mark.parametrize("batch,dims,image,question", [
    (1, (128, 64, 128), 49, 20), (4, (128, 64, 128), 49, 20), (256, (128, 64, 128), 49, 20),
    (4, (128, 64, 128), 3, 10),  # one warp's rows (L = 13)
    (4, (16, 16, 16), 4, 8),     # the tiny decoder's
])
def test_the_mla_kernel_matches_its_plain_version(cuda, batch, dims, image, question):
    args = mla_inputs(cuda, batch, dims=dims, image=image, question=question, seed=batch)
    before = ops.launch_counts()["mla_attention"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = mla_kernel.mla_attention(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = mla_kernel.plain_mla_attention(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mla_attention"] - before == 1
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= 2 * BF16_ULP * scale


def test_the_mla_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, kv, k_pe, cos, sin, keys, heads = mla_inputs(cuda, 2)
    with pytest.raises(ValueError, match="bfloat16"):
        mla_kernel.mla_attention(q.float(), kv.float(), k_pe.float(), cos, sin, keys, heads)
    with pytest.raises(ValueError, match="head dims"):  # 8 heads of twice the width
        mla_kernel.mla_attention(q, kv, k_pe, cos, sin, keys, 8)
    long = mla_inputs(cuda, 2, question=40)  # L = 89
    with pytest.raises(ValueError, match="L must be"):
        mla_kernel.mla_attention(*long)
    with pytest.raises(ValueError, match="int32"):
        mla_kernel.mla_attention(q, kv, k_pe, cos, sin, keys.long(), heads)


def router_inputs(device, tokens, width, experts, seed):
    """bf16 rows as an RMSNorm hands them over, an f32 router weight of
    N(0, 1/width) and a correction bias of 0.1 N(0, 1), as the benchmark
    draws them."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(tokens, width, generator=g, device=device).bfloat16()
    weight = torch.randn(experts, width, generator=g, device=device) * width ** -0.5
    bias = 0.1 * torch.randn(experts, generator=g, device=device)
    return x, weight, bias


@pytest.mark.parametrize("tokens,width,experts,top_k,held,offset", [
    (48, 64, 16, 4, 8, 0), (48, 64, 16, 4, 8, 8),  # the tiny decoder's
    (17664, 2048, 64, 6, 8, 0), (17664, 2048, 64, 6, 8, 56),  # the cell's bucket 256
    (1000, 2048, 64, 6, 64, 0),  # every expert held
    (777, 256, 48, 8, 5, 40), (300, 128, 256, 8, 256, 0),  # odd 16s; the most
])
def test_the_router_kernels_match_the_f32_path(cuda, tokens, width, experts, top_k, held,
                                               offset):
    x, weight, bias = router_inputs(cuda, tokens, width, experts, tokens + experts + offset)
    tiles = moe_kernel.route_tiles(weight).bfloat16()
    logits = torch.empty(tokens, experts, device=cuda)
    before = ops.launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx, w = moe_kernel.moe_route(x, weight, bias, top_k, 2.446, tiles, logits)
        src, ends, slot, counts = moe_kernel.moe_plan(idx, offset, held)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["moe_route"] - before["moe_route"] == 1
    assert after["moe_plan"] - before["moe_plan"] == 1
    # the plan kernel: the plain plan of the same choices, bit for bit
    for got, want in zip((src, ends, slot, counts), moe_kernel.plain_moe_plan(idx, offset, held)):
        assert got.dtype == torch.int32 and torch.equal(got, want)

    # the f32 path: cuBLAS's f32 GEMM, sigmoid, top-k, the stable sort
    want_logits = x.float() @ weight.T
    assert float((logits - want_logits).abs().max()) <= 1e-5
    want_idx, want_w = moe_kernel.plain_moe_route(x, weight, bias, top_k, 2.446)
    biased = (torch.sigmoid(want_logits) + bias).sort(-1, descending=True).values
    clear = (biased[:, :top_k] - biased[:, 1:top_k + 1] > 1e-5).all(-1)
    assert float(clear.float().mean()) > 0.9
    assert torch.equal(idx[clear], want_idx[clear])
    assert float((w[clear] - want_w[clear]).abs().max()) <= 1e-5
    for got, want in zip(moe_kernel.moe_plan(idx[clear].contiguous(), offset, held),
                         moe_kernel.plain_moe_plan(want_idx[clear], offset, held)):
        assert torch.equal(got, want)


def test_the_router_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    x, weight, bias = router_inputs(cuda, 64, 256, 64, 0)
    with pytest.raises(ValueError, match="multiple of 16 up to 256, got 40"):
        moe_kernel.moe_route(x, weight[:40], bias[:40], 6, 2.446)
    with pytest.raises(ValueError, match="got 512"):
        moe_kernel.moe_route(x, torch.randn(512, 256, device=cuda), torch.zeros(512, device=cuda),
                             6, 2.446)
    with pytest.raises(ValueError, match="k must be 1 to 8, got 9"):
        moe_kernel.moe_route(x, weight, bias, 9, 2.446)
    with pytest.raises(ValueError, match="bfloat16"):
        moe_kernel.moe_route(x.float(), weight, bias, 6, 2.446)
    with pytest.raises(ValueError, match="contiguous"):
        moe_kernel.moe_route(torch.cat([x, x], 1)[:, :256], weight, bias, 6, 2.446)
    with pytest.raises(ValueError, match="tiles"):
        moe_kernel.moe_route(x, weight, bias, 6, 2.446, moe_kernel.route_tiles(weight))
    with pytest.raises(ValueError, match="int32"):
        moe_kernel.moe_plan(torch.zeros(4, 6, dtype=torch.int64, device=cuda), 0, 8)


@pytest.mark.parametrize("held,offset", [(8, 0), (8, 56), (64, 0)])
def test_the_grouped_path_matches_the_loop_without_a_sync(cuda, held, offset):
    """Kimi-VL's widths, 8 or all 64 experts held; the grouped path runs
    with torch's sync debugging set to raise on any synchronising call."""
    torch.manual_seed(0)
    layer = MoE(2048, 1408, 64, 6, 2, 2.446, held, offset).to(cuda).eval()
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, p.shape[-1] ** -0.5 if p.dim() == 2 else 0.1)
    for m in layer.modules():
        if hasattr(m, "set_compute_dtype"):
            m.set_compute_dtype(torch.bfloat16)
    x = torch.randn(1024, 2048, device=cuda).bfloat16()
    with torch.inference_mode():
        idx, w = layer.gate(x)
        shared = layer.shared_experts(x)
        want, counts_loop = layer._loop(x, idx, w, shared)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, counts = layer._grouped(x, idx, w, shared)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(counts, counts_loop)
    assert int(counts.sum()) == int(((idx >= offset) & (idx < offset + held)).sum())
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= 8 * BF16_ULP * scale


def test_the_graphed_bf16_forward_matches_the_eager_one_at_bucket_4(cuda, tmp_path):
    from vqa_tpu_torch.serving.engine import VQAInference
    from vqa_tpu_torch.utils.config import InferenceConfig
    from vqa_tpu_torch.utils.profiling import spans

    pixels, questions = tiny_deployment(tmp_path, seed=11, pairs=4)
    engine = VQAInference(checkpoint_dir=str(tmp_path), checkpoint_name="bench_model",
                          config=InferenceConfig(batch_buckets=(4,), max_batch_size=4),
                          device=cuda, dtype=torch.bfloat16).load()
    assert sorted(engine._graphs) == [4]
    before, launches = spans("moe.route")[1], ops.launch_counts()["moe_gather"]
    got = engine.predict_probs_from_pixels(pixels, questions)
    # one replay: the launches its capture recorded, one gather per MoE layer
    moe_layers = TINY["decoder_layers"] - TINY["decoder_dense_layers"]
    assert ops.launch_counts()["moe_gather"] - launches == moe_layers
    want, _ = engine._dispatch_eager(pixels, questions)
    assert np.abs(got - want.cpu().numpy()).max() <= 1e-6
    assert len([r for r in spans("moe.route")[0] if r.seq >= before]) == 1


def test_an_eager_forward_launches_the_attention_kernel_once_a_layer(cuda, tmp_path):
    from vqa_tpu_torch.serving.engine import VQAInference
    from vqa_tpu_torch.utils.config import InferenceConfig

    pixels, questions = tiny_deployment(tmp_path, seed=13, pairs=4)
    engine = VQAInference(checkpoint_dir=str(tmp_path), checkpoint_name="bench_model",
                          config=InferenceConfig(batch_buckets=(4,), max_batch_size=4),
                          device=cuda, dtype=torch.bfloat16).load()
    before = ops.launch_counts()["mla_attention"]
    engine._dispatch_eager(pixels, questions)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mla_attention"] - before == TINY["decoder_layers"]


def test_an_eager_forward_launches_the_router_kernels_once_a_moe_layer(cuda, tmp_path):
    from vqa_tpu_torch.serving.engine import VQAInference
    from vqa_tpu_torch.utils.config import InferenceConfig

    pixels, questions = tiny_deployment(tmp_path, seed=14, pairs=4)
    engine = VQAInference(checkpoint_dir=str(tmp_path), checkpoint_name="bench_model",
                          config=InferenceConfig(batch_buckets=(4,), max_batch_size=4),
                          device=cuda, dtype=torch.bfloat16).load()
    before = ops.launch_counts()
    engine._dispatch_eager(pixels, questions)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    moe_layers = TINY["decoder_layers"] - TINY["decoder_dense_layers"]
    assert {k: after[k] - before[k] for k in ("moe_route", "moe_plan", "moe_gather")} == {
        "moe_route": moe_layers, "moe_plan": moe_layers, "moe_gather": moe_layers}


def test_the_routing_counters_match_the_references_counts(cuda, tmp_path):
    """The graph's counters against the rows the reference routes to the
    held experts, in f32 from the same bf16 values: equal up to the
    tokens whose choice flips between the two precisions."""
    from benchmark.reference.decoder_vqa import held_experts, log_probs_in_blocks
    from benchmark.reference.prep import Vocabulary
    from vqa_tpu_torch.serving.engine import VQAInference
    from vqa_tpu_torch.utils.config import InferenceConfig
    from vqa_tpu_torch.utils.profiling import spans

    pixels, questions, state, word2idx = tiny_deployment(tmp_path, seed=12, pairs=4, full=True)
    engine = VQAInference(checkpoint_dir=str(tmp_path), checkpoint_name="bench_model",
                          config=InferenceConfig(batch_buckets=(4,), max_batch_size=4),
                          device=cuda, dtype=torch.bfloat16).load()
    before = spans("moe.route")[1]
    engine.predict_probs_from_pixels(pixels, questions)
    (route,) = [r.value for r in spans("moe.route")[0] if r.seq >= before]
    ids, mask = Vocabulary(word2idx, TINY["max_question_length"]).encode_all(questions)
    state = {k: v.to(cuda).float() if v.is_floating_point() else v.to(cuda)
             for k, v in state.items()}
    _, routes = log_probs_in_blocks(TINY, state, torch.from_numpy(pixels).to(cuda),
                                    torch.from_numpy(ids).to(cuda),
                                    torch.from_numpy(mask).to(cuda))
    held = torch.tensor(list(held_experts(TINY)))
    want = int((routes[..., None] == held).sum())
    assert abs(route - want) <= 0.02 * want
