"""The hybrid decoder on the card: the KDA kernel against its plain version
at the benchmark cell's shape and at the tiny decoder's, its refusals, its
launches per forward, and the graphed bf16 forward of the tiny hybrid
against the eager one.

Marked ``cuda``: each test skips (from a fixture) where no CUDA device is
present. On a machine with an NVIDIA GPU and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kda_cuda.py -q

Tolerance: the kernel and ``plain_kda_attention`` read the same bf16
inputs and compute in f32, rounding once to bf16 at the end. They differ in
the order of every sum (the convolution's taps, the norms' squares, Sᵀk
as four partial sums of a quarter of the rows each) and in how the output
is formed (the kernel's o = Sᵀq + u·(kᵀq) before the update's sum, the
plain version's Sᵀq after it): f32 differences of a few ulps of each
step's scale. The delta rule with unit keys and β ≤ 1 and decays ≤ 1 does
not amplify them, so after the output's rounding the two stay within 2
bf16 ulps of the output's largest magnitude (a missed decay, a wrong β or
a convolution off by one position moves outputs by a large share of it).
"""

import numpy as np
import pytest
import torch

from vqa_tpu_torch import ops
from vqa_tpu_torch.ops import kda_kernel
from test_torch_kda import TINY, tiny_deployment
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


def kda_inputs(device, batch, length, heads=32, dk=128, seed=0):
    """The core's inputs as the model hands them over: q, k, v and b views
    of one bf16 product of x (rows of 3·width + 2·dk + heads, padded to a
    multiple of 8), g its own bf16 tensor, the parameters f32 by the
    benchmark's rules; x, the weights and so every projection of the
    scale the model's are."""
    g = torch.Generator(device=device).manual_seed(seed)
    width = heads * dk
    cols = -(-(3 * width + 2 * dk + heads) // 8) * 8
    proj = torch.randn(batch, length, cols, generator=g, device=device).bfloat16()
    q, k, v = (proj[..., i * width:(i + 1) * width] for i in range(3))
    b = proj[..., 3 * width + 2 * dk:3 * width + 2 * dk + heads]
    f = torch.randn(batch, length, width, generator=g, device=device).bfloat16()
    convs = [torch.randn(width, 1, 4, generator=g, device=device) * 0.5 for _ in range(3)]
    a_log = torch.log(1 + 15 * torch.rand(heads, generator=g, device=device))
    dt = torch.exp(np.log(1e-3) + np.log(100) * torch.rand(width, generator=g, device=device))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    return q, k, v, f, b, *convs, a_log, dt_bias, heads


@pytest.mark.parametrize("batch,length,heads,dk", [
    (256, 69, 32, 128),  # the cell's bucket: 17,664 tokens, 8,192 (pair, head) blocks
    (3, 69, 32, 128), (2, 1, 32, 128), (2, 80, 32, 128), (5, 13, 4, 128),
    (4, 12, 4, 16),  # the tiny decoder's
])
def test_the_kda_kernel_matches_its_plain_version(cuda, batch, length, heads, dk):
    args = kda_inputs(cuda, batch, length, heads, dk, seed=batch + length)
    before = ops.launch_counts()["kda_attention"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kda_kernel.kda_attention(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = kda_kernel.plain_kda_attention(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["kda_attention"] - before == 1
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    scale = float(want.float().abs().max())
    assert scale > 0.01
    assert float((got.float() - want.float()).abs().max()) <= 2 * BF16_ULP * scale


def test_the_kernel_keeps_the_pairs_apart(cuda):
    """Pair 1 changed in every input: pairs 0 and 2 give what they gave,
    bit for bit (one block per pair and head, no state between them)."""
    args = list(kda_inputs(cuda, 3, 69, seed=7))
    before = kda_kernel.kda_attention(*args)
    for i in range(5):
        args[i] = args[i].clone()
        args[i][1] = -args[i][1]
    after = kda_kernel.kda_attention(*args)
    assert torch.equal(after[[0, 2]], before[[0, 2]])
    assert not torch.equal(after[1], before[1])


def test_the_kda_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    args = list(kda_inputs(cuda, 2, 12))
    with pytest.raises(ValueError, match="bfloat16"):
        kda_kernel.kda_attention(*[a.float() if i < 5 else a for i, a in enumerate(args)])
    with pytest.raises(ValueError, match="head dim"):
        kda_kernel.kda_attention(*args[:-1], 16)  # 16 heads of 256
    long = list(kda_inputs(cuda, 2, 81, heads=4))
    with pytest.raises(ValueError, match="L must be"):
        kda_kernel.kda_attention(*long)
    bad = list(args)
    bad[0] = args[0][..., 1:].contiguous()[..., :1]  # a narrower q
    with pytest.raises(ValueError, match="q"):
        kda_kernel.kda_attention(*bad)
    bad = list(args)
    bad[8] = args[8].double()
    with pytest.raises(ValueError, match="A_log"):
        kda_kernel.kda_attention(*bad)


def load_engine(tmp_path, seed, cuda):
    from vqa_tpu_torch.serving.engine import VQAInference
    from vqa_tpu_torch.utils.config import InferenceConfig

    pixels, questions, _, _ = tiny_deployment(tmp_path, seed=seed, pairs=4)
    engine = VQAInference(checkpoint_dir=str(tmp_path), checkpoint_name="bench_model",
                          config=InferenceConfig(batch_buckets=(4,), max_batch_size=4),
                          device=cuda, dtype=torch.bfloat16).load()
    return engine, pixels, questions


def test_an_eager_forward_launches_each_attention_kernel_once_its_layer(cuda, tmp_path):
    engine, pixels, questions = load_engine(tmp_path, 21, cuda)
    before = ops.launch_counts()
    engine._dispatch_eager(pixels, questions)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    kda = len(TINY["kda_layers"])
    moe = TINY["decoder_layers"] - TINY["decoder_dense_layers"]
    assert {k: after[k] - before[k] for k in ("kda_attention", "mla_attention", "moe_route")} == {
        "kda_attention": kda, "mla_attention": TINY["decoder_layers"] - kda, "moe_route": moe}


def test_the_graphed_bf16_forward_matches_the_eager_one_at_bucket_4(cuda, tmp_path):
    from vqa_tpu_torch.utils.profiling import spans

    engine, pixels, questions = load_engine(tmp_path, 22, cuda)
    assert sorted(engine._graphs) == [4]
    before, launches = spans("moe.route")[1], ops.launch_counts()["kda_attention"]
    got = engine.predict_probs_from_pixels(pixels, questions)
    # one replay: the launches its capture recorded, one KDA core per KDA layer
    assert ops.launch_counts()["kda_attention"] - launches == len(TINY["kda_layers"])
    want, _ = engine._dispatch_eager(pixels, questions)
    assert np.abs(got - want.cpu().numpy()).max() <= 1e-6
    assert len([r for r in spans("moe.route")[0] if r.seq >= before]) == 1
