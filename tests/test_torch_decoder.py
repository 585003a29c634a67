"""The decoder model (``models/decoder.py``, ``models/moe.py``) on the CPU,
at a tiny size: against the benchmark's plain reference
(``benchmark/reference/decoder_vqa.py``), the expert-parallel share, the
routing rule, the published state_dict naming, the engine's routing
counters (eager and through stand-in graphs), the reference model left
as it was by the new ``ModelConfig`` fields, the refusal of any dtype but
bf16 off the CPU, and a loaded model built without its seeded
initialisation.

The tiny size keeps every mechanism of Kimi-VL-A3B's language model:
hidden 64, 4 heads of 16 + 16 query dims (no rope + rope), a kv latent of
32, values of 16, 3 layers (one dense, two MoE), 16 routed experts of
width 32 of which 8 are held, 4 per token, one shared expert.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import decoder_weights, weights
from benchmark.reference.decoder_vqa import DecoderReference, log_probs_in_blocks, param_shapes
from benchmark.reference.prep import Vocabulary
from vqa_tpu_torch.data.preprocess import device_normalize
from vqa_tpu_torch.models.decoder import DecoderVQAModel, rope_tables
from vqa_tpu_torch.models import vqa_model
from vqa_tpu_torch.models.moe import MoE, MoEGate, swiglu
from vqa_tpu_torch.models.vqa_model import VQAModel, count_parameters, create_vqa_model
from vqa_tpu_torch.ops import moe_kernel
from vqa_tpu_torch.ops.mla_kernel import apply_rope, plain_mla_attention
from vqa_tpu_torch.serving import graphs
from vqa_tpu_torch.serving.engine import VQAInference
from vqa_tpu_torch.training import checkpoint as ckpt_lib
from vqa_tpu_torch.utils.config import (DecoderConfig, InferenceConfig, ModelConfig,
                                        model_config_dict, model_config_from_dict)
from vqa_tpu_torch.utils.profiling import spans
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = model_config_dict(DecoderConfig(
    image_size=64, base_channels=8, stage_channels=(8, 16, 32, 64), feature_spatial_size=2,
    se_reduction=4, vocab_size=100, max_question_length=8, num_answers=16,
    answer_hidden_dim=32, decoder_hidden=64, decoder_layers=3,
    decoder_heads=4, decoder_dense_layers=1, decoder_ffn_dim=96, kv_lora_rank=32,
    qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16, moe_intermediate_size=32,
    router_experts=16, num_experts_per_tok=4, n_shared_experts=1, experts_held=8,
    expert_offset=0))


def tiny_model(cfg, state):
    model = create_vqa_model(config=model_config_from_dict(cfg), device="cpu")
    model.load_state_dict(state, strict=True)
    return model


def tiny_inputs(cfg, seed, pairs):
    """Pixels, ids and masks with questions of 1 to L-2 words."""
    rng = np.random.default_rng(seed)
    s, length = cfg["image_size"], cfg["max_question_length"]
    pixels = torch.from_numpy(rng.integers(0, 256, (pairs, s, s, 3), dtype=np.uint8))
    ids = torch.from_numpy(rng.integers(4, cfg["vocab_size"], (pairs, length)))
    mask = torch.zeros(pairs, length, dtype=torch.int64)
    for i, n in enumerate(rng.integers(3, length + 1, pairs)):
        mask[i, :n] = 1
    return pixels, ids * mask, mask


def tiny_deployment(directory, seed, pairs, full=False):
    """A bf16 deployment of the tiny decoder in ``directory`` and ``pairs``
    pairs to ask it (with ``full``, also its state and word table)."""
    state = decoder_weights.make_state(TINY, seed, "cpu")
    vocab = weights.words(TINY["vocab_size"] - len(weights.SPECIALS), seed)
    state = weights.write_deployment(str(directory), TINY, state, vocab)
    rng = np.random.default_rng(seed)
    pixels = rng.integers(0, 256, (pairs, 64, 64, 3), dtype=np.uint8)
    questions = weights.questions(vocab, pairs, 1, 6, seed)
    if full:
        return pixels, questions, state, weights.word_table(vocab)
    return pixels, questions


@pytest.mark.parametrize("offset", [0, 8])
def test_the_f32_port_matches_the_plain_reference(offset):
    """Logits within 1e-4: both compute in f32 from the same weights, with
    sums in other orders (the port's expanded products and fused norms,
    the reference's step-by-step ones) over 3 layers, at logits of ~1;
    a different rounding of a routing score would move a logit by ~1e-1."""
    cfg = dict(TINY, expert_offset=offset)
    state = decoder_weights.make_state(cfg, 2**31 + offset, "cpu", torch.float32)
    model = tiny_model(cfg, state)
    pixels, ids, mask = tiny_inputs(cfg, offset, 6)
    with torch.no_grad():
        got, aux = model(device_normalize(pixels), ids, mask)
        ref = DecoderReference(cfg, state)
        want = ref.logits(pixels, ids, mask)
    assert float((got - want).abs().max()) <= 1e-4
    held = torch.arange(offset, offset + 8)
    assert aux["route_counts"].tolist() == [
        [int((r == e).sum()) for e in held] for r in ref.routes]


@pytest.mark.parametrize("shares", [2, 4])
def test_the_expert_parallel_shares_add_up_to_the_uncut_layer(shares):
    """Each share's layer computes its experts' part plus the shared
    expert; over all shares, with the shared expert counted once, they
    add up to the reference's layer holding all 16 experts."""
    state = decoder_weights.make_state(dict(TINY, experts_held=16), 5, "cpu", torch.float32)
    key = "language_model.model.layers.1.mlp"
    x = torch.randn(40, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        whole = DecoderReference(dict(TINY, experts_held=16), state).moe(x, key)
        parts = []
        for s in range(shares):
            held = 16 // shares
            layer = MoE(64, 32, 16, 4, 1, 2.446, held, s * held).eval()
            prefix = key + "."
            layer.load_state_dict({k[len(prefix):]: v for k, v in state.items()
                                   if k.startswith(prefix) and (".experts." not in k or int(
                                       k[len(prefix):].split(".")[1]) in range(s * held,
                                                                              (s + 1) * held))})
            parts.append(layer(x)[0])
        shared = layer.shared_experts(x)
    total = sum(parts) - (shares - 1) * shared
    assert float((total - whole).abs().max()) <= 1e-5


def test_the_routing_rule_on_a_hand_worked_case():
    """Four experts, two per token. Scores sigmoid(0.2, 0, 1.0, 0.4) =
    (0.5498, 0.5, 0.7311, 0.5987); the bias (0.3, 0.5, -0.4, 0) makes the
    choice scores (0.8498, 1.0, 0.3311, 0.5987), so experts 1 and 0 are
    picked although 2 and 3 score higher; their weights are the unbiased
    scores 0.5 and 0.5498, normalised (0.4763, 0.5237) and scaled by
    2.446 (1.1650, 1.2810)."""
    gate = MoEGate(2, 4, 2, 2.446)
    with torch.no_grad():
        gate.weight.copy_(torch.tensor([[0.2, 0.0], [0.0, 0.0], [1.0, 0.0], [0.4, 0.0]]))
        gate.e_score_correction_bias.copy_(torch.tensor([0.3, 0.5, -0.4, 0.0]))
        idx, w = gate(torch.tensor([[1.0, 7.0]]))
    assert idx.tolist() == [[1, 0]]
    s0, s1 = 1 / (1 + np.exp(-0.2)), 0.5
    assert np.allclose(w.numpy(), [[s1 / (s0 + s1) * 2.446, s0 / (s0 + s1) * 2.446]], atol=1e-6)
    assert np.allclose(w.numpy(), [[1.1650, 1.2810]], atol=1e-4)


def test_the_route_plan_groups_the_held_experts_pairs():
    idx = torch.tensor([[3, 9, 4], [5, 3, 0], [4, 12, 3]], dtype=torch.int32)
    src, ends, slot, counts = moe_kernel.moe_plan(idx, 3, 3)  # experts 3, 4, 5 held
    assert ends.tolist() == [3, 5, 6] and counts.tolist() == [3, 2, 1]
    assert src[:6].tolist() == [0, 1, 2, 0, 2, 1]  # expert 3's tokens, 4's, 5's
    assert src[6:].tolist() == [0, 1, 2]  # the pairs held elsewhere, in (token, choice) order
    assert slot.tolist() == [[0, -1, 3], [5, 1, -1], [4, -1, 2]]
    assert all(int(src[slot[t, j]]) == t for t in range(3) for j in range(3) if slot[t, j] >= 0)
    assert all(t.dtype == torch.int32 for t in (src, ends, slot, counts))


@pytest.mark.parametrize("experts,top_k,held,offset", [
    (64, 6, 8, 0), (64, 6, 8, 56), (64, 6, 64, 0), (16, 4, 8, 8), (48, 8, 5, 40)])
def test_the_plain_route_and_plan_equal_the_gate_and_sort_they_replace(experts, top_k, held,
                                                                       offset):
    """The router's and the plan's plain forms (what the CPU runs, and what
    the card's kernels are held to) against the gate and the stable sort
    written out here: the same f32 logits, sigmoid, biased top-k and
    normalised weights; each held expert's tokens in token order, then the
    pairs held elsewhere, from numpy's stable argsort."""
    g = torch.Generator().manual_seed(experts + held + offset)
    x = torch.randn(300, 128, generator=g).bfloat16()
    weight = torch.randn(experts, 128, generator=g) * 128 ** -0.5
    bias = 0.1 * torch.randn(experts, generator=g)
    idx, w = moe_kernel.moe_route(x, weight, bias, top_k, 2.446)
    scores = torch.sigmoid(x.float() @ weight.T)
    want_idx = torch.topk(scores + bias, top_k, dim=-1).indices
    chosen = scores.gather(1, want_idx)
    assert idx.dtype == torch.int32 and torch.equal(idx.long(), want_idx)
    assert torch.equal(w, chosen / (chosen.sum(-1, keepdim=True) + 1e-20) * 2.446)

    src, ends, slot, counts = moe_kernel.moe_plan(idx, offset, held)
    flat = idx.reshape(-1).numpy() - offset
    key = np.where((flat >= 0) & (flat < held), flat, held)
    order = np.argsort(key, kind="stable")
    assert src.tolist() == (order // top_k).tolist()
    assert counts.tolist() == [int((key == e).sum()) for e in range(held)]
    assert ends.tolist() == np.cumsum(counts.numpy()).tolist()
    rows = np.empty_like(order)
    rows[order] = np.arange(order.size)
    assert slot.reshape(-1).tolist() == np.where(key < held, rows, -1).tolist()


def merge_planes(planes: torch.Tensor) -> torch.Tensor:
    """The f32 weight that ``moe_kernel.weight_planes`` split."""
    p = planes.float()
    return p[0] + (p[1] + p[2]) / moe_kernel.PLANE_SCALE


def untile(tiles: torch.Tensor, experts: int, width: int) -> torch.Tensor:
    """``moe_kernel.route_tiles``'s planes back as [3, N, D]."""
    stages, _, steps, groups, _, _, _ = tiles.shape
    planes = tiles.permute(1, 3, 5, 0, 2, 4, 6).reshape(3, groups * 8, stages * steps * 16)
    return planes[:, :experts, :width]


@pytest.mark.parametrize("exponent", range(-120, 121, 10))
def test_the_routers_weight_planes_sum_back_to_it_exactly(exponent):
    """Each plane holds bf16 values, and hi + (mid + lo) / 2^12 is the f32
    weight bit for bit, over normal exponents from 2^-120 to 2^120 (every
    f32 significand, both signs)."""
    g = torch.Generator().manual_seed(exponent + 1000)
    significand = 1.0 + torch.rand(4096, generator=g, dtype=torch.float64)
    sign = torch.where(torch.rand(4096, generator=g) < 0.5, -1.0, 1.0).double()
    weight = (sign * significand * 2.0 ** exponent).float().reshape(64, 64)
    planes = moe_kernel.weight_planes(weight)
    assert planes.shape == (3, 64, 64) and planes.dtype == torch.float32
    assert torch.equal(planes.bfloat16().float(), planes)
    assert torch.equal(merge_planes(planes.bfloat16()), weight)
    assert torch.equal(merge_planes(planes), weight)


@pytest.mark.parametrize("experts,width", [(16, 64), (64, 2048), (48, 100)])
def test_the_router_keeps_its_planes_as_a_compute_copy(experts, width):
    """In bf16 the gate holds its weight's planes as a bf16 compute copy in
    the kernel's stage layout (every value in its place, the padding
    zero), refreshed in place when the weight changes; the state_dict
    keeps the published keys only."""
    gate = MoEGate(width, experts, 4, 2.446).eval()
    with torch.no_grad():
        gate.weight.normal_(0.0, 0.125)
    gate.set_compute_dtype(torch.bfloat16)
    tiles = gate.compute("tiles")
    padded, stages = -(-experts // 64) * 64, -(-width // 64)
    assert tiles.dtype == torch.bfloat16 and tiles.shape == (stages, 3, 4, padded // 8, 2, 8, 8)
    planes = moe_kernel.weight_planes(gate.weight.detach())
    assert torch.equal(untile(tiles, experts, width).float(), planes)
    whole = untile(tiles, padded, 64 * stages).float()  # the padding is 0
    assert torch.equal(whole, F.pad(planes, (0, 64 * stages - width, 0, padded - experts)))
    e, c = experts - 1, width - 1  # plane 2's last value, by hand
    assert tiles[c // 64, 2, c % 64 // 16, e // 8, c % 16 // 8, e % 8, c % 8] == planes[2, e, c]
    with torch.no_grad():
        gate.weight.mul_(3.0)
    gate.set_compute_dtype(torch.bfloat16)
    assert torch.equal(merge_planes(
        untile(gate.compute("tiles"), experts, width)), gate.weight.detach())
    assert sorted(gate.state_dict()) == ["e_score_correction_bias", "weight"]


def test_the_grouped_path_matches_the_loop_on_the_cpu():
    """The card's routed path (plan, permute, grouped products, SwiGLU,
    combine), run here through the kernels' plain versions, against the
    plain loop over the held experts."""
    torch.manual_seed(0)
    layer = MoE(64, 32, 16, 4, 1, 2.446, 8, 4).eval()
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, 0.2)
        x = torch.randn(50, 64)
        idx, w = layer.gate(x)
        shared = layer.shared_experts(x)
        got, counts = layer._grouped(x, idx, w, shared)
        want, want_counts = layer._loop(x, idx, w, shared)
    assert torch.equal(counts, want_counts) and int(counts.sum()) > 0
    assert float((got - want).abs().max()) <= 1e-5


def test_the_moe_kernels_plain_versions_touch_only_routed_rows():
    x = torch.arange(12.0).reshape(4, 3)
    total = torch.tensor([2], dtype=torch.int32)
    got = moe_kernel.plain_moe_gather(x, torch.tensor([3, 1, 0], dtype=torch.int32), total)
    assert got.tolist() == [[9.0, 10.0, 11.0], [3.0, 4.0, 5.0], [0.0, 0.0, 0.0]]
    h = torch.tensor([[1.0, -2.0, 3.0, 4.0], [5.0, 6.0, 7.0, 8.0]])
    got = moe_kernel.plain_swiglu(h, torch.tensor([1], dtype=torch.int32))
    assert np.allclose(got[0].numpy(), [1 / (1 + np.exp(-1.0)) * 3.0,
                                        -2 / (1 + np.exp(2.0)) * 4.0])
    assert got[1].tolist() == [0.0, 0.0]
    assert torch.equal(moe_kernel.plain_swiglu(h)[0], got[0])  # every row without a total
    assert moe_kernel.plain_swiglu(h)[1].tolist() != [0.0, 0.0]
    y = torch.tensor([[1.0, 2.0], [10.0, 20.0]])
    got = moe_kernel.plain_moe_combine(y, torch.tensor([[1, -1], [-1, -1]], dtype=torch.int32),
                                       torch.tensor([[0.5, 9.0], [1.0, 1.0]]),
                                       torch.ones(2, 2))
    assert got.tolist() == [[6.0, 11.0], [1.0, 1.0]]


@pytest.mark.parametrize("what", ["moe", "swiglu"])
def test_off_the_cpu_the_moe_layer_and_swiglu_take_bf16_only(what):
    """Off the CPU the layer has only its bf16 path (the grouped GEMMs and
    the kernels): another dtype is refused before any work, never run
    through the plain loop. A tensor on the meta device stands for one on
    the card."""
    if what == "moe":
        layer, x = MoE(64, 32, 16, 4, 1, 2.446, 8, 0).eval(), torch.empty(5, 64, device="meta")
    else:
        layer, x = swiglu, torch.empty(5, 64, device="meta")
    with pytest.raises(ValueError, match="bfloat16 only, got torch.float32"):
        layer(x)


def test_rope_follows_deepseek_v3s_interleaved_layout():
    """Pair (2i, 2i+1) of the input is rotated by position x theta^(-2i/d)
    and lands at (i, i + d/2) of the output."""
    d, theta = 8, 800000.0
    cos, sin = rope_tables(3, d, theta)
    x = torch.randn(1, 3, 1, d, dtype=torch.float64).float()
    got = apply_rope(x, cos, sin)
    for p in range(3):
        for i in range(d // 2):
            a = p * theta ** (-2 * i / d)
            x0, x1 = float(x[0, p, 0, 2 * i]), float(x[0, p, 0, 2 * i + 1])
            assert np.isclose(float(got[0, p, 0, i]), x0 * np.cos(a) - x1 * np.sin(a), atol=1e-5)
            assert np.isclose(float(got[0, p, 0, i + d // 2]), x1 * np.cos(a) + x0 * np.sin(a),
                              atol=1e-5)


def head_major_core(q, kv, k_pe, cos, sin, keys, heads):
    """The attention core as ``MLA.forward`` computed it before the
    kernel: q, k and v assembled head-major in zeroed buffers of
    P = L rounded up to 8 rows, a materialised [B·h, P, P] bias of 0 and
    -1e9 added by ``baddbmm``, softmax in f32, ``bmm``, the context copied
    back to token-major."""
    b, length, _ = q.shape
    rope = k_pe.shape[-1]
    nope = q.shape[-1] // heads - rope
    dv = kv.shape[-1] // heads - nope
    p = -(-length // 8) * 8
    pos = torch.arange(p, device=keys.device)
    real = torch.nn.functional.pad(keys, (0, p - length)) != 0
    keep = (pos[None, :] <= pos[:, None])[None] & real[:, None, :]
    bias = torch.where(keep, 0.0, -1e9).to(q.dtype)
    bias = bias[:, None].expand(b, heads, p, p).reshape(b * heads, p, p)
    q_nope, q_pe = q.view(b, length, heads, nope + rope).split([nope, rope], -1)
    k_nope, v = kv.view(b, length, heads, nope + dv).split([nope, dv], -1)
    qh, kh, vh = (q.new_zeros(b, heads, p, w) for w in (nope + rope, nope + rope, dv))
    qh[:, :, :length, :nope] = q_nope.transpose(1, 2)
    qh[:, :, :length, nope:] = apply_rope(q_pe, cos, sin).transpose(1, 2)
    kh[:, :, :length, :nope] = k_nope.transpose(1, 2)
    kh[:, :, :length, nope:] = apply_rope(k_pe.reshape(b, length, 1, rope), cos,
                                          sin).transpose(1, 2)
    vh[:, :, :length] = v.transpose(1, 2)
    qh, kh, vh = (t.view(b * heads, p, -1) for t in (qh, kh, vh))
    scores = torch.baddbmm(bias, qh, kh.transpose(1, 2), alpha=(nope + rope) ** -0.5)
    probs = torch.softmax(scores, dim=-1, dtype=torch.float32).to(q.dtype)
    ctx = torch.bmm(probs, vh).view(b, heads, p, dv)[:, :, :length]
    return ctx.transpose(1, 2).reshape(b, length, heads * dv)


@pytest.mark.parametrize("heads,nope,rope,dv,image,question", [
    (4, 16, 16, 16, 4, 8),       # the tiny decoder's
    (16, 128, 64, 128, 49, 20),  # Kimi-VL-A3B's head dims, L = 69
    (3, 8, 8, 24, 5, 6),         # widths the kernel does not take
])
def test_the_plain_core_matches_the_head_major_one_in_f32(heads, nope, rope, dv, image,
                                                          question):
    """``plain_mla_attention`` on the projections' token-major outputs
    against the head-major core it replaced, in f32, with questions padded
    to several lengths (the image tokens always real) and causal masking.
    Both take the same products and the same softmax; they differ in the
    order of the score sums and in how a masked score is dropped (-1e9
    added, or -inf), so within 1e-5 at values of ~1 (an f32 ulp there is
    1.2e-7; a mask or rope error moves an output by ~1e-1)."""
    rng = np.random.default_rng(heads * 1000 + nope)
    b, length = 5, image + question
    q = torch.from_numpy(rng.standard_normal((b, length, heads * (nope + rope)), np.float32))
    kv = torch.from_numpy(rng.standard_normal((b, length, heads * (nope + dv)), np.float32))
    kv_a = torch.from_numpy(rng.standard_normal((b, length, 32 + rope), np.float32))
    k_pe = kv_a[..., 32:]  # the strided view the model passes
    keys = torch.ones(b, length, dtype=torch.int32)
    for i, n in enumerate([question, 1, question // 2, 3, question - 1]):
        keys[i, image + n:] = 0
    cos, sin = rope_tables(length, rope, 800000.0)
    got = plain_mla_attention(q, kv, k_pe, cos, sin, keys, heads)
    want = head_major_core(q, kv, k_pe, cos, sin, keys, heads)
    assert got.shape == (b, length, heads * dv)
    assert float((got - want).abs().max()) <= 1e-5
    # the mask is live: a padded key's value changes nothing, a real one's does
    kv2 = kv.clone().view(b, length, heads, nope + dv)
    kv2[1, -1, :, nope:] += 100.0  # pair 1's last key is padding
    same = plain_mla_attention(q, kv2.view_as(kv), k_pe, cos, sin, keys, heads)
    assert torch.equal(same, got)
    kv2[0, image, :, nope:] += 100.0  # pair 0's first question token is real
    moved = plain_mla_attention(q, kv2.view_as(kv), k_pe, cos, sin, keys, heads)
    assert torch.equal(moved[0, :image], got[0, :image])  # causal: earlier rows unmoved
    assert float((moved[0, image:] - got[0, image:]).abs().min()) > 1e-3


def test_the_state_dict_keys_follow_the_published_checkpoint():
    model = DecoderVQAModel(model_config_from_dict(dict(TINY, expert_offset=8)))
    keys = set(model.state_dict())
    lm = "language_model.model"
    for k in (f"{lm}.embed_tokens.weight", f"{lm}.norm.weight",
              f"{lm}.layers.0.self_attn.q_proj.weight",
              f"{lm}.layers.0.self_attn.kv_a_proj_with_mqa.weight",
              f"{lm}.layers.0.self_attn.kv_a_layernorm.weight",
              f"{lm}.layers.0.self_attn.kv_b_proj.weight", f"{lm}.layers.0.self_attn.o_proj.weight",
              f"{lm}.layers.0.mlp.gate_proj.weight", f"{lm}.layers.0.mlp.down_proj.weight",
              f"{lm}.layers.2.mlp.gate.weight", f"{lm}.layers.2.mlp.gate.e_score_correction_bias",
              f"{lm}.layers.2.mlp.experts.8.gate_proj.weight",
              f"{lm}.layers.2.mlp.experts.15.down_proj.weight",
              f"{lm}.layers.2.mlp.shared_experts.up_proj.weight",
              f"{lm}.layers.1.input_layernorm.weight",
              f"{lm}.layers.1.post_attention_layernorm.weight",
              "multi_modal_projector.pre_norm.weight", "multi_modal_projector.linear_1.weight",
              "multi_modal_projector.linear_2.bias", "image_encoder.stem.0.weight",
              "answer_head.classifier.6.bias"):
        assert k in keys, k
    assert not [k for k in keys if ".experts.7." in k or ".experts.16." in k]
    assert model.state_dict()[f"{lm}.layers.2.mlp.gate.weight"].shape == (16, 64)
    assert keys == set(param_shapes(dict(TINY, expert_offset=8)))


def test_the_reference_model_is_unchanged_by_the_decoder_config():
    cfg = ModelConfig()
    assert not hasattr(cfg, "fusion")
    model = create_vqa_model(config=cfg, device="cpu")
    assert type(model) is VQAModel
    assert count_parameters(model)["total"] == 19_310_316
    assert list(count_parameters(model)) == ["image_encoder", "text_encoder", "fusion",
                                             "answer_head", "total"]
    assert not [k for k in model.state_dict() if k.startswith(("language_model",
                                                               "multi_modal_projector"))]
    assert type(model_config_from_dict(model_config_dict(cfg))) is ModelConfig
    dec = DecoderConfig(experts_held=8)
    assert model_config_from_dict(model_config_dict(dec)) == dec
    assert set(model_config_dict(dec)) > set(model_config_dict(cfg))


def test_a_loaded_model_skips_the_seeded_initialisation(monkeypatch, tmp_path):
    """``load_model_for_inference`` builds the model with ``init=False`` and
    loads the whole state over it: the seeded initialisation never runs,
    and the loaded model equals one built, initialised and then loaded."""
    tiny_deployment(tmp_path, seed=5, pairs=1)
    state = torch.load(tmp_path / f"{weights.CHECKPOINT}.pt")["model_state_dict"]
    want = tiny_model(TINY, state)

    def refuse(*_):
        raise AssertionError("the seeded initialisation ran under a loaded state")

    monkeypatch.setattr(vqa_model, "init_parameters", refuse)
    got = ckpt_lib.load_model_for_inference(str(tmp_path), weights.CHECKPOINT, device="cpu")
    assert type(got) is DecoderVQAModel and not got.training
    mine, theirs = got.state_dict(), want.state_dict()
    assert list(mine) == list(theirs) and all(torch.equal(mine[k], theirs[k]) for k in mine)
    assert torch.equal(got.language_model.model.rope_cos,
                       want.language_model.model.rope_cos)


def test_the_engine_records_the_routing_of_each_dispatch(tmp_path):
    pixels, questions, state, word2idx = tiny_deployment(tmp_path, seed=3, pairs=10, full=True)
    engine = VQAInference(checkpoint_dir=str(tmp_path), checkpoint_name=weights.CHECKPOINT,
                          config=InferenceConfig(batch_buckets=(4,), max_batch_size=4),
                          device="cpu").load()
    assert type(engine.model) is DecoderVQAModel
    before = {n: spans(n)[1] for n in ("moe.route", "moe.route_max", "engine.dispatch")}
    probs = engine.predict_probs_from_pixels(pixels, questions)
    assert probs.shape == (10, 16) and np.allclose(probs.sum(1), 1, atol=1e-5)
    routes, most = ([r.value for r in spans(n)[0] if r.seq >= before[n]]
                    for n in ("moe.route", "moe.route_max"))
    assert spans("engine.dispatch")[1] - before["engine.dispatch"] == len(routes) == 3
    # the first dispatch's four pairs through the model directly
    ids, mask = engine.tokenizer.encode_batch_np(questions[:4])
    with torch.no_grad():
        _, aux = engine.model(device_normalize(torch.from_numpy(pixels[:4])),
                              torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert routes[0] == int(aux["route_counts"].sum())
    assert most[0] == int(aux["route_counts"].max())
    # and the reference, from the same bf16 values in f32
    ids, mask = Vocabulary(word2idx, TINY["max_question_length"]).encode_all(questions)
    lp, _ = log_probs_in_blocks(TINY, {k: v.float() if v.is_floating_point() else v
                                       for k, v in state.items()},
                                torch.from_numpy(pixels), torch.from_numpy(ids),
                                torch.from_numpy(mask))
    assert np.abs(np.log(probs) - lp.numpy()).max() <= 1e-4


class TupleStandInGraph:
    """A captured graph's replay whose output is a tuple of tensors: the
    function again, from the static inputs into the static outputs."""

    def __init__(self, fn, inputs, output):
        self.fn, self.inputs, self.output = fn, inputs, output

    def replay(self):
        for static, t in zip(self.output, self.fn(*self.inputs)):
            static.copy_(t)


def test_the_graphed_dispatch_carries_the_routing_counts(monkeypatch, tmp_path):
    """Through stand-in graphs (``tests/test_torch_engine_graphs.py``), the
    slotted graphs' output is (probabilities, counts); each replay copies
    both out, and each dispatch's counters reach the fetch."""
    from test_torch_engine_graphs import StandInEvent, StandInStreams

    def capture(forward, inputs, done=None):
        log = []
        out = {}
        for b, slot in inputs.items():
            captured = []
            for s in [slot, [t.clone() for t in slot]]:
                output = forward(*s)
                captured.append(graphs.BucketGraph(TupleStandInGraph(forward, s, output), s,
                                                   output, {}))
            out[b] = graphs.SlottedGraph(captured, StandInStreams(log),
                                         [StandInEvent(log) for _ in captured],
                                         [StandInEvent(log) for _ in captured])
        return out

    monkeypatch.setattr(graphs, "capture_replica", capture)
    pixels, questions = tiny_deployment(tmp_path, seed=4, pairs=8)
    engine = VQAInference(checkpoint_dir=str(tmp_path), checkpoint_name=weights.CHECKPOINT,
                          config=InferenceConfig(batch_buckets=(4,), max_batch_size=4),
                          device="cpu")
    engine._graphed = True
    engine.load()
    before = spans("moe.route")[1]
    first, _ = engine.dispatch_probs_from_pixels(pixels[:4], questions[:4])
    want, _ = engine._dispatch_eager(pixels[:4], questions[:4])
    assert torch.equal(first, want)
    assert torch.equal(first.route_counts[0], want.route_counts[0])
    got = engine.predict_probs_from_pixels(pixels, questions)
    routes = [r.value for r in spans("moe.route")[0] if r.seq >= before]
    assert len(routes) == 2 and routes[0] == int(want.route_counts[0].sum())
    assert np.allclose(got[:4], first.numpy())


def test_a_model_without_experts_records_no_routing(tmp_path):
    from vqa_tpu_torch.utils.config import tiny_model_config

    engine = VQAInference(model_config=tiny_model_config(), device="cpu",
                          config=InferenceConfig(batch_buckets=(4,)))
    engine.load()
    before = spans("moe.route")[1]
    probs, _ = engine.dispatch_probs_from_pixels(
        np.zeros((3, 64, 64, 3), np.uint8), ["what is this"] * 3)
    assert not hasattr(probs, "route_counts")
    engine.predict_probs_from_pixels(np.zeros((3, 64, 64, 3), np.uint8), ["what"] * 3)
    assert spans("moe.route")[1] == before
