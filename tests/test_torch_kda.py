"""The hybrid decoder (``models/decoder.py:KDA`` beside ``MLA``,
``ops/kda_kernel.py``) on the CPU, at a tiny size: against the benchmark's
plain reference (``benchmark/reference/kimi_linear_vqa.py``), the delta
rule on hand-worked cases, causality and the independence of the pairs,
MLA without rotation through identity tables, the expert-parallel shares at
Kimi-Linear's style of routing, the engine end to end, and Kimi-VL's
configuration left as it was.

The tiny size keeps one whole period of Kimi-Linear's layer pattern: hidden
64, 4 layers (layer 0 dense, layers 0-2 KDA with 4 heads of 16, layer 3 MLA
with 4 heads of 16 + 16 query dims and no rotation), 16 routed experts of
width 32 of which 8 are held, 4 per token, one shared expert.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import kimi_linear_weights, weights
from benchmark.reference.decoder_vqa import param_shapes as decoder_shapes
from benchmark.reference.kimi_linear_vqa import (KimiLinearReference, log_probs_in_blocks,
                                                 param_shapes)
from benchmark.reference.prep import Vocabulary
from vqa_tpu_torch.data.preprocess import device_normalize
from vqa_tpu_torch.models.decoder import KDA, MLA, DecoderVQAModel, rope_tables
from vqa_tpu_torch.models.moe import MoE
from vqa_tpu_torch.models.vqa_model import create_vqa_model
from vqa_tpu_torch.ops.kda_kernel import delta_rule, kda_attention, plain_kda_attention
from vqa_tpu_torch.ops.mla_kernel import plain_mla_attention
from vqa_tpu_torch.serving.engine import VQAInference
from vqa_tpu_torch.utils.config import (DecoderConfig, InferenceConfig, model_config_dict,
                                        model_config_from_dict)
from vqa_tpu_torch.utils.profiling import spans
from test_torch_decoder import TINY as TINY_VL
from test_torch_decoder import tiny_inputs
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = model_config_dict(DecoderConfig(
    image_size=64, base_channels=8, stage_channels=(8, 16, 32, 64), feature_spatial_size=2,
    se_reduction=4, vocab_size=100, max_question_length=8, num_answers=16,
    answer_hidden_dim=32, decoder_hidden=64, decoder_layers=4,
    decoder_heads=4, decoder_dense_layers=1, decoder_ffn_dim=96, kv_lora_rank=32,
    qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16, moe_intermediate_size=32,
    router_experts=16, num_experts_per_tok=4, n_shared_experts=1, experts_held=8,
    expert_offset=0, kda_layers=(0, 1, 2), kda_heads=4, kda_head_dim=16,
    short_conv_kernel_size=4, mla_use_nope=True))
LM = "language_model.model"


def tiny_model(cfg, state):
    model = create_vqa_model(config=model_config_from_dict(cfg), device="cpu")
    model.load_state_dict(state, strict=True)
    return model


def tiny_deployment(directory, seed, pairs):
    """A bf16 deployment of the tiny hybrid in ``directory``: its pixels,
    questions, state and word table."""
    state = kimi_linear_weights.make_state(TINY, seed, "cpu")
    vocab = weights.words(TINY["vocab_size"] - len(weights.SPECIALS), seed)
    state = weights.write_deployment(str(directory), TINY, state, vocab)
    rng = np.random.default_rng(seed)
    pixels = rng.integers(0, 256, (pairs, 64, 64, 3), dtype=np.uint8)
    return pixels, weights.questions(vocab, pairs, 1, 6, seed), state, weights.word_table(vocab)


@pytest.mark.parametrize("offset", [0, 8])
def test_the_f32_port_matches_the_plain_reference(offset):
    """Logits within 1e-4: both compute in f32 from the same weights, with
    sums in other orders (the port's fused products, F.conv1d and einsum,
    the reference's step-by-step window and matmuls) through 4 layers and
    8 + 4 = 12 recurrent positions, at logits of ~1; a different rounding
    of a routing score would move a logit by ~1e-1, a decay or a
    convolution off by one position by far more."""
    cfg = dict(TINY, expert_offset=offset)
    state = kimi_linear_weights.make_state(cfg, 2**31 + offset, "cpu", torch.float32)
    model = tiny_model(cfg, state)
    assert [type(layer.self_attn) for layer in model.language_model.model.layers] == [
        KDA, KDA, KDA, MLA]
    pixels, ids, mask = tiny_inputs(cfg, offset, 6)
    with torch.no_grad():
        got, aux = model(device_normalize(pixels), ids, mask)
        ref = KimiLinearReference(cfg, state)
        want = ref.logits(pixels, ids, mask)
    assert float((got - want).abs().max()) <= 1e-4
    assert float(want.abs().max()) > 0.1  # the logits are not all near 0
    held = torch.arange(offset, offset + 8)
    assert aux["route_counts"].tolist() == [
        [int((r == e).sum()) for e in held] for r in ref.routes]


def basis(dim, *rows):
    return torch.eye(dim)[list(rows)]


def test_the_delta_rule_reads_back_what_orthonormal_keys_wrote():
    """β = 1, no decay, keys e0, e1, e2: each write finds nothing under its
    key (v - Sᵀk = v), so S = Σ k vᵀ and reading with q = k returns v
    exactly, at its own position and later (β = 0 at the reading
    positions: nothing more is written)."""
    v = torch.tensor([[1.5, -2.0, 0.25], [3.0, 0.5, -1.0], [-0.75, 4.0, 2.0]])
    k = torch.cat([basis(4, 0, 1, 2), basis(4, 1, 0, 2)])[None, :, None]  # [1, 6, 1, 4]
    vals = torch.cat([v, torch.zeros(3, 3)])[None, :, None]
    beta = torch.tensor([[[1.0], [1.0], [1.0], [0.0], [0.0], [0.0]]])
    o = delta_rule(k, k, vals, torch.ones(1, 6, 1, 4), beta)[0, :, 0]
    assert torch.equal(o[:3], v)
    assert torch.equal(o[3:], v[[1, 0, 2]])


def test_the_delta_rule_replaces_what_a_key_held():
    """A second write under the same key replaces its value: v - Sᵀk takes
    out what was there, so reading returns the new value, not the sum."""
    k = basis(2, 0, 0, 0)[None, :, None]
    v = torch.tensor([[2.0, 1.0], [-1.0, 5.0], [0.0, 0.0]])[None, :, None]
    beta = torch.tensor([[[1.0], [1.0], [0.0]]])
    o = delta_rule(k, k, v, torch.ones(1, 3, 1, 2), beta)[0, :, 0]
    assert o.tolist() == [[2.0, 1.0], [-1.0, 5.0], [-1.0, 5.0]]


def test_with_beta_0_the_state_only_decays_by_exp_g_per_key_channel():
    """One write of v under k = 0.6 e0 + 0.8 e1 (β = 1), then β = 0 with
    decays g0 on channel 0 and g1 on channel 1: reading with e0 after n
    steps gives 0.6 v·exp(n·g0) (channel 0's share of the write), with e1
    0.8 v·exp(n·g1)."""
    g = torch.tensor([-0.3, -1.7, 0.0])
    k0 = torch.tensor([0.6, 0.8, 0.0])  # unit norm
    steps = 5
    k = torch.stack([k0] + [torch.zeros(3)] * steps)[None, :, None]
    q = torch.stack([torch.zeros(3)] * steps + [torch.eye(3)[0]])[None, :, None]
    v = torch.tensor([2.0, -3.0])
    vals = torch.stack([v] + [torch.zeros(2)] * steps)[None, :, None]
    alpha = torch.stack([torch.ones(3)] + [g.exp()] * steps)[None, :, None]
    beta = torch.tensor([1.0] + [0.0] * steps)[None, :, None]
    o = delta_rule(q, k, vals, alpha, beta)[0, -1, 0].double()
    want = v.double() * 0.6 * np.exp(float(g[0]) * steps)
    assert torch.allclose(o, want, rtol=1e-6, atol=0)
    q1 = q.clone()
    q1[0, -1, 0] = torch.eye(3)[1]
    o1 = delta_rule(q1, k, vals, alpha, beta)[0, -1, 0].double()
    assert torch.allclose(o1, v.double() * 0.8 * np.exp(float(g[1]) * steps), rtol=1e-6, atol=0)


def kda_inputs(batch, length, heads=4, dk=16, taps=4, seed=0):
    """Random projections' outputs and KDA parameters drawn by the
    benchmark's rules, f32."""
    g = torch.Generator().manual_seed(seed)
    width = heads * dk
    q, k, v, f = (torch.randn(batch, length, width, generator=g) for _ in range(4))
    b = torch.randn(batch, length, heads, generator=g)
    convs = [torch.randn(width, 1, taps, generator=g) * taps ** -0.5 for _ in range(3)]
    a_log = torch.log(1 + 15 * torch.rand(heads, generator=g))
    dt = torch.exp(np.log(1e-3) + np.log(100) * torch.rand(width, generator=g))
    return q, k, v, f, b, *convs, a_log, dt + torch.log(-torch.expm1(-dt)), heads


def test_no_output_depends_on_a_later_position():
    """Changing every input at position 6 (the convolutions' window
    included) leaves positions 0-5 exactly as they were, and moves 6 on."""
    args = list(kda_inputs(3, 10, seed=1))
    before = plain_kda_attention(*args)
    for i in range(5):
        args[i] = args[i].clone()
        args[i][:, 6] += 3.0
    after = plain_kda_attention(*args)
    assert torch.equal(after[:, :6], before[:, :6])
    assert float((after[:, 6:] - before[:, 6:]).abs().min()) > 0


def test_no_state_or_window_passes_between_pairs():
    """The batch's rows flattened token-major: changing pair 2 moves no
    output of pair 1, and each pair alone gives what it gives in the
    batch."""
    args = list(kda_inputs(4, 9, seed=2))
    whole = plain_kda_attention(*args)
    moved = list(args)
    for i in range(5):
        moved[i] = args[i].clone()
        moved[i][2] += 1.0
    after = plain_kda_attention(*moved)
    assert torch.equal(after[[0, 1, 3]], whole[[0, 1, 3]])
    assert not torch.equal(after[2], whole[2])
    for p in range(4):
        alone = plain_kda_attention(*(a[p:p + 1] for a in args[:5]), *args[5:])
        assert float((alone[0] - whole[p]).abs().max()) <= 1e-6


def test_the_kda_module_takes_its_core_from_one_product_of_x():
    """``KDA.forward`` splits ``w_in``'s product into q, k, v, f_a, g_a and
    b in that order, and equals the layer written with each projection
    apart."""
    cfg = model_config_from_dict(TINY)
    layer = KDA(cfg).eval()
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
        x = torch.randn(2, 7, 64, generator=g)
        got = layer(x)
        heads = (2, 7, 4, 16)
        o = kda_attention(layer.q_proj(x), layer.k_proj(x), layer.v_proj(x),
                          layer.f_b_proj(layer.f_a_proj(x)), layer.b_proj(x),
                          layer.q_conv1d.weight, layer.k_conv1d.weight, layer.v_conv1d.weight,
                          layer.A_log, layer.dt_bias, 4)
        o = F.rms_norm(o.view(heads), (16,), layer.o_norm.weight, 1e-5)
        o = o * torch.sigmoid(layer.g_b_proj(layer.g_a_proj(x))).view(heads)
        want = layer.o_proj(o.reshape(2, 7, 64))
    assert layer.w_in.shape == (3 * 64 + 16 + 16 + 4 + 4, 64)  # padded to a multiple of 8
    assert float((got - want).abs().max()) <= 1e-5


def test_nope_mla_through_identity_tables_is_attention_without_rotation():
    """With cos 1 and sin 0, RoPE only permutes q's and k's rope dims alike:
    the core equals attention over [nope | rope] as they are, in f32,
    within the sums' other orders."""
    rng = np.random.default_rng(4)
    b, length, heads, nope, rope, dv = 3, 12, 4, 16, 16, 16
    q = torch.from_numpy(rng.standard_normal((b, length, heads * (nope + rope)), np.float32))
    kv = torch.from_numpy(rng.standard_normal((b, length, heads * (nope + dv)), np.float32))
    k_pe = torch.from_numpy(rng.standard_normal((b, length, rope), np.float32))
    keys = torch.ones(b, length, dtype=torch.int32)
    keys[1, 9:] = 0
    cos, sin = rope_tables(length, rope, 10000.0, nope=True)
    assert torch.equal(cos, torch.ones(length, rope // 2))
    assert torch.equal(sin, torch.zeros(length, rope // 2))
    got = plain_mla_attention(q, kv, k_pe, cos, sin, keys, heads)
    qh = q.view(b, length, heads, nope + rope).transpose(1, 2)
    k_nope, v = kv.view(b, length, heads, nope + dv).split([nope, dv], -1)
    kh = torch.cat([k_nope, k_pe[:, :, None].expand(-1, -1, heads, -1)], -1).transpose(1, 2)
    scores = qh @ kh.transpose(-1, -2) * (nope + rope) ** -0.5
    pos = torch.arange(length)
    keep = (pos[None, :] <= pos[:, None])[None] & (keys[:, None, :] != 0)
    scores = scores.masked_fill(~keep[:, None], float("-inf"))
    want = (torch.softmax(scores, -1) @ v.transpose(1, 2)).transpose(1, 2).reshape(b, length, -1)
    assert float((got - want).abs().max()) <= 1e-5
    rotated = plain_mla_attention(q, kv, k_pe, *rope_tables(length, rope, 10000.0), keys, heads)
    assert float((rotated - want).abs().max()) > 1e-2  # the tables are live


def test_the_expert_parallel_shares_add_up_to_the_uncut_layer():
    """Kimi-Linear's style of routing at the tiny size (top 4 of 16, one
    shared expert) cut into 4 shares of 4 experts: each share's layer
    computes its experts' part plus the shared expert; over the shares,
    the shared expert counted once, they add up to the reference's layer
    holding all 16."""
    whole_cfg = dict(TINY, experts_held=16)
    state = kimi_linear_weights.make_state(whole_cfg, 6, "cpu", torch.float32)
    key = f"{LM}.layers.1.mlp"
    x = torch.randn(40, 64, generator=torch.Generator().manual_seed(1))
    prefix = key + "."
    with torch.no_grad():
        whole = KimiLinearReference(whole_cfg, state).moe(x, key)
        parts = []
        for s in range(4):
            layer = MoE(64, 32, 16, 4, 1, 2.446, 4, 4 * s).eval()
            mine = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
            layer.load_state_dict({k: v for k, v in mine.items() if not k.startswith("experts.")
                                   or int(k.split(".")[1]) in range(4 * s, 4 * s + 4)})
            parts.append(layer(x)[0])
        shared = layer.shared_experts(x)
    total = sum(parts) - 3 * shared
    assert float((total - whole).abs().max()) <= 1e-5


def test_the_state_dict_keys_follow_fla_and_the_published_checkpoint():
    model = DecoderVQAModel(model_config_from_dict(TINY))
    keys = set(model.state_dict())
    assert keys == set(param_shapes(TINY))
    attn = f"{LM}.layers.1.self_attn"
    for name in ("q_proj.weight", "k_proj.weight", "v_proj.weight", "q_conv1d.weight",
                 "k_conv1d.weight", "v_conv1d.weight", "A_log", "dt_bias", "f_a_proj.weight",
                 "f_b_proj.weight", "b_proj.weight", "g_a_proj.weight", "g_b_proj.weight",
                 "o_norm.weight", "o_proj.weight"):
        assert f"{attn}.{name}" in keys, name
    assert f"{LM}.layers.3.self_attn.kv_a_proj_with_mqa.weight" in keys
    assert not [k for k in keys if k.startswith(f"{LM}.layers.3.self_attn.q_conv1d")]
    assert model.state_dict()[f"{attn}.q_conv1d.weight"].shape == (64, 1, 4)
    assert model.state_dict()[f"{attn}.A_log"].shape == (4,)


def test_kimi_vls_configuration_builds_what_it_built_before():
    """The new fields' defaults (no KDA layer, rotation on) leave Kimi-VL's
    model as it was: MLA in every layer, the published keys, the RoPE
    tables, and a sidecar that reads back equal."""
    cfg = model_config_from_dict(TINY_VL)
    assert cfg.kda_layers == () and not cfg.mla_use_nope
    model = DecoderVQAModel(cfg)
    assert all(type(layer.self_attn) is MLA for layer in model.language_model.model.layers)
    assert not [m for m in model.modules() if isinstance(m, KDA)]
    assert set(model.state_dict()) == set(decoder_shapes(TINY_VL))
    cos, sin = rope_tables(12, 16, cfg.rope_theta)
    assert torch.equal(model.language_model.model.rope_cos, cos)
    assert float(sin.abs().max()) > 0.5
    assert model_config_from_dict(model_config_dict(cfg)) == cfg
    hybrid = model_config_from_dict(TINY)
    assert hybrid.kda_layers == (0, 1, 2) and model_config_from_dict(
        model_config_dict(hybrid)) == hybrid


def test_the_weights_follow_the_kda_rules():
    """A_log in [log 1, log 16], dt = softplus(dt_bias) in [1e-3, 0.1], the
    convolutions N(0, 1/4), all from the seed."""
    cfg = dict(TINY, kda_heads=64)
    a = kimi_linear_weights.make_state(cfg, 2**31 + 3, "cpu", torch.float32)
    b = kimi_linear_weights.make_state(cfg, 2**31 + 3, "cpu", torch.float32)
    assert all(torch.equal(a[k], b[k]) for k in a)
    attn = f"{LM}.layers.0.self_attn"
    a_log = a[attn + ".A_log"]
    assert float(a_log.min()) >= 0 and float(a_log.max()) <= np.log(16) + 1e-6
    dt = F.softplus(a[attn + ".dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-4) and float(dt.max()) <= 0.1 * (1 + 1e-4)
    assert 0.4 < float(a[attn + ".q_conv1d.weight"].std()) < 0.6


def test_the_engine_answers_through_its_graphs_path_and_matches_the_reference(tmp_path):
    """The tiny hybrid's bf16 deployment through ``VQAInference`` on the
    CPU: every pair answered, the routing recorded per dispatch, and the
    probabilities within 1e-4 in log of the reference's from the same bf16
    values in f32 (the CPU engine computes in f32)."""
    pixels, questions, state, word2idx = tiny_deployment(tmp_path, seed=3, pairs=10)
    engine = VQAInference(checkpoint_dir=str(tmp_path), checkpoint_name=weights.CHECKPOINT,
                          config=InferenceConfig(batch_buckets=(4,), max_batch_size=4),
                          device="cpu").load()
    assert type(engine.model) is DecoderVQAModel
    before = spans("moe.route")[1]
    probs = engine.predict_probs_from_pixels(pixels, questions)
    assert probs.shape == (10, 16)
    assert len([r for r in spans("moe.route")[0] if r.seq >= before]) == 3
    ids, mask = Vocabulary(word2idx, TINY["max_question_length"]).encode_all(questions)
    lp, routes = log_probs_in_blocks(TINY, {k: v.float() if v.is_floating_point() else v
                                            for k, v in state.items()},
                                     torch.from_numpy(pixels), torch.from_numpy(ids),
                                     torch.from_numpy(mask))
    assert routes.shape[:2] == (3, 10)
    assert np.abs(np.log(probs) - lp.numpy()).max() <= 1e-4
