"""The plain reference against the port's plain path at a tiny width on the
CPU (this test imports both; the reference imports nothing of the port),
and the determinism of every input the benchmark draws from its seed."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.harness import weights  # noqa: E402
from benchmark.reference.model import Reference, fp8  # noqa: E402
from benchmark.reference.prep import Vocabulary  # noqa: E402

TINY = dict(image_size=64, in_channels=3, base_channels=8, stage_channels=[8, 16, 32, 64],
            blocks_per_stage=[2, 2, 2, 2], feature_spatial_size=2, use_se_attention=True,
            use_spatial_attention=True, se_reduction=4, spatial_kernel_size=7,
            vocab_size=300, embed_dim=32, num_transformer_layers=2, num_attention_heads=4,
            ffn_hidden_dim=64, max_question_length=10, pad_idx=0, num_cross_layers=2,
            use_gating=True, num_answers=24, answer_hidden_dim=64, answer_dropout=0.3,
            dropout=0.1)


def port_model(cfg, state):
    from vqa_tpu_torch.models.vqa_model import VQAModel
    from vqa_tpu_torch.utils.config import model_config_from_dict

    model = VQAModel(model_config_from_dict(cfg)).eval()
    model.load_state_dict(state, strict=True)
    return model


@pytest.mark.parametrize("attention", [True, False])
def test_reference_matches_the_port_at_a_tiny_width(attention):
    from vqa_tpu_torch.data.preprocess import device_normalize

    cfg = dict(TINY, use_se_attention=attention, use_spatial_attention=attention)
    state = weights.make_state(cfg, 2**31 + 5, "cpu")
    model = port_model(cfg, state)
    vocab = weights.words(cfg["vocab_size"] - 4, 3)
    qs = weights.questions(vocab, 6, 3, 14, 3)
    ids, mask = Vocabulary(weights.word_table(vocab), cfg["max_question_length"]).encode_all(qs)
    pixels = torch.randint(0, 256, (6, 64, 64, 3), dtype=torch.uint8)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        want, _ = model(device_normalize(pixels), ids.long(), mask)
        got = Reference(cfg, state).logits(pixels, ids, mask)
    assert torch.allclose(got, want, atol=2e-5, rtol=0)
    low = Reference(cfg, state, quant=fp8).logits(pixels, ids, mask)
    assert (low - want).abs().max() > 1e-3  # the control differs


def test_reference_tokens_are_the_ports():
    from vqa_tpu_torch.utils.tokenizer import Tokenizer

    vocab = weights.words(200, 9)
    tok = Tokenizer(max_length=8)
    tok.word2idx = weights.word_table(vocab)
    qs = weights.questions(vocab, 40, 3, 14, 9) + ["What's THIS, 'thing'?", "a  b\tc"]
    ids, mask = tok.encode_batch_np(qs)
    rids, rmask = Vocabulary(weights.word_table(vocab), 8).encode_all(qs)
    assert (ids == rids).all() and (mask == rmask).all()


def test_inputs_repeat_per_seed():
    a = weights.make_state(TINY, 11, "cpu")
    b = weights.make_state(TINY, 11, "cpu")
    c = weights.make_state(TINY, 12, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["answer_head.classifier.6.weight"],
                           c["answer_head.classifier.6.weight"])
    assert weights.words(50, 2**33 + 1) == weights.words(50, 2**33 + 1)
    q1, q2 = weights.questions(weights.words(50, 1), 30, 3, 14, 5), \
        weights.questions(weights.words(50, 1), 30, 3, 14, 6)
    assert q1 == weights.questions(weights.words(50, 1), 30, 3, 14, 5) and q1 != q2
    assert sorted(len(q.split()) for q in q1) == sorted(len(q.split()) for q in q2)

