"""The decoder configuration's pieces on the CPU: its operation count
against PyTorch's own counter, its file against the catalog's numbers, its
weights' rules, and one tiny run of its traffic kind end to end."""

import copy
import json
import math
import os
import sys
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.costs.decoder_flops import (expected_rows, forward_flops,  # noqa: E402
                                           routed_bound_s)
from benchmark.harness import decoder_weights, spec  # noqa: E402
from benchmark.reference.decoder_vqa import DecoderReference, param_shapes  # noqa: E402

CELL = "kimivl_infer_b256"
TINY = dict(image_size=64, base_channels=8, stage_channels=[8, 16, 32, 64],
            feature_spatial_size=2, se_reduction=4, vocab_size=400, max_question_length=10,
            num_answers=64, answer_hidden_dim=64, decoder_hidden=64, decoder_layers=3,
            decoder_heads=4, decoder_ffn_dim=96, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=16, v_head_dim=16, moe_intermediate_size=32, router_experts=16,
            num_experts_per_tok=4, n_shared_experts=1, experts_held=8)


def config():
    with open(os.path.join(ROOT, "benchmark", "configs", "kimivl_a3b_ep8.json")) as f:
        return json.load(f)


def tiny_cell():
    cell = copy.deepcopy(spec.load(ROOT, CELL))
    cell.config["dtype"] = "float32"
    cell.config["model"].update(TINY)
    cell.traffic.update(pool_pairs=32, call_pairs=8, bucket=4, check_rows=24,
                        trace_seconds=0.2)
    return cell


@pytest.mark.parametrize("offset", [0, 8])
def test_forward_flops_match_the_flop_counter(offset):
    """Every product of the reference's forward, as FlopCounterMode counts
    them, with the routed experts at the rows the reference routed to the
    held experts; the backbone at the configuration's full width."""
    cfg = dict(config()["model"], **{k: v for k, v in TINY.items()
                                     if not k.startswith(("image", "base", "stage", "feature",
                                                          "se_"))}, expert_offset=offset)
    state = decoder_weights.make_state(cfg, 11, "cpu", torch.float32)
    pixels = torch.randint(0, 256, (2, 224, 224, 3), dtype=torch.uint8)
    ids = torch.randint(4, 100, (2, cfg["max_question_length"]))
    mask = torch.ones_like(ids)
    ref = DecoderReference(cfg, state)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref.logits(pixels, ids, mask)
    held = torch.arange(offset, offset + cfg["experts_held"])
    rows = sum(int((r[..., None] == held).sum()) for r in ref.routes) / 2
    # the head runs on the last position alone; FlopCounterMode counts a
    # multiply-add as 2, as the count does
    assert counter.get_total_flops() == 2 * forward_flops(cfg, rows)["total"]


def test_the_full_configuration_counts_its_published_sizes():
    cfg = config()["model"]
    f = forward_flops(cfg)
    assert abs(f["total"] / 1e9 - 152.15) < 0.01  # ~152 GFLOP a pair
    assert expected_rows(cfg) * 256 / 26 / 8 == 1656  # rows per held expert per layer
    bound_ms = routed_bound_s(cfg, 256 * 69, expected_rows(cfg) * 256) * 1e3
    assert 9.0 < bound_ms < 9.5  # the grouped GEMMs alone ~6.0 ms of it


def test_the_file_holds_the_catalogs_numbers_and_the_cut():
    cfg = config()
    catalog = {
        "vocab_size": 163840, "max_position_embeddings": 131072, "hidden_size": 2048,
        "intermediate_size": 11264, "moe_intermediate_size": 1408, "num_hidden_layers": 27,
        "num_attention_heads": 16, "n_shared_experts": 2, "n_routed_experts": 64, "ep_size": 1,
        "routed_scaling_factor": 2.446, "kv_lora_rank": 512, "q_lora_rank": None,
        "qk_rope_head_dim": 64, "v_head_dim": 128, "qk_nope_head_dim": 128,
        "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1, "num_experts_per_tok": 6,
        "moe_layer_freq": 1, "first_k_dense_replace": 1, "norm_topk_prob": True,
        "scoring_func": "sigmoid", "seq_aux": True, "num_key_value_heads": 16,
        "hidden_act": "silu", "rms_norm_eps": 1e-05, "rope_theta": 800000,
        "rope_scaling": None, "attention_bias": False, "tie_word_embeddings": False}
    changed = [k for k, v in catalog.items() if cfg[k] != v]
    assert changed == cfg["reduced"] == ["n_routed_experts"]
    assert cfg["n_routed_experts"] == 8 and cfg["published"]["n_routed_experts"] == 64
    m = cfg["model"]
    assert (m["decoder_hidden"], m["decoder_layers"], m["decoder_heads"], m["decoder_ffn_dim"],
            m["moe_intermediate_size"], m["router_experts"], m["num_experts_per_tok"],
            m["experts_held"], m["expert_offset"], m["vocab_size"]) == (
        2048, 27, 16, 11264, 1408, 64, 6, 8, 0, 163840)
    params = sum(math.prod(s) for s, k in param_shapes(m).values()
                 if k not in ("bn_mean", "bn_var", "count"))
    assert params == cfg["parameters"] and cfg["dtype"] == "bfloat16"
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        entry = {c["name"]: c for c in json.load(f)["configs"]}[cfg["name"]]
    assert entry["source"] == cfg["source"] and entry["reduced"] == cfg["reduced"]


def test_the_weights_follow_their_rules_and_the_seed():
    cfg = dict(config()["model"], **TINY)
    a = decoder_weights.make_state(cfg, 2**31 + 9, "cpu")
    b = decoder_weights.make_state(cfg, 2**31 + 9, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["language_model.model.norm.weight"].dtype == torch.bfloat16
    bias = a["language_model.model.layers.1.mlp.gate.e_score_correction_bias"].float()
    assert 0.02 < float(bias.std()) < 0.3
    rms = a["language_model.model.layers.2.input_layernorm.weight"].float()
    assert abs(float(rms.mean()) - 1) < 0.1


def test_a_tiny_run_of_the_kind_is_correct_and_reads_its_metrics():
    cell = tiny_cell()
    cell.traffic["limits"] = {"logprob_gap": 1e-3, "logprob_gap_p99": 1e-3}
    kind = spec.kind(cell.traffic["kind"])
    rec = kind.run(cell, 2**31 + 77, 0.5, False, time.perf_counter(), device="cpu")
    assert rec.correct and rec.counts["forwards"] == 2 * rec.counts["calls"]
    readers = spec.readers(cell.end_to_end + cell.per_layer)
    rows = readers["moe.rows_per_expert"](rec)
    assert rows > 0 and readers["moe.imbalance"](rec) >= 1
    assert readers["mfu.infer_decoder"](rec) > 0
    assert any(n.startswith("routing: 0.000%") for n in rec.notes)
    low = kind.control_readings(cell, 5, "cpu")
    assert low["logprob_gap"] > 100 * rec.checks["logprob_gap"].value
    assert np.isfinite(low["logprob_gap_p99"])
