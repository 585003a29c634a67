"""The Kimi-Linear configuration's pieces on the CPU: its operation count
against PyTorch's own counter, the KDA core's bound, its file against the
catalog's numbers, the three new readers on made-up traces (a CPU host
cannot record device activity), and one tiny run of its traffic kind end to
end."""

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

from benchmark.costs.kimi_linear_flops import (KDA_KERNELS, forward_flops,  # noqa: E402
                                               kda_bound_s)
from benchmark.harness import kimi_linear_weights, spec  # noqa: E402
from benchmark.harness.record import Record  # noqa: E402
from benchmark.harness.trace import kernel_base  # noqa: E402
from benchmark.reference.kimi_linear_vqa import KimiLinearReference, param_shapes  # noqa: E402

CELL = "kimilinear_infer_b256"
KERNEL = ("void (anonymous namespace)::kda_recurrence_bf16<128, 4>((anonymous namespace)::"
          "KdaParams)")
TINY = dict(image_size=64, base_channels=8, stage_channels=[8, 16, 32, 64],
            feature_spatial_size=2, se_reduction=4, vocab_size=400, max_question_length=10,
            num_answers=64, answer_hidden_dim=64, decoder_hidden=64, decoder_layers=4,
            decoder_heads=4, decoder_ffn_dim=96, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=16, v_head_dim=16, moe_intermediate_size=32, router_experts=16,
            num_experts_per_tok=4, n_shared_experts=1, experts_held=8, kda_layers=[0, 1, 2],
            kda_heads=4, kda_head_dim=16)


def config():
    with open(os.path.join(ROOT, "benchmark", "configs", "kimilinear_48b_ep8.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("offset", [0, 8])
def test_forward_flops_match_the_flop_counter(offset):
    """Every product of the reference's forward, as FlopCounterMode counts
    them, with the routed experts at the rows the reference routed to the
    held experts and the backbone at the configuration's full width; the
    KDA update, an elementwise product in the reference, is the one part
    the counter does not see."""
    cfg = dict(config()["model"], **{k: v for k, v in TINY.items()
                                     if not k.startswith(("image", "base", "stage", "feature",
                                                          "se_"))}, expert_offset=offset)
    state = kimi_linear_weights.make_state(cfg, 11, "cpu", torch.float32)
    pixels = torch.randint(0, 256, (2, 224, 224, 3), dtype=torch.uint8)
    ids = torch.randint(4, 100, (2, cfg["max_question_length"]))
    mask = torch.ones_like(ids)
    ref = KimiLinearReference(cfg, state)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref.logits(pixels, ids, mask)
    held = torch.arange(offset, offset + cfg["experts_held"])
    rows = sum(int((r[..., None] == held).sum()) for r in ref.routes) / 2
    f = forward_flops(cfg, rows)
    assert counter.get_total_flops() == 2 * (f["total"] - f["kda_update"])
    n, h, dk = 49 + cfg["max_question_length"], 4, 16  # 7 x 7 image tokens, the question
    assert f["kda_update"] == 3 * 2 * n * h * dk * dk


def test_the_full_configuration_counts_its_published_sizes():
    cfg = config()["model"]
    f = forward_flops(cfg)
    assert abs(f["total"] / 69 / 1e9 - 3.015) < 0.001  # ~3.0 GFLOP a token
    share = (f["kda_projections"] + f["kda_core"] + f["kda_update"]) / f["total"]
    assert 0.54 < share < 0.56  # the KDA layers' share of the work
    # the core's bytes at bucket 256: 5 bf16 inputs of 4,096 + beta's 32, o
    # written, 0.72 GB a layer, 20 layers at 3.35 TB/s
    tokens = 256 * 69
    assert kda_bound_s(cfg, tokens) == pytest.approx(
        20 * tokens * 2 * (5 * 4096 + 32) / 3.35e12)
    assert 4.32e-3 < kda_bound_s(cfg, tokens) < 4.34e-3


def test_the_file_holds_the_catalogs_numbers_and_the_cut():
    cfg = config()
    catalog = {
        "first_k_dense_replace": 1, "head_dim": 72, "hidden_act": "silu", "hidden_size": 2304,
        "intermediate_size": 9216, "kv_lora_rank": 512, "mla_use_nope": True,
        "model_max_length": 1048576, "model_type": "kimi_linear", "moe_intermediate_size": 1024,
        "moe_layer_freq": 1, "moe_renormalize": True, "moe_router_activation_func": "sigmoid",
        "num_attention_heads": 32, "num_expert_group": 1, "num_experts": 256,
        "num_experts_per_token": 8, "num_hidden_layers": 27, "num_key_value_heads": 32,
        "num_nextn_predict_layers": 0, "num_shared_experts": 1, "q_lora_rank": None,
        "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-05,
        "rope_scaling": None, "rope_theta": 10000, "routed_scaling_factor": 2.446,
        "tie_word_embeddings": False, "topk_group": 1, "use_grouped_topk": True,
        "v_head_dim": 128, "vocab_size": 163840}
    changed = [k for k, v in catalog.items() if cfg[k] != v]
    assert changed == cfg["reduced"] == ["num_experts"]
    assert cfg["num_experts"] == 32 and cfg["published"]["num_experts"] == 256
    lin = cfg["linear_attn_config"]
    m = cfg["model"]
    assert sorted(m["kda_layers"] + [i - 1 for i in lin["full_attn_layers"]]) == list(range(27))
    assert m["kda_layers"] == [i - 1 for i in lin["kda_layers"]]
    assert (m["kda_heads"], m["kda_head_dim"], m["short_conv_kernel_size"]) == (
        lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"]) == (32, 128, 4)
    assert (m["decoder_hidden"], m["decoder_layers"], m["decoder_heads"], m["decoder_ffn_dim"],
            m["moe_intermediate_size"], m["router_experts"], m["num_experts_per_tok"],
            m["n_shared_experts"], m["experts_held"], m["expert_offset"], m["vocab_size"],
            m["mla_use_nope"]) == (2304, 27, 32, 9216, 1024, 256, 8, 1, 32, 0, 163840, True)
    params = sum(math.prod(s) for s, k in param_shapes(m).values()
                 if k not in ("bn_mean", "bn_var", "count"))
    assert params == cfg["parameters"] and cfg["dtype"] == "bfloat16"
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        entry = {c["name"]: c for c in json.load(f)["configs"]}[cfg["name"]]
    assert entry["source"] == cfg["source"] and entry["reduced"] == cfg["reduced"]


def record(launches, forwards=4):
    cell = spec.load(ROOT, CELL)
    trace = {"by_name": {KERNEL: 0.08, "nvjet_tst_192x192": 0.3},
             "launches": {KERNEL: launches, "nvjet_tst_192x192": 500}}
    return Record(cell=cell, trace=trace if launches is not None else None,
                  trace_counts={"forwards": forwards}, counts={"pairs": 2048}, window_s=1.0)


def test_the_cell_reports_the_new_metrics_and_only_that_cell():
    names = [m["name"] for m in spec.load(ROOT, CELL).per_layer]
    assert {"kda.device_ms", "kda.roofline", "mfu.infer_kda", "mla.device_ms",
            "moe.router_ms"} <= set(names)
    assert not {"attn.device_ms", "mfu.infer_decoder", "forward.mfu", "mfu.infer",
                "kernels_roofline"} & set(names)
    for other in ("ref_infer_b32", "noattn_infer_b32", "kimivl_infer_b256"):
        assert not {"kda.device_ms", "kda.roofline", "mfu.infer_kda", "mla.device_ms"} & {
            m["name"] for m in spec.load(ROOT, other).per_layer}


def test_the_kda_readers_read_per_forward_where_each_kda_layer_launched_its_kernel():
    assert kernel_base(KERNEL) in KDA_KERNELS
    rec = record(20 * 4)
    assert spec.reader("kda.device_ms")(rec) == pytest.approx(20.0)  # 80 ms over 4 forwards
    share = spec.reader("kda.roofline")(rec)
    assert share == pytest.approx(100 * kda_bound_s(rec.cell.model, 256 * 69) * 1e3 / 20.0)
    assert not rec.notes


@pytest.mark.parametrize("launches", [0, 20 * 4 - 1, 27 * 4])
def test_not_read_with_a_note_where_the_count_is_off(launches):
    rec = record(launches)
    assert spec.reader("kda.device_ms")(rec) is None
    assert spec.reader("kda.roofline")(rec) is None
    assert rec.notes[0] == f"kda.device_ms not read: kda_recurrence_bf16 ({launches} launches, " \
                           f"80 expected)"


MLA_KERNEL = ("void (anonymous namespace)::mla_attention_bf16<128, 64, 128>"
              "((anonymous namespace)::Params)")


@pytest.mark.parametrize("launches,want", [(7 * 4, 10.0), (27 * 4, None), (0, None)])
def test_the_mla_reader_reads_where_each_non_kda_layer_launched_once(launches, want):
    rec = record(20 * 4)
    rec.trace["by_name"][MLA_KERNEL] = 0.04
    rec.trace["launches"][MLA_KERNEL] = launches
    assert spec.reader("mla.device_ms")(rec) == (None if want is None else pytest.approx(want))
    assert rec.notes == ([] if want else [f"mla.device_ms not read: mla_attention_bf16 "
                                          f"({launches} launches, 28 expected)"])


def test_not_read_without_a_trace():
    rec = record(None)
    assert spec.reader("kda.device_ms")(rec) is None and not rec.notes
    assert spec.reader("kda.roofline")(rec) is None
    assert spec.reader("mla.device_ms")(rec) is None and not rec.notes


def test_mfu_is_the_pairs_operations_over_the_window_at_the_peak():
    rec = record(None)
    want = 100 * forward_flops(rec.cell.model)["total"] * 2048 / 989e12
    assert spec.reader("mfu.infer_kda")(rec) == pytest.approx(want)
    rec.counts["pairs"] = 0
    assert spec.reader("mfu.infer_kda")(rec) is None


def test_pinned_routing_takes_the_given_experts_and_records_its_own():
    """Pinned to its own choices the reference is unchanged bit for bit;
    pinned to others it computes those experts, and still records its own
    choices (the first MoE layer's are those of the free forward)."""
    from benchmark.reference.kimi_linear_vqa import log_probs_in_blocks

    cfg = dict(config()["model"], **TINY)
    state = kimi_linear_weights.make_state(cfg, 3, "cpu", torch.float32)
    g = torch.Generator().manual_seed(3)
    pixels = torch.randint(0, 256, (3, 64, 64, 3), generator=g, dtype=torch.uint8)
    ids = torch.randint(4, 100, (3, cfg["max_question_length"]), generator=g)
    mask = torch.ones_like(ids)
    mask[0, 4:] = 0
    free, own = log_probs_in_blocks(cfg, state, pixels, ids, mask, block=2)
    same, again = log_probs_in_blocks(cfg, state, pixels, ids, mask, block=2,
                                      routes=own.int())  # int32, as the card chooses
    assert torch.equal(same, free) and torch.equal(again, own)
    other = (own + 1) % cfg["router_experts"]  # every choice moved to another expert
    moved, mine = log_probs_in_blocks(cfg, state, pixels, ids, mask, block=2, routes=other)
    assert torch.equal(mine[0], own[0]) and not torch.equal(mine, own)
    assert (moved - free).abs().max() > 1e-3


def tiny_cell():
    cell = copy.deepcopy(spec.load(ROOT, CELL))
    cell.config["dtype"] = "float32"
    cell.config["model"].update(TINY)
    cell.traffic.update(pool_pairs=32, call_pairs=8, bucket=4, check_rows=24,
                        trace_seconds=0.2)
    return cell


def test_a_tiny_run_of_the_kind_is_correct_and_reads_its_metrics():
    cell = tiny_cell()
    cell.traffic["limits"] = {"logprob_gap": 1e-3, "logprob_gap_p99": 1e-3,
                              "gap_over_bf16": 0.1}  # f32 on both sides: far under bf16's
    kind = spec.kind(cell.traffic["kind"])
    rec = kind.run(cell, 2**31 + 77, 0.5, False, time.perf_counter(), device="cpu")
    assert rec.correct and rec.counts["forwards"] == 2 * rec.counts["calls"]
    readers = spec.readers(cell.end_to_end + cell.per_layer)
    assert readers["moe.rows_per_expert"](rec) > 0 and readers["moe.imbalance"](rec) >= 1
    assert readers["mfu.infer_kda"](rec) > 0
    assert any(n.startswith("routing: 0.000%") for n in rec.notes)
    low = kind.control_readings(cell, 5, "cpu")
    assert low["logprob_gap"] > 100 * rec.checks["logprob_gap"].value
    assert np.isfinite(low["logprob_gap_p99"])
    assert low["gap_over_bf16"] > 1 > 100 * rec.checks["gap_over_bf16"].value
