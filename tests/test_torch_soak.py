"""The port's soak tool (``python -m vqa_tpu_torch.tools.soak_test``) on the
CPU, as a subprocess: the soak measures a whole process (the RSS of the
server and its clients), which the test session's own heap would blur.

The short run (96 requests from 4 clients, tiny model) holds the request
contract: every request answered, none outside its expected outcome, no
request left in the micro-batcher's queue. It lasts a few seconds, too
short for the RSS plateau criterion, which takes growth over the last
third of a run sampled once a second; that criterion is held by the two
``slow`` runs, the counterparts of ``tests/test_soak.py``'s 1,000-request
plateau and 600-request supervised recycle.
"""

import json
import os
import subprocess
import sys

import pytest

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _soak(tmp_path, *args, timeout=600):
    out = tmp_path / "soak.json"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "vqa_tpu_torch.tools.soak_test", "--tiny", "--device", "cpu",
         *args, "--out", str(out)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (f"soak failed rc={proc.returncode}\nstdout tail: "
                                  f"{proc.stdout[-2000:]}\nstderr tail: {proc.stderr[-2000:]}")
    report = json.loads(out.read_text())
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == report
    return report


def test_short_cpu_soak_answers_every_request_within_the_contract(tmp_path):
    report = _soak(tmp_path, "--requests", "96", "--clients", "4", timeout=300)
    assert report["requests_total"] == report["expected_total"] == 96
    assert report["contract_violations"] == {}
    assert report["stuck_waiters"] == 0
    assert report["mix_counts"]["predict"] > 0 and report["backend"] == "cpu"
    assert report["model"] == "tiny" and report["passed"]
    for key in ("predict_p50_ms", "predict_p99_ms", "latency_drift_windows", "rss_start_mb",
                "rss_end_mb", "rss_max_mb", "rss_windows", "rss_growth_last_third_pct",
                "rss_plateaued", "throughput_rps"):
        assert key in report, key
    assert sorted(os.listdir(tmp_path)) == ["soak.json"]  # nothing else written


def test_soak_without_a_card_refuses_unless_the_cpu_is_asked_for(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "vqa_tpu_torch.tools.soak_test", "--tiny", "--requests", "4",
         "--clients", "1"], cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


@pytest.mark.slow
def test_supervised_soak_recycles(tmp_path):
    """Under the recycle supervisor with the bound below a tiny CPU worker's
    RSS (~260-290 MB at ready) a recycle begins under load and every request
    is still answered."""
    report = _soak(tmp_path, "--requests", "600", "--clients", "8",
                   "--supervisor-recycle-mb", "150")
    assert report["requests_total"] == report["expected_total"] == 600
    assert report["contract_violations"] == {}
    assert report["passed"]
    kinds = {e["supervisor"] for e in report["recycles"]}
    assert "recycle_start" in kinds, report["recycles"]


@pytest.mark.slow
def test_cpu_soak_rss_plateaus(tmp_path):
    report = _soak(tmp_path, "--requests", "1000", "--clients", "8")
    assert report["requests_total"] == report["expected_total"] == 1000
    assert report["contract_violations"] == {}
    assert report["stuck_waiters"] == 0
    assert report["rss_plateaued"], report["rss_growth_last_third_pct"]
    assert report["rss_growth_last_third_pct"] < 5.0
    assert report["passed"]
