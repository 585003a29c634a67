"""The port's multi-process runtime (``vqa_tpu_torch.parallel.distributed``)
and its CLIs, on the CPU.

Ported from ``tests/test_distributed.py:182-221`` and
``tests/test_sharding.py:62-88``: the single-process no-op,
``local_batch_size``, explicit arguments over the launcher's variables,
``shard_for_process`` equal to JAX's on the same indices, and the CLI flags
driving the grid. The last runs the train and evaluate CLIs as 4 gloo ranks
(``tests/test_torch_ranks.py``) at --data-parallel 2 --model-parallel 2; the
grid evaluator's results equal the one-process evaluator's on the same
checkpoint.
"""

import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from test_torch_ranks import cli_checks, run_ranks
from vqa_tpu.data.dataset import BatchLoader as JaxBatchLoader
from vqa_tpu.data.dataset import DemoVQADataset as JaxDemo
from vqa_tpu.data.dataset import shard_for_process as jax_shard_for_process
from vqa_tpu_torch.data.dataset import BatchLoader, DemoVQADataset, shard_for_process
from vqa_tpu_torch.parallel import distributed
from vqa_tpu_torch.serving import server
from vqa_tpu_torch.training import evaluate, train

LAUNCHER_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def no_launcher(monkeypatch):
    for name in LAUNCHER_VARS:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture
def fake_init(monkeypatch):
    """Records init_process_group's arguments instead of joining a group."""
    calls = []

    def init(backend, init_method=None, world_size=-1, rank=-1, **kwargs):
        calls.append(dict(backend=backend, init_method=init_method, world_size=world_size,
                          rank=rank, **kwargs))

    monkeypatch.setattr(distributed.dist, "init_process_group", init)
    return calls


def test_single_process_is_noop(no_launcher):
    """Without a coordinator or launcher variables, initialize() does
    nothing and the helpers collapse to the single-process answers."""
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    assert distributed.is_primary()
    assert distributed.local_batch_size(32) == 32
    distributed.barrier()  # a world of one waits for no one


def test_local_batch_size_divisibility():
    with pytest.raises(ValueError, match="global batch 32 not divisible by 3 processes"):
        with mock.patch.object(distributed, "process_count", return_value=3):
            distributed.local_batch_size(32)
    with pytest.raises(ValueError, match="not divisible"):
        distributed.local_batch_size(32, shards=3)
    assert distributed.local_batch_size(32, shards=2) == 16


def test_explicit_args_take_precedence_over_env(monkeypatch, fake_init):
    """Explicit arguments win; the launcher's variables fill in a call
    without them; a coordinator without the world's size is an error."""
    env = dict(MASTER_ADDR="envhost", MASTER_PORT="1", WORLD_SIZE="4", RANK="3")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert distributed.initialize("realhost:2", 2, 1, device="cpu", timeout_s=5) is True
    assert distributed.initialize(device="cpu") is True
    first, second = fake_init
    assert (first["init_method"], first["world_size"], first["rank"], first["backend"]) == (
        "tcp://realhost:2", 2, 1, "gloo")
    assert first["timeout"].total_seconds() == 5
    assert (second["init_method"], second["world_size"], second["rank"]) == (
        "tcp://envhost:1", 4, 3)
    with pytest.raises(ValueError, match="without the number of processes"):
        distributed.initialize("realhost:2", device="cpu")


def test_card_ranks_take_nccl_and_bind_their_card(monkeypatch, fake_init, no_launcher):
    """On the card the backend is NCCL unless one is asked for, and each
    rank binds cuda:LOCAL_RANK (else its id modulo the card count) first."""
    bound = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    distributed.initialize("h:1", 8, 6)
    monkeypatch.setenv("LOCAL_RANK", "1")
    distributed.initialize("h:1", 8, 6, backend="gloo")
    assert [c["backend"] for c in fake_init] == ["nccl", "gloo"]
    assert bound == [2, 1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize("h:1", 2, 0)


def test_shard_for_process_equals_jax():
    """Equal-length disjoint stride slices, the same indices as JAX's; one
    shard is the loader itself."""
    port = BatchLoader(DemoVQADataset(num_samples=23), 4, indices=np.arange(3, 23))
    jax_loader = JaxBatchLoader(JaxDemo(num_samples=23), 4, indices=np.arange(3, 23))
    for count in (2, 3, 4):
        shards = [shard_for_process(port, i, count).indices for i in range(count)]
        for i, got in enumerate(shards):
            want = jax_shard_for_process(jax_loader, i, count).indices
            np.testing.assert_array_equal(got, want)
        assert len({len(s) for s in shards}) == 1
        assert len(np.unique(np.concatenate(shards))) == sum(len(s) for s in shards)
    assert shard_for_process(port) is port  # one process
    np.testing.assert_array_equal(port.indices, np.arange(3, 23))


def test_one_process_clis_name_the_launcher(no_launcher, tmp_path):
    with pytest.raises(ValueError, match=r"model_parallel=2 does not divide 1 processes .*"
                                         r"--nproc-per-node 4"):
        train.main(["--tiny", "--demo", "--device", "cpu", "--data-parallel", "2",
                    "--model-parallel", "2", "--checkpoint-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="data_parallel=3 does not divide the batch size 32"):
        train.main(["--tiny", "--demo", "--device", "cpu", "--data-parallel", "3"])
    # the server's replicas are devices of this process: the CPU is one
    with pytest.raises(ValueError, match=r"mesh 2×1 needs 2 devices but only 1 are available"):
        server.main(["--tiny", "--device", "cpu", "--data-parallel", "2"])


def test_cli_flags_drive_dp_and_tp(tmp_path):
    """The train CLI over 4 ranks at --data-parallel 2 --model-parallel 2:
    the Trainer's grid is 2×2, each data rank steps over its own half of
    the samples at 4 rows (a global batch of 8), the ranks of a model group
    read the same one, the cross-attention runs on one of its two heads per
    rank; every rank holds the same epoch metrics, which the history file
    records; the evaluator CLI over the grid gives the one-process
    evaluator's results on the same checkpoint and writes its artifacts."""
    results = run_ranks(cli_checks, 4, str(tmp_path), timeout=150)
    for out in results:
        assert out["mesh"] == {"data": 2, "model": 2}
        assert out["batch"] == 4 and out["heads"] == 1
        assert np.isfinite(out["history"]["train_loss"][0])
    train_shards = [r["train"] for r in results]
    assert train_shards[0] == train_shards[1] and train_shards[2] == train_shards[3]
    assert not set(train_shards[0]) & set(train_shards[2])
    assert results[0]["val"] != results[2]["val"]
    # every rank agrees on the epoch's metrics (summed over the data group)
    assert all(r["history"] == results[0]["history"] for r in results)
    history = json.loads((tmp_path / "training_history.json").read_text())
    assert history["history"]["val_top1"] == results[0]["history"]["val_top1"]
    alone = evaluate.main(["--checkpoint-dir", str(tmp_path), "--demo", "--batch-size", "8",
                           "--max-samples", "20", "--device", "cpu",
                           "--output-dir", str(tmp_path / "alone")])
    for out in results:
        on_grid = out["evaluate"]
        for k in ("num_samples", "top1_accuracy", "top5_accuracy", "per_type_accuracy",
                  "per_class_accuracy_top", "error_pairs"):
            assert on_grid[k] == alone[k], k
    assert sorted(os.listdir(tmp_path / "eval")) == ["evaluation_report.txt",
                                                     "evaluation_results.json"]
