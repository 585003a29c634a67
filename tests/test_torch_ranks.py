"""Ranks of a gloo process group on the CPU, for the port's multi-device
tests (``tests/test_torch_parallel.py``, ``tests/test_torch_distributed.py``).

It holds no tests. It imports torch and the port only, so the ranks,
started with ``spawn``, never import JAX; the JAX references are computed
in the test process and handed to the ranks as arguments.

``run_ranks(fn, world, *args)`` starts ``world`` processes on a free port,
each joining the group with a rendezvous timeout of its own, runs
``fn(rank, world, *args)`` in each and returns their results by rank. A rank
that raises, dies or outlasts ``timeout`` fails the call at once and the
others are killed, so a hang fails one test instead of the suite's clock.
"""

from __future__ import annotations

import multiprocessing
import queue
import socket
import time
import traceback

import numpy as np
import torch

RENDEZVOUS_S = 60


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, args, results) -> None:
    from vqa_tpu_torch.parallel import distributed

    try:
        torch.set_num_threads(1)
        distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu",
                               timeout_s=RENDEZVOUS_S)
        # torch's oneDNN CPU convolution backward crashes on the test host
        with torch.backends.mkldnn.flags(enabled=False):
            out = fn(rank, world, *args)
        results.put((rank, "ok", out))
    except Exception:  # handed to the test process
        results.put((rank, "error", traceback.format_exc()))
    finally:
        distributed.shutdown()


def run_ranks(fn, world: int, *args, timeout: float = 120.0) -> list:
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, args, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    done = {}
    deadline = time.monotonic() + timeout
    try:
        while len(done) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(world)) - set(done))
                raise TimeoutError(f"ranks {missing} did not finish within {timeout} s")
            try:
                rank, status, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks died without a result (rank, exit code): {dead}")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            done[rank] = out
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    return [done[r] for r in range(world)]


def numpy_state(state: dict) -> dict:
    """Copies: a state_dict's tensors share the parameters' memory."""
    return {k: v.detach().cpu().numpy().copy() for k, v in state.items()}


# ---------------------------------------------------------------------------
# The rank functions
# ---------------------------------------------------------------------------

def _full_grads(model) -> dict:
    """Each parameter's gradient, split ones gathered over the model group."""
    from vqa_tpu_torch.parallel.mesh import gather

    mesh, out = model.mesh, {}
    for name, p in model.named_parameters():
        g = p.grad
        if name in model.tp_splits:
            g = gather(g, model.tp_splits[name], mesh.model_index, mesh.model_parallel,
                       mesh.model_group)
        out[name] = g.numpy().copy()
    return out


def _global_metrics(metrics: dict, mesh) -> tuple:
    """(loss, top-1, top-5) of the global batch from this rank's shard."""
    import torch.distributed as dist

    t = torch.stack([metrics["loss"].float(), metrics["correct1"].float(),
                     metrics["correct5"].float()])
    dist.all_reduce(t, group=mesh.data_group)
    return float(t[0]) / mesh.data_parallel, int(t[1]), int(t[2])


class _Loader(list):
    """Stands in for a loader where the Trainer only reads its length and
    batch size."""

    batch_size = 4


def grid_checks(rank: int, world: int, ref: dict) -> dict:
    """On 4 ranks: the dp2×mp2 and dp1×mp4 eval forwards, one dp2×mp2 train
    step on the global batch, a dp2×mp2 Trainer step with grad_accum=2
    beside the one-process step, its checkpoint and resume, and the dp2×mp2
    evaluator beside the one-process evaluator."""
    from vqa_tpu_torch.data.dataset import BatchLoader, DemoVQADataset
    from vqa_tpu_torch.models import create_vqa_model, forward_logits
    from vqa_tpu_torch.models.vqa_model import shard_model
    from vqa_tpu_torch.parallel import create_mesh, data_sharding
    from vqa_tpu_torch.parallel.mesh import gather
    from vqa_tpu_torch.training import train
    from vqa_tpu_torch.training.evaluate import Evaluator
    from vqa_tpu_torch.utils.config import TrainingConfig, model_config_from_dict

    cfg = model_config_from_dict(ref["config"])

    def model(mesh=None):
        m = create_vqa_model(config=cfg, device="cpu")
        m.load_state_dict(ref["state"], strict=True)
        return shard_model(m, mesh) if mesh is not None else m

    out = {}
    images, ids, mask = (torch.from_numpy(a) for a in ref["eval"])
    for name, (dp, mp) in (("dp2xmp2", (2, 2)), ("dp1xmp4", (1, 4))):
        mesh = create_mesh(dp, mp)
        rows = data_sharding(mesh, images.shape[0])
        sharded = model(mesh)
        out[f"heads_{name}"] = sharded.text_encoder.layers[0].self_attention.num_heads
        logits = forward_logits(sharded, images[rows], ids[rows].long(), mask[rows])
        out[f"logits_{name}"] = gather(logits, 0, mesh.data_index, dp, mesh.data_group).numpy()

    # one dp2×mp2 step on the global batch, each data rank its rows
    batch = [torch.from_numpy(a) for a in ref["batch"]]
    grid = create_mesh(2, 2)
    tcfg = TrainingConfig(**ref["train_kw"])
    m = model(grid)
    state = train.TrainState.create(m, tcfg, ref["steps_per_epoch"])
    metrics = train.make_train_step(m)(state, *(t[data_sharding(grid, 8)] for t in batch))
    out["step"] = {"metrics": _global_metrics(metrics, grid),
                   "state": numpy_state(m.full_state_dict()), "grads": _full_grads(m)}
    # the same step with the stages recomputed in the backward (the BN
    # all_reduce runs again there; the running statistics move once)
    m = model(grid)
    state = train.TrainState.create(m, tcfg, ref["steps_per_epoch"])
    train.make_train_step(m, remat="stages")(state, *(t[data_sharding(grid, 8)] for t in batch))
    out["remat"] = {"state": numpy_state(m.full_state_dict()), "grads": _full_grads(m)}

    # grad_accum=2 through the Trainer: each rank's two microbatches are its
    # halves of the global microbatches (rows 0-3, 4-7), so the global
    # microbatch BN normalises is the one-process step's; no clipping, so
    # the gradients are compared at their own scale (a first AdamW step and
    # the global-norm clip are blind to a common factor)
    local = [4 * i + 2 * grid.data_index + j for i in (0, 1) for j in (0, 1)]
    accum = TrainingConfig(**ref["train_kw"], grad_accum=2, grad_clip_norm=1e6)
    trainer = train.Trainer(model(), _Loader(), _Loader(), config=accum, mesh=grid,
                            checkpoint_dir=ref["tmp"], seed=0)
    trainer.train_step(trainer.state, *(t[local] for t in batch))
    one = model()
    one_state = train.TrainState.create(one, accum, 1)
    train.make_train_step(one, grad_accum=2)(one_state, *batch)
    out["accum"] = {"grid": numpy_state(trainer.model.full_state_dict()),
                    "grid_grads": _full_grads(trainer.model),
                    "one": numpy_state(one.state_dict()),
                    "one_grads": {n: p.grad.numpy().copy() for n, p in one.named_parameters()}}

    # checkpoint on the grid, one more step; a fresh grid trainer resumed
    # from the checkpoint takes the same step
    trainer.save("latest", 0)
    out["saved"] = numpy_state(trainer.model.full_state_dict())
    second = [torch.from_numpy(a) for a in ref["batch2"]]
    trainer.train_step(trainer.state, *(t[local] for t in second))
    resumed = train.Trainer(model(), _Loader(), _Loader(), config=accum, mesh=grid,
                            checkpoint_dir=ref["tmp"], seed=0)
    resumed.resume("latest")
    resumed.train_step(resumed.state, *(t[local] for t in second))
    out["continued"] = numpy_state(trainer.model.full_state_dict())
    out["resumed"] = numpy_state(resumed.model.full_state_dict())
    out["resumed_step"] = (trainer.state.step, resumed.state.step)

    # the evaluator on the grid and in one process, on 20 samples in
    # batches of 8 (the last one padded)
    ds = DemoVQADataset(num_samples=20, image_size=cfg.image_size,
                        max_question_length=cfg.max_question_length,
                        vocab_size=cfg.vocab_size, num_answers=cfg.num_answers)
    loader = BatchLoader(ds, 8, drop_last=False)
    out["evaluate"] = (Evaluator(model(), mesh=grid).evaluate(loader),
                       Evaluator(model()).evaluate(loader))
    return out


def cli_checks(rank: int, world: int, tmp: str) -> dict:
    """On 4 ranks: the train CLI at --data-parallel 2 --model-parallel 2
    (tiny model, demo data), then the evaluator CLI on its checkpoint over
    the same grid."""
    from vqa_tpu_torch.training import evaluate, train

    seen = {}
    init = train.Trainer.__init__

    def spy(self, *args, **kwargs):
        init(self, *args, **kwargs)
        seen.update(mesh=self.mesh.shape, batch=self.train_loader.batch_size,
                    train=list(self.train_loader.indices), val=list(self.val_loader.indices),
                    heads=self.model.fusion.cross_attention.layers[0].cross_attention.num_heads)

    train.Trainer.__init__ = spy
    grid = ["--data-parallel", "2", "--model-parallel", "2", "--device", "cpu"]
    logger = train.main(["--tiny", "--demo", "--epochs", "1", "--batch-size", "8",
                         "--subset-size", "32", "--checkpoint-dir", tmp] + grid)
    train.Trainer.__init__ = init
    results = evaluate.main(["--checkpoint-dir", tmp, "--demo", "--batch-size", "8",
                             "--max-samples", "20", "--output-dir", f"{tmp}/eval"] + grid)
    return dict(seen, history=logger.history, evaluate=results)


def resumed_moments(rank: int, world: int, base: str, name: str) -> dict:
    """A Trainer on a 1×``world`` grid resumed from the JAX trainer's tree
    ``<base>/<name>/``: this rank's AdamW moments by parameter name, its
    step, the grid's split dimensions and this rank's model index."""
    import json
    import os

    from vqa_tpu_torch.models import create_vqa_model
    from vqa_tpu_torch.parallel import create_mesh
    from vqa_tpu_torch.training.train import Trainer
    from vqa_tpu_torch.utils.config import TrainingConfig, model_config_from_dict

    with open(os.path.join(base, name + ".meta.json"), encoding="utf-8") as f:
        cfg = model_config_from_dict(json.load(f)["config"])
    mesh = create_mesh(1, world)
    model = create_vqa_model(config=cfg, device="cpu", seed=5)
    trainer = Trainer(model, [None] * 2, [], config=TrainingConfig(warmup_epochs=0), mesh=mesh,
                      checkpoint_dir=base, save_checkpoints=False)
    trainer.resume(name)
    opt = trainer.state.optimizer
    return {"moments": {n: {k: opt.state[p][k].numpy().copy() for k in ("exp_avg", "exp_avg_sq")}
                        for n, p in model.named_parameters()},
            "step": trainer.state.step, "splits": dict(model.tp_splits),
            "model_index": mesh.model_index}
