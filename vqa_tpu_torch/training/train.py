"""Training loop: AdamW with the JAX package's warmup-cosine schedule.

Counterpart of ``vqa_tpu/training/train.py``, with the same semantics — CE
loss (optional label smoothing), AdamW lr 1e-4 wd 0.01 with linear warmup
and cosine decay to 1e-6 (per step, or per epoch), global-norm clip 1.0,
gradient accumulation over microbatches, per-epoch validation with
per-question-type accuracy, best-model tracking, early stop, a checkpoint
every ``checkpoint_every`` epochs and a final ``latest``, resume, and
SIGTERM routed to an ``interrupted`` save, activation recomputation
(``remat``) and a NaN check (``debug_nans``) — on one CUDA device, or over
a (data, model) grid of ranks, one process per card.

The CLI's dtype policy is the JAX trainer's with the card in the TPU's
place (``vqa_tpu/training/train.py:983``): the model computes in bf16 when
``use_bf16`` (the default) and the device is the card, in f32 with
``--no-bf16`` or on the CPU. The Trainer takes the model as it is built
(``create_vqa_model(..., dtype=)``). In bf16 the parameters, the gradients
that the clip and AdamW see, the optimizer state, BN's running statistics
and the checkpoints stay f32, as in JAX (``models/layers.py``). f32 runs
with TF32 off.

Where the two packages' mechanics differ:

- the optimizer is ``torch.optim.AdamW`` over ``model.parameters()``;
  buffers (BN running statistics, the ``pe`` table) are not decayed,
  exactly as optax's unmasked ``adamw`` leaves out ``batch_stats``. The
  learning rate of step t is set to ``schedule(t)`` before the update, as
  optax evaluates its schedule at the update count. On the card AdamW is
  ``capturable`` and its learning rate a tensor there, written in place
  before each step, so that a CUDA graph of the step reads the current
  rate; on the CPU it is a Python float. Checkpoints hold the CPU's form
  either way, and resume in either;
- on the card each train step, each device augmentation and each
  validation forward is the replay of a CUDA graph, one per batch shape,
  as JAX runs one compiled program per step (``training/step_graph.py``,
  which also states the eager rule: the CPU, ``debug_nans`` and gloo
  process groups run eagerly);
- clipping is done by hand, the optax way: the gradients stay as they are
  when their global norm is below the bound and become ``g / norm * bound``
  otherwise (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm);
- dropout draws from torch's generator, seeded from ``seed`` when the
  Trainer is built; device augmentation draws from a ``torch.Generator``
  on the card, seeded per (seed, epoch, step);
- a train step runs the model in training mode, where the backbone, SE
  and cross-attention take their plain paths, as the JAX model's training
  path does: no kernel of ``vqa_tpu_torch.ops`` launches. Validation runs
  in eval mode, through the stem, SE and cross-attention kernels;
- ``remat`` is non-reentrant ``torch.utils.checkpoint`` where JAX takes
  ``jax.checkpoint``: ``"full"`` one segment over the forward and the
  loss, ``"stages"`` segments that the model cuts at the stem's and each
  stage's output (``VQAModel.forward(segment=)``; JAX's
  ``save_only_these_names("resnet_stem", "resnet_stage1".."4")``:
  everything else, text encoder, fusion and head included, is
  recomputed; the [B, answers] logits are kept, where JAX recomputes the
  loss from them too). The recomputation replays the dropout masks
  (``preserve_rng_state``) and leaves BN's running statistics alone
  (``cnn_backbone.recomputing``), as JAX drops its recomputed batch_stats;
- ``debug_nans`` stands for ``jax_debug_nans``: the forward and backward
  run under ``torch.autograd.set_detect_anomaly`` (the backward names the
  op that made a NaN), and the loss and the gradients' global norm are
  checked once per step before the update; either raises
  ``FloatingPointError``, which the Trainer tags with the epoch and step.

- multi-device (``vqa_tpu_torch.parallel``): where JAX runs one program
  over a mesh and GSPMD inserts the collectives, the port runs one process
  per card over a (data, model) grid (``Trainer(mesh=, mesh_config=)``,
  the auto grid sized by the global batch as JAX's). The model is placed
  on it by ``shard_model`` (tensor-parallel blocks split over the model
  group, BN's statistics over the data group's global batch); each data
  rank steps over its own slice of the global batch; once per optimizer
  step the gradients are averaged over the data group by one flat
  ``all_reduce`` per kind (replicated parameters over every rank, since
  under tensor parallelism each rank holds a part of their gradient; split
  ones over the data group); the clip sees the averaged gradient's global
  norm; train metrics and validation sums are summed over the data group;
  the checkpoint holds the full reference-layout state_dict and optimizer
  state, gathered from the shards, written by the primary between two
  barriers; tb scalars, the history, vocab and tokenizer are written by
  the primary.

    torchrun --nproc-per-node 2 -m vqa_tpu_torch.training.train --synthetic \
        --data-parallel 2                                   # two cards
    python -m vqa_tpu_torch.training.train --synthetic --epochs 12 --batch-size 64 \
        --subset-size 2000 --device-aug                    # on the card, bf16
    python -m vqa_tpu_torch.training.train --synthetic --no-bf16 --remat stages  # f32
    python -m vqa_tpu_torch.training.train --synthetic --tiny --device cpu --epochs 1
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint

from vqa_tpu_torch.data.pipeline import prefetch_to_device
from vqa_tpu_torch.data.preprocess import device_augment
from vqa_tpu_torch.models.cnn_backbone import recomputing
from vqa_tpu_torch.models.vqa_model import (
    VQAModel,
    create_vqa_model,
    resolve_device,
    shard_model,
)
from vqa_tpu_torch.parallel import distributed
from vqa_tpu_torch.parallel import mesh as mesh_lib
from vqa_tpu_torch.training import checkpoint as ckpt_lib
from vqa_tpu_torch.training import step_graph
from vqa_tpu_torch.utils.config import MeshConfig, ModelConfig, TrainingConfig
from vqa_tpu_torch.utils.metrics import MetricsLogger, topk_correct, topk_flags
from vqa_tpu_torch.utils.profiling import StepTimer, maybe_trace, step_annotation

Schedule = Callable[[int], float]


def _cosine(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule."""
    if decay_steps <= 0:
        return lambda step: init_value

    def schedule(step):
        count = min(step, decay_steps)
        decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * decay + alpha)

    return schedule


def make_schedule(cfg: TrainingConfig, steps_per_epoch: int) -> Schedule:
    """The learning rate of optimizer step t (0-based), as the JAX trainer's
    optax schedule gives it: ``"step"`` is
    ``optax.warmup_cosine_decay_schedule`` (linear from 0 over the warmup
    steps, then cosine over the rest of ``num_epochs`` down to ``min_lr``);
    ``"epoch"`` holds the rate within an epoch at
    min_lr + (lr − min_lr)·(1 + cos(π·e/num_epochs))/2, scaled by
    min((e + 1)/warmup_epochs, 1) during warmup."""
    warmup_steps = cfg.warmup_epochs * steps_per_epoch
    total_steps = max(cfg.num_epochs * steps_per_epoch, warmup_steps + 1)
    granularity = cfg.lr_schedule_granularity
    if granularity == "epoch":
        base = _cosine(cfg.learning_rate - cfg.min_lr, max(cfg.num_epochs, 1))
        spe = max(steps_per_epoch, 1)  # drop_last can make it 0

        def schedule(step):
            epoch = min(step // spe, cfg.num_epochs)
            lr = cfg.min_lr + base(epoch)
            if cfg.warmup_epochs:
                lr = lr * min((epoch + 1.0) / cfg.warmup_epochs, 1.0)
            return lr

        return schedule
    if granularity != "step":
        raise ValueError(
            f"lr_schedule_granularity must be 'step' or 'epoch', got {granularity!r}")
    peak = cfg.learning_rate
    init = 0.0 if warmup_steps else peak
    alpha = 0.0 if peak == 0 else cfg.min_lr / peak
    cosine = _cosine(peak, total_steps - warmup_steps, alpha)

    def schedule(step):
        if step < warmup_steps:
            frac = 1 - step / warmup_steps
            return (init - peak) * frac + peak
        return cosine(step - warmup_steps)

    return schedule


def make_optimizer(model: torch.nn.Module, cfg: TrainingConfig, steps_per_epoch: int
                   ) -> Tuple[torch.optim.AdamW, Schedule]:
    """AdamW over the model's parameters and the schedule that sets its
    learning rate step by step. On the card AdamW is ``capturable`` (its
    step count stays on the device) and its learning rate a tensor there,
    so that a CUDA graph can hold the update; on the CPU, where capturable
    AdamW refuses the parameters, it is the plain AdamW with a float rate."""
    schedule = make_schedule(cfg, steps_per_epoch)
    device = next(model.parameters()).device
    capturable = device.type == "cuda"
    lr = torch.tensor(schedule(0), dtype=torch.float32, device=device) if capturable \
        else schedule(0)
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=lr, betas=(cfg.adam_b1, cfg.adam_b2), eps=1e-8,
        weight_decay=cfg.weight_decay, capturable=capturable)
    return optimizer, schedule


def portable_optimizer_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """An AdamW state_dict in the form a checkpoint holds, whichever form
    wrote it: the plain AdamW's (a float learning rate, ``capturable``
    off, each step count a CPU tensor)."""
    return {
        "state": {i: {k: (v.detach().to("cpu", torch.float32) if k == "step" else v)
                      for k, v in st.items()} for i, st in state["state"].items()},
        "param_groups": [{**g, "lr": float(g["lr"]), "capturable": False}
                         for g in state["param_groups"]],
    }


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: Dict[str, Any]) -> None:
    """Load ``state`` (either form) into ``optimizer`` in its own form: its
    ``capturable`` flag and learning-rate object stay (the rate is written
    before the next step), and the step counts go where that form keeps
    them. A state tensor the optimizer already holds keeps its memory and
    takes the loaded value, since a captured train step's graph reads and
    writes that memory: a resume may come after the capture."""
    lrs = [g["lr"] for g in optimizer.param_groups]
    held = {p: dict(st) for p, st in optimizer.state.items()}
    state = portable_optimizer_state(state)
    optimizer.load_state_dict({**state, "param_groups": [
        {**saved, "capturable": own["capturable"]}
        for saved, own in zip(state["param_groups"], optimizer.param_groups)]})
    for g, lr in zip(optimizer.param_groups, lrs):
        g["lr"] = lr
    with torch.no_grad():
        for p, old in held.items():
            loaded = optimizer.state.get(p, {})
            for k, t in old.items():
                if torch.is_tensor(t) and torch.is_tensor(loaded.get(k)):
                    loaded[k] = t.copy_(loaded[k])


class TrainState:
    """Model, optimizer, schedule and the optimizer step count."""

    def __init__(self, model: VQAModel, optimizer: torch.optim.Optimizer,
                 schedule: Schedule, grad_clip_norm: float = 1.0):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.step = 0

    @classmethod
    def create(cls, model: VQAModel, cfg: TrainingConfig, steps_per_epoch: int
               ) -> "TrainState":
        optimizer, schedule = make_optimizer(model, cfg, steps_per_epoch)
        return cls(model, optimizer, schedule, cfg.grad_clip_norm)

    def clip_gradients(self) -> torch.Tensor:
        """Clip the gradients by their global norm (optax's rule); returns
        that norm (before clipping) on the device. Under tensor parallelism
        the split parameters' squares are summed over the model group, so
        the norm is the whole model's."""
        splits = self.model.tp_splits
        named = [(n, p.grad) for n, p in self.model.named_parameters() if p.grad is not None]
        grads = [g for n, g in named if n not in splits]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if splits:
            split = [g for n, g in named if n in splits]
            sq = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(split))) ** 2
            dist.all_reduce(sq, group=self.model.mesh.model_group)
            norm = torch.sqrt(norm ** 2 + sq)
            grads += split
        keep = norm < self.grad_clip_norm
        one = torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * self.grad_clip_norm))
        return norm

    def set_lr(self) -> None:
        """Set the learning rate to ``schedule(step)``: in place where it is
        a tensor (the card's capturable AdamW), so that a CUDA graph of the
        update reads it."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(lr)
            else:
                group["lr"] = lr

    def update(self) -> None:
        """Set the learning rate, update, count the step."""
        self.set_lr()
        self.optimizer.step()
        self.step += 1


REMAT_MODES = ("none", "full", "stages")


def _checkpointed(fn, *args):
    """``fn(*args)`` whose activations are recomputed in the backward, with
    the same dropout masks and without a second BN statistics update."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=True,
        context_fn=lambda: (contextlib.nullcontext(), recomputing()))


def _nan_error(run):
    """``run()`` under autograd's anomaly mode; its report of a NaN made in
    the backward is raised as ``FloatingPointError``."""
    with torch.autograd.set_detect_anomaly(True):
        try:
            return run()
        except RuntimeError as e:
            if "returned nan values" not in str(e):
                raise
            raise FloatingPointError(str(e)) from e


def reduce_gradients(model: VQAModel) -> None:
    """Average the gradients over the data group, in place: one flat
    ``all_reduce`` of the replicated parameters' gradients over every rank
    (under tensor parallelism each rank of a model group holds a part of
    them, ``models/layers.py``) and one of the split parameters' over the
    data group, each divided by the data-parallel degree. Nothing without
    a process group."""
    mesh = model.mesh
    if mesh is None or mesh.world_group is None:
        return
    named = [(n, p.grad) for n, p in model.named_parameters() if p.grad is not None]
    dp = mesh.data_parallel
    for grads, group in (([g for n, g in named if n not in model.tp_splits], mesh.world_group),
                         ([g for n, g in named if n in model.tp_splits], mesh.data_group)):
        if not grads or (group is mesh.data_group and dp == 1):
            continue
        flat = torch._utils._flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=group)
        if dp > 1:
            flat.div_(dp)
        torch._foreach_copy_(grads, torch._utils._unflatten_dense_tensors(flat, grads))


def make_train_step(model: VQAModel, grad_accum: int = 1, label_smoothing: float = 0.0,
                    remat: str = "none", debug_nans: bool = False):
    """``train_step(state, images, token_ids, mask, labels) → metrics``:
    forward in training mode, CE loss, backward, clip, AdamW update, BN's
    running statistics updated by the forward. The metrics (``loss``,
    ``correct1``, ``correct5``) stay on the device; the clipped gradients
    stay in each parameter's ``.grad`` until the next step.

    ``grad_accum > 1`` splits the batch into that many microbatches run
    one after another (BN normalising each with its own statistics and
    updating its running statistics once per microbatch), sums their
    gradients, divides by ``grad_accum`` and updates once; the loss is
    the mean of the microbatches' losses.

    ``remat`` is ``"none"``, ``"full"`` or ``"stages"`` (the module
    docstring); each microbatch is recomputed on its own. ``debug_nans``
    raises ``FloatingPointError`` on a non-finite loss or gradient before
    the update (one host synchronisation per step).

    On a model placed on a grid (``shard_model``) the batch is this rank's
    slice; each rank back-propagates its loss divided by the model degree
    (the ranks of a model group hold one replicated loss, and the
    collectives' backward sums over them), and ``reduce_gradients`` runs
    once per step, after the microbatches.

    ``train_step.body(state, images, token_ids, mask, labels)`` is the part
    of the step with no host work, which a CUDA graph holds
    (``step_graph.GraphedTrainStep``): from ``zero_grad`` to AdamW's update.
    ``train_step`` around it checks the batch, sets training mode and the
    learning rate, and counts the step."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat={remat!r}: expected 'none', 'full' or 'stages'")
    mp = model.mesh.model_parallel if model.mesh is not None else 1

    def backprop(loss):
        (loss / mp if mp > 1 else loss).backward()

    def loss_of(logits, labels):
        return F.cross_entropy(logits, labels.long(), label_smoothing=label_smoothing)

    def whole(images, token_ids, mask, labels):
        logits, _ = model(images, token_ids.long(), mask)
        return loss_of(logits, labels), logits

    def forward_loss(images, token_ids, mask, labels):
        if remat == "full":
            loss, logits = _checkpointed(whole, images, token_ids, mask, labels)
        else:  # with "stages" the model cuts its own segments
            logits, _ = model(images, token_ids.long(), mask,
                              segment=_checkpointed if remat == "stages" else None)
            loss = loss_of(logits, labels)
        return loss, logits.detach()

    def backward(images, token_ids, mask, labels):
        """Forward and backward of the batch → (loss, top-1 and top-5
        counts), the averaged gradients in each parameter's ``.grad``."""
        if grad_accum == 1:
            loss, logits = forward_loss(images, token_ids, mask, labels)
            backprop(loss)
            c1, c5 = topk_correct(logits, labels, k=5)
            return loss.detach(), c1, c5
        m = images.shape[0] // grad_accum
        loss = c1 = c5 = 0
        for i in range(grad_accum):
            part = slice(i * m, (i + 1) * m)
            mb_loss, logits = forward_loss(images[part], token_ids[part], mask[part],
                                           labels[part])
            backprop(mb_loss)
            f1, f5 = topk_correct(logits, labels[part], k=5)
            loss, c1, c5 = loss + mb_loss.detach(), c1 + f1, c5 + f5
        torch._foreach_div_([p.grad for p in model.parameters() if p.grad is not None],
                            grad_accum)
        return loss / grad_accum, c1, c5

    def check(images) -> None:
        n = images.shape[0]
        if n % grad_accum:
            raise ValueError(f"batch size {n} not divisible by grad_accum={grad_accum}")

    def body(state: TrainState, images, token_ids, mask, labels) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        batch = (images, token_ids, mask, labels)
        if debug_nans:
            loss, c1, c5 = _nan_error(lambda: backward(*batch))
        else:
            loss, c1, c5 = backward(*batch)
        reduce_gradients(model)
        norm = state.clip_gradients()
        if debug_nans:
            finite = torch.isfinite(torch.stack([loss.float(), norm])).tolist()
            if not all(finite):
                what = "loss" if not finite[0] else "gradient norm"
                raise FloatingPointError(
                    f"non-finite {what} (loss {float(loss)}, gradient norm {float(norm)}) "
                    f"at optimizer step {state.step}")
        state.optimizer.step()
        return {"loss": loss, "correct1": c1, "correct5": c5}

    def train_step(state: TrainState, images, token_ids, mask, labels) -> Dict[str, torch.Tensor]:
        check(images)
        model.train()
        state.set_lr()
        out = body(state, images, token_ids, mask, labels)
        state.step += 1
        return out

    train_step.body, train_step.check, train_step.model = body, check, model
    return train_step


def make_val_step(model: VQAModel, num_types: int = 0):
    """``val_step(images, token_ids, mask, labels, valid_mask, type_ids=None)``
    in eval mode, reduced to sums on the device with pad rows masked by
    ``valid_mask``. ``num_types > 0`` adds per-question-type (correct,
    total) sums over ``num_types + 1`` rows, the last being the loader's
    overflow bucket for unknown types, which is dropped."""

    @torch.inference_mode()
    def val_step(images, token_ids, mask, labels, valid_mask, type_ids=None):
        model.eval()
        logits, _ = model(images, token_ids.long(), mask)
        w = valid_mask.to(torch.float32)
        loss_vec = F.cross_entropy(logits, labels.long(), reduction="none")
        flags1, flags5 = topk_flags(logits, labels, k=5)
        out = {
            "loss_sum": (loss_vec * w).sum(),
            "correct1": (flags1 * w).sum(),
            "correct5": (flags5 * w).sum(),
            "n": w.sum(),
        }
        if num_types and type_ids is not None:
            idx = type_ids.long()
            zeros = torch.zeros(num_types + 1, dtype=torch.float32, device=w.device)
            out["type_correct"] = zeros.index_add(0, idx, flags1 * w)[:num_types]
            out["type_total"] = zeros.index_add(0, idx, w)[:num_types]
        return out

    return val_step


def make_eval_step(model: VQAModel):
    """``eval_step(images, token_ids, mask, labels)`` in eval mode:
    per-sample loss and correctness flags, predictions and logits."""

    @torch.inference_mode()
    def eval_step(images, token_ids, mask, labels):
        model.eval()
        logits, _ = model(images, token_ids.long(), mask)
        flags1, flags5 = topk_flags(logits, labels, k=5)
        return {
            "loss_vec": F.cross_entropy(logits, labels.long(), reduction="none"),
            "pred": logits.argmax(-1),
            "correct1": flags1,
            "correct5": flags5,
            "logits": logits,
        }

    return eval_step


def _augment_seed(seed: int, epoch: int, step: int, shard: int = 0) -> int:
    """A 63-bit generator seed per (seed, epoch, step), and per data shard
    beyond the first."""
    words = [seed, 0x5EED, epoch * 1_000_000 + step] + ([shard] if shard else [])
    state = np.random.SeedSequence(words)
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _sum_over(values, group, device) -> list:
    """``values`` (floats) summed over ``group`` (as they are without
    one)."""
    if group is None:
        return list(values)
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t, group=group)
    return t.tolist()


class Trainer:
    """Owns the model, optimizer state and steps; the JAX Trainer's
    contract on the model's device, in the model's compute dtype, on this
    rank's cell of ``mesh`` (by default the grid ``mesh_config`` describes,
    its auto data degree clamped to divide the global batch: the loaders'
    per-rank batch times the data ranks). The loaders yield this rank's
    shard (``data.dataset.shard_for_process``). ``debug_nans`` makes every
    train step check its loss and gradients (``make_train_step``)."""

    def __init__(
        self,
        model: VQAModel,
        train_loader,
        val_loader,
        config: Optional[TrainingConfig] = None,
        mesh=None,
        mesh_config: Optional[MeshConfig] = None,
        checkpoint_dir: Optional[str] = None,
        save_checkpoints: bool = True,
        seed: int = 42,
        profile_dir: Optional[str] = None,
        run_meta: Optional[Dict[str, Any]] = None,
        log_dir: Optional[str] = None,
        debug_nans: bool = False,
    ):
        self.model = model
        self.cfg = config or TrainingConfig()
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.device = next(model.parameters()).device
        if mesh is None:
            mesh = model.mesh
        if mesh is None:
            local_bs = math.gcd(getattr(train_loader, "batch_size", 1),
                                getattr(val_loader, "batch_size", 1))
            mp = max((mesh_config or MeshConfig()).model_parallel, 1)
            global_bs = local_bs * max(distributed.process_count() // mp, 1)
            mesh = mesh_lib.mesh_from_config(mesh_config, batch_divisor=global_bs)
        if model.mesh is None:
            shard_model(model, mesh)
        elif model.mesh is not mesh:
            raise ValueError("the model is placed on another mesh")
        self.mesh = mesh
        # every data rank starts from its group's first rank's state
        mesh_lib.replicated(list(model.parameters()) + list(model.buffers()), mesh)
        if self.device.type == "cuda":
            # f32 is f32 throughout: TF32 would keep ~3 digits per conv and matmul
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.checkpoint_dir = checkpoint_dir
        self.save_checkpoints = save_checkpoints and checkpoint_dir is not None
        self.seed = seed
        # dropout's generator: one stream per data shard, shared by the
        # ranks of a model group (their replicated activations draw alike)
        torch.manual_seed(seed + mesh.data_index)

        steps_per_epoch = max(len(train_loader), 1)
        self.state = TrainState.create(model, self.cfg, steps_per_epoch)
        self.schedule = self.state.schedule
        # the eager step, kept as the yardstick of the graphed one
        self.eager_train_step = make_train_step(
            model, grad_accum=self.cfg.grad_accum, label_smoothing=self.cfg.label_smoothing,
            remat=self.cfg.remat, debug_nans=debug_nans)
        self.val_type_vocab = getattr(val_loader, "type_vocab", None)
        self._aug_generator = torch.Generator(device=self.device)
        # one CUDA graph per batch shape for each train step, augmentation
        # and validation forward, unless the eager rule says otherwise
        # (step_graph.eager_reason), decided here
        step_reason = step_graph.eager_reason(model, debug_nans)
        forward_reason = step_graph.eager_reason(model)
        self.train_step = self.eager_train_step if step_reason else \
            step_graph.GraphedTrainStep(self.eager_train_step, self.state)
        self._augment = step_graph.graphed(
            lambda pixels: device_augment(pixels, self._aug_generator,
                                          image_size=model.config.image_size),
            step_reason, generators=(self._aug_generator,))
        self.val_step = step_graph.graphed(make_val_step(
            model, num_types=len(self.val_type_vocab) if self.val_type_vocab else 0),
            forward_reason)
        if distributed.is_primary():
            print(f"[Trainer] train steps and device augmentation: "
                  f"{step_graph.describe(step_reason)}; validation forwards: "
                  f"{step_graph.describe(forward_reason)}")

        self.logger = MetricsLogger()
        self.start_epoch = 0
        self.best_val_accuracy = 0.0
        # a trace of the first trained epoch goes to profile_dir when set;
        # the fenced StepTimer runs only then, so the default path never
        # waits on the card per step
        self.profile_dir = profile_dir
        self.step_timer = StepTimer()
        # run provenance persisted into every checkpoint sidecar
        self.run_meta = dict(run_meta or {})
        from vqa_tpu_torch.utils.tb import maybe_scalar_writer

        self.scalar_writer = maybe_scalar_writer(log_dir if distributed.is_primary() else None)

    # ------------------------------------------------------------------
    def augment(self, pixels_u8: torch.Tensor, epoch: int, step: int) -> torch.Tensor:
        """Device augmentation of a uint8 batch, seeded per (epoch, step):
        on the card the replay of one CUDA graph per batch shape, which
        draws from the generator as seeded here."""
        self._aug_generator.manual_seed(
            _augment_seed(self.seed, epoch, step, self.mesh.data_index))
        return self._augment(pixels_u8)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        loss_sum, c1, c5, n = 0.0, 0, 0, 0
        device_metrics = []
        profiling = bool(self.profile_dir) and epoch == self.start_epoch
        step_no = 0
        for batch in prefetch_to_device(self.train_loader, self.device):
            bs = int(batch["answer"].shape[0])

            def dispatch(batch=batch, step_no=step_no):
                images = batch["image"]
                if images.dtype == torch.uint8:  # augmentation on the device
                    images = self.augment(images, epoch, step_no)
                with step_annotation("train", step_no):
                    return self.train_step(self.state, images, batch["token_ids"],
                                           batch["attention_mask"], batch["answer"])

            try:
                if profiling:
                    with self.step_timer.step(items=bs) as s:
                        s.result = m = dispatch()
                else:
                    m = dispatch()
            except FloatingPointError as e:
                raise FloatingPointError(f"epoch {epoch}, step {step_no}: {e}") from e
            device_metrics.append(m)
            # bound the queue of launched steps: fetch the loss of the step
            # `depth` back, so the host runs at most `depth` steps ahead
            depth = 4
            if len(device_metrics) >= depth:
                float(device_metrics[-depth]["loss"])
            n += bs
            step_no += 1
        for m in device_metrics:  # one fetch per step at the epoch's end
            loss_sum += float(m["loss"])
            c1 += int(m["correct1"])
            c5 += int(m["correct5"])
        steps = max(len(device_metrics), 1)
        if self.mesh.data_parallel > 1:  # each rank's loss is its shard's mean
            loss_sum, c1, c5, n = _sum_over([loss_sum, c1, c5, n], self.mesh.data_group,
                                            self.device)
            loss_sum /= self.mesh.data_parallel
        return {
            "train_loss": loss_sum / steps,
            "train_top1": c1 / max(n, 1),
            "train_top5": c5 / max(n, 1),
        }

    def validate(self) -> Dict[str, float]:
        # sums reduced on the device per batch and added up there, fetched
        # once at the end; leaving training mode here refreshes the bf16
        # weight copies that the validation graphs read
        self.model.eval()
        use_types = bool(self.val_type_vocab)
        totals: Dict[str, torch.Tensor] = {}
        for batch in prefetch_to_device(self.val_loader, self.device):
            out = self.val_step(batch["image"], batch["token_ids"], batch["attention_mask"],
                                batch["answer"], batch["valid_mask"],
                                batch.get("type_ids") if use_types else None)
            totals = {k: totals[k] + v if k in totals else v for k, v in out.items()}
        loss_sum, c1, c5, n = (float(totals[k]) if k in totals else 0.0
                               for k in ("loss_sum", "correct1", "correct5", "n"))
        t_correct = t_total = 0.0
        if "type_correct" in totals:
            t_correct = totals["type_correct"].cpu().numpy()
            t_total = totals["type_total"].cpu().numpy()
        if self.mesh.data_parallel > 1:  # each rank validated its shard
            per_type = np.concatenate([t_correct, t_total]) if np.ndim(t_total) else []
            sums = _sum_over([loss_sum, c1, c5, n, *per_type], self.mesh.data_group,
                             self.device)
            loss_sum, c1, c5, n = sums[:4]
            if len(per_type):
                t_correct, t_total = np.split(np.asarray(sums[4:]), 2)
        n = max(n, 1)
        metrics = {"val_loss": loss_sum / n, "val_top1": c1 / n, "val_top5": c5 / n}
        if use_types and np.ndim(t_total):
            metrics["val_per_type"] = {
                qt: float(c) / float(t)
                for qt, c, t in zip(self.val_type_vocab, t_correct, t_total)
                if t > 0
            }
        return metrics

    # ------------------------------------------------------------------
    def _optimizer_state(self, full: bool, state: Optional[Dict[str, Any]] = None):
        """The optimizer's state_dict with each split parameter's moments
        gathered to full (``full``), or ``state``'s full moments cut to this
        rank's slices. AdamW keys its state by parameter position, which
        ``shard_model`` keeps."""
        splits = self.model.tp_splits
        state = state if state is not None else self.state.optimizer.state_dict()
        if not splits:
            return state
        mesh = self.mesh
        names = [n for n, _ in self.model.named_parameters()]
        moved = {}
        for idx, st in state["state"].items():
            dim = splits.get(names[idx])
            moved[idx] = st if dim is None else {
                k: ((mesh_lib.gather(v, dim, mesh.model_index, mesh.model_parallel,
                                     mesh.model_group) if full else
                     mesh_lib.split(v, dim, mesh.model_index, mesh.model_parallel))
                    if torch.is_tensor(v) and v.dim() else v)
                for k, v in st.items()}
        return {**state, "state": moved}

    def _payload(self) -> Dict[str, Any]:
        """The checkpoint: the reference-layout state_dict and optimizer
        state, gathered from the shards (every rank takes part)."""
        return {
            "model_state_dict": self.model.full_state_dict(),
            "optimizer_state_dict": portable_optimizer_state(self._optimizer_state(full=True)),
            "scheduler_step": self.state.step,
            "step": self.state.step,
        }

    def save(self, name: str, epoch: int) -> None:
        """Every rank gathers the payload; the primary writes it
        (``checkpoint.save_checkpoint``)."""
        if not self.save_checkpoints:
            return
        ckpt_lib.save_checkpoint(
            self.checkpoint_dir, name, self._payload(), self.model.config,
            {
                "epoch": epoch,
                "best_val_accuracy": self.best_val_accuracy,
                "metrics_history": self.logger.to_dict(),
                **self.run_meta,
            },
        )

    def resume(self, name: str = "latest") -> None:
        """Restore weights, BN statistics, optimizer state, step, epoch and
        history from the port's checkpoint ``name`` or, where there is none,
        the JAX trainer's Orbax tree ``name/`` (optax's AdamW moments and
        counts as torch AdamW's state, ``checkpoint.load_training_checkpoint``),
        each rank taking its slices on a grid. Adam's count, the schedule's
        count and the step must agree; the learning rate is then
        ``schedule(step)``, written where a captured step reads it. A
        sidecar flagged ``model_only`` (weights without optimizer state)
        restores the weights and BN statistics and keeps the fresh
        optimizer."""
        names = [n for n, _ in self.model.named_parameters()]
        payload, _, meta = ckpt_lib.load_training_checkpoint(
            self.checkpoint_dir, name, names,
            self.state.optimizer.state_dict()["param_groups"], map_location=self.device)
        self.model.load_full_state_dict(payload["model_state_dict"])
        if meta.get("model_only", False):
            print("[Trainer] model-only checkpoint: optimizer starts fresh")
        else:
            state = payload["optimizer_state_dict"]
            step = int(payload["step"])
            adam = sorted({int(st["step"]) for st in state["state"].values()})
            schedule = int(payload.get("scheduler_step", step))
            if adam not in ([], [step]) or schedule != step:
                raise ValueError(f"checkpoint {name!r}: Adam's count {adam}, the schedule's "
                                 f"count {schedule} and step {step} disagree")
            load_optimizer_state(self.state.optimizer,
                                 self._optimizer_state(full=False, state=state))
            self.state.step = step
            self.state.set_lr()
        self.start_epoch = int(meta["epoch"]) + 1
        self.best_val_accuracy = float(meta["best_val_accuracy"])
        self.logger = MetricsLogger.from_dict(meta["metrics_history"])
        print(f"[Trainer] Resumed from epoch {meta['epoch']}")

    # ------------------------------------------------------------------
    def train(self, patience: Optional[int] = None) -> MetricsLogger:
        patience = patience if patience is not None else self.cfg.early_stop_patience
        epochs_no_improve = 0
        epoch = self.start_epoch
        # SIGTERM takes the KeyboardInterrupt path (an `interrupted` save);
        # only the main thread may set signal handlers
        prev_handler = None
        if threading.current_thread() is threading.main_thread():
            def _on_sigterm(signum, frame):
                raise KeyboardInterrupt("SIGTERM")

            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        try:
            for epoch in range(self.start_epoch, self.cfg.num_epochs):
                t0 = time.time()
                # (seed, epoch)-pinned shuffle: the same order whether the
                # run got here uninterrupted or resumed
                if hasattr(self.train_loader, "set_epoch"):
                    self.train_loader.set_epoch(epoch)
                trace_dir = self.profile_dir if epoch == self.start_epoch else None
                with maybe_trace(trace_dir):
                    train_metrics = self.train_epoch(epoch)
                if trace_dir:
                    print(f"[Trainer] trace → {trace_dir}; "
                          f"step time {self.step_timer.summary()}")
                val_metrics = self.validate()
                lr = float(self.schedule(self.state.step))
                metrics = {**train_metrics, **val_metrics, "lr": lr}
                # per-type accuracy is a nested dict: history and the scalar
                # log get namespaced scalars ("val_per_type/<type>")
                scalars = {k: v for k, v in metrics.items() if isinstance(v, (int, float))}
                flat = dict(scalars)
                for k, v in metrics.items():
                    if isinstance(v, dict):
                        flat.update({f"{k}/{qt}": acc for qt, acc in v.items()})
                self.logger.log(epoch, flat)
                if self.scalar_writer is not None:
                    self.scalar_writer.log_scalars(epoch, flat)
                dt = time.time() - t0
                if distributed.is_primary():
                    print(f"[Trainer] epoch {epoch}: "
                          + " ".join(f"{k}={v:.4f}" for k, v in scalars.items())
                          + f" ({dt:.1f}s)")

                improved = val_metrics["val_top1"] > self.best_val_accuracy
                if improved:
                    self.best_val_accuracy = val_metrics["val_top1"]
                    epochs_no_improve = 0
                    self.save("latest", epoch)
                    if self.save_checkpoints:
                        ckpt_lib.save_best_copy(self.checkpoint_dir)
                else:
                    epochs_no_improve += 1
                if (epoch + 1) % self.cfg.checkpoint_every == 0 and not improved:
                    self.save("latest", epoch)
                if epochs_no_improve >= patience:
                    print(f"[Trainer] early stop after {patience} stale epochs")
                    break
            # a completed run always leaves a resumable checkpoint
            if self.cfg.num_epochs > self.start_epoch:
                self.save("latest", epoch)
        except KeyboardInterrupt:
            print("[Trainer] interrupted — saving checkpoint")
            self.save("interrupted", epoch)
            raise
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
            if self.scalar_writer is not None:
                self.scalar_writer.close()
        return self.logger


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def compute_dtype(use_bf16: bool, device: torch.device) -> torch.dtype:
    """The JAX trainer's policy (``vqa_tpu/training/train.py:983``), the card
    in the TPU's place: bf16 where asked for and the device is the card."""
    return torch.bfloat16 if use_bf16 and device.type == "cuda" else torch.float32


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train the VQA model (PyTorch/CUDA port)")
    p.add_argument("--questions", default=None)
    p.add_argument("--annotations", default=None)
    p.add_argument("--images-dir", default=None)
    p.add_argument("--subset-size", type=int, default=25000)
    p.add_argument("--embed-dim", type=int, default=256)
    p.add_argument("--num-answers", type=int, default=1000)
    p.add_argument("--no-spatial", action="store_true",
                   help="ablation: disable spatial attention only")
    p.add_argument("--no-attention", action="store_true",
                   help="ablation: disable SE and spatial attention")
    p.add_argument("--stem-s2d", action="store_true",
                   help="space-to-depth stem conv plan (same parameters, same math; "
                        "models/cnn_backbone.py StemConv)")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--warmup-epochs", type=int, default=None,
                   help="linear-warmup epochs before the cosine decay (default: "
                        "TrainingConfig.warmup_epochs=2; 0 = cosine only)")
    p.add_argument("--lr-schedule", choices=("step", "epoch"), default=None,
                   help="cosine granularity: 'step' decays every optimizer step "
                        "(default), 'epoch' once per epoch")
    p.add_argument("--min-lr", type=float, default=None,
                   help="cosine floor (default: TrainingConfig.min_lr=1e-6)")
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--num-workers", type=int, default=0,
                   help="threads decoding/augmenting samples per batch (0 = inline)")
    p.add_argument("--label-smoothing", type=float, default=0.0,
                   help="uniform label smoothing on the CE loss (0 = plain CE)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="microbatches per optimizer step, gradients averaged")
    p.add_argument("--remat", choices=REMAT_MODES, default="none",
                   help="activation recomputation in the backward: 'stages' keeps only "
                        "the stem's and the CNN stages' outputs, 'full' recomputes the "
                        "whole forward")
    p.add_argument("--resume", default=None, metavar="NAME",
                   help="resume from NAME in --checkpoint-dir: the port's NAME.pt, else the "
                        "JAX trainer's Orbax tree NAME/ (weights, AdamW's moments, step and "
                        "schedule); the next save of NAME replaces that tree by NAME.pt")
    p.add_argument("--demo", action="store_true", help="random demo data")
    p.add_argument("--synthetic", action="store_true",
                   help="learnable colored-shapes data (data/synthetic.py)")
    p.add_argument("--spatial", action="store_true",
                   help="with --synthetic: mix in grid-localized questions "
                        "(recorded in the checkpoint sidecar)")
    p.add_argument("--tiny", action="store_true", help="tiny model + data for smoke runs")
    p.add_argument("--no-bf16", action="store_true",
                   help="compute in f32 on the card (default there: bf16; the CPU is "
                        "always f32)")
    p.add_argument("--no-save", action="store_true")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the first trained epoch here")
    p.add_argument("--log-dir", default=None,
                   help="per-epoch scalars (TensorBoard events, or scalars.jsonl)")
    p.add_argument("--debug-nans", action="store_true",
                   help="stop at the first non-finite loss or gradient with "
                        "FloatingPointError (anomaly mode names the backward op; one host "
                        "sync per step)")
    p.add_argument("--device-aug", action="store_true",
                   help="augment on the device (uint8 batches from the loader, "
                        "crop/flip/jitter on the card)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on; the CPU only when asked (--device cpu)")
    add_parallel_args(p)
    return p.parse_args(argv)


def add_parallel_args(p: argparse.ArgumentParser) -> None:
    """The JAX CLIs' mesh and multi-process flags (``MeshConfig``;
    ``parallel.distributed.initialize``)."""
    p.add_argument("--data-parallel", type=int, default=None,
                   help="ranks on the data axis of the grid (-1 = all remaining; "
                        "default: MeshConfig)")
    p.add_argument("--model-parallel", type=int, default=None,
                   help="ranks on the model (tensor-parallel) axis of the grid")
    p.add_argument("--coordinator", default=None,
                   help="rendezvous address host:port of a multi-process run (torchrun's "
                        "MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK/LOCAL_RANK are honoured)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def mesh_config_from_args(args) -> Optional[MeshConfig]:
    """A per-run MeshConfig when either degree is given, else None (the
    default grid)."""
    if args.data_parallel is None and args.model_parallel is None:
        return None
    return MeshConfig(
        data_parallel=args.data_parallel if args.data_parallel is not None else -1,
        model_parallel=args.model_parallel if args.model_parallel is not None else 1)


def main(argv=None):
    args = parse_args(argv)
    # a launched rank joins its process group (and binds its card) first
    with distributed.session(coordinator_address=args.coordinator,
                             num_processes=args.num_processes, process_id=args.process_id,
                             device=args.device):
        return _train(args)


def _train(args):
    from vqa_tpu_torch.data.dataset import create_demo_loaders, create_train_val_loaders
    from vqa_tpu_torch.utils.config import PATHS

    # the grid, its auto data degree clamped by the global batch; each data
    # rank's loaders yield its slice of the global batch
    mesh = mesh_lib.mesh_from_config(mesh_config_from_args(args),
                                     batch_divisor=args.batch_size)
    device = resolve_device(args.device)  # no card and no --device cpu: raise
    local_bs = distributed.local_batch_size(args.batch_size, shards=mesh.data_parallel)
    primary = distributed.is_primary()

    sched_overrides = {}
    if args.warmup_epochs is not None:
        sched_overrides["warmup_epochs"] = args.warmup_epochs
    if args.min_lr is not None:
        sched_overrides["min_lr"] = args.min_lr
    if args.lr_schedule is not None:
        sched_overrides["lr_schedule_granularity"] = args.lr_schedule
    tcfg = TrainingConfig(
        num_samples=args.subset_size,
        batch_size=local_bs,
        learning_rate=args.lr,
        weight_decay=args.weight_decay,
        num_epochs=args.epochs,
        early_stop_patience=args.patience,
        grad_accum=args.grad_accum,
        remat=args.remat,
        label_smoothing=args.label_smoothing,
        use_bf16=not args.no_bf16,
        seed=args.seed,
        **sched_overrides,
    )
    if tcfg.batch_size % tcfg.grad_accum:
        raise SystemExit(f"--batch-size per data rank ({tcfg.batch_size}) must be divisible "
                         f"by --grad-accum ({tcfg.grad_accum})")

    if args.tiny:
        from vqa_tpu_torch.utils.config import tiny_model_config

        mcfg = tiny_model_config()
    else:
        mcfg = ModelConfig(embed_dim=args.embed_dim, num_answers=args.num_answers)

    import dataclasses

    tokenizer = answer_vocab = None
    run_meta: Dict[str, Any] = {}
    if args.synthetic:
        from vqa_tpu_torch.data.synthetic import create_synthetic_loaders

        syn_samples = min(tcfg.num_samples, 20000)
        # persisted so an evaluation rebuilds the exact val split
        run_meta["synthetic"] = {
            "num_samples": syn_samples, "seed": tcfg.seed, "spatial": bool(args.spatial)}
        train_loader, val_loader, tokenizer, answer_vocab = create_synthetic_loaders(
            num_samples=syn_samples, batch_size=tcfg.batch_size,
            eval_batch_size=tcfg.eval_batch_size, image_size=mcfg.image_size,
            max_question_length=mcfg.max_question_length, device_augment=args.device_aug,
            seed=tcfg.seed, num_workers=args.num_workers, spatial=args.spatial)
        mcfg = dataclasses.replace(mcfg, vocab_size=tokenizer.vocab_size,
                                   num_answers=answer_vocab.num_answers)
    use_demo = args.demo and not args.synthetic
    if not use_demo and not args.synthetic:
        try:
            train_loader, val_loader, tokenizer, answer_vocab = create_train_val_loaders(
                args.questions or PATHS.questions_path,
                args.annotations or PATHS.annotations_path,
                args.images_dir or PATHS.images_path,
                batch_size=tcfg.batch_size, eval_batch_size=tcfg.eval_batch_size,
                max_samples=tcfg.num_samples, max_question_length=mcfg.max_question_length,
                vocab_size=mcfg.vocab_size, num_answers=mcfg.num_answers,
                image_size=mcfg.image_size, seed=tcfg.seed, device_augment=args.device_aug,
                num_workers=args.num_workers)
            mcfg = dataclasses.replace(mcfg, vocab_size=tokenizer.vocab_size)
        except FileNotFoundError as e:
            print(f"[Trainer] data not found ({e}); falling back to demo data")
            use_demo = True
    if use_demo:
        train_loader, val_loader = create_demo_loaders(
            batch_size=tcfg.batch_size, eval_batch_size=tcfg.eval_batch_size,
            num_samples=min(tcfg.num_samples, 256), image_size=mcfg.image_size,
            max_question_length=mcfg.max_question_length, vocab_size=mcfg.vocab_size,
            num_answers=mcfg.num_answers, seed=tcfg.seed, num_workers=args.num_workers)

    if mesh.data_parallel > 1:
        # disjoint equal-length sample shards per data rank; the ranks of a
        # model group read the same one
        from vqa_tpu_torch.data.dataset import shard_for_process

        train_loader = shard_for_process(train_loader, mesh.data_index, mesh.data_parallel)
        val_loader = shard_for_process(val_loader, mesh.data_index, mesh.data_parallel)

    dtype = compute_dtype(tcfg.use_bf16, device)
    if primary:
        print(f"[Trainer] compute dtype {str(dtype).replace('torch.', '')} on {device}"
              + (" (--no-bf16)" if not tcfg.use_bf16 else "")
              + (f", mesh {mesh.data_parallel}×{mesh.model_parallel} over "
                 f"{distributed.process_count()} process(es), {dist.get_backend()}"
                 if dist.is_initialized() else ""))
    ablation = {"use_spatial_attention": False} if args.no_spatial else {}
    model = create_vqa_model(config=mcfg, use_attention=False if args.no_attention else None,
                             device=device, seed=tcfg.seed, dtype=dtype,
                             stem_s2d=args.stem_s2d, **ablation)

    ckpt_dir = args.checkpoint_dir or PATHS.checkpoint_dir
    if not args.no_save and primary:
        if tokenizer is not None:
            tokenizer.save(os.path.join(ckpt_dir, "tokenizer.json"))
        if answer_vocab is not None:
            answer_vocab.save(os.path.join(ckpt_dir, "answer_vocab.json"))

    trainer = Trainer(model, train_loader, val_loader, config=tcfg, mesh=mesh,
                      checkpoint_dir=ckpt_dir,
                      save_checkpoints=not args.no_save, seed=tcfg.seed,
                      profile_dir=args.profile_dir, run_meta=run_meta, log_dir=args.log_dir,
                      debug_nans=args.debug_nans)
    if args.resume:
        trainer.resume(args.resume)
    logger = trainer.train(patience=args.patience)

    if not args.no_save and primary:
        hist_path = os.path.join(ckpt_dir, "training_history.json")
        logger.save(hist_path)
        print(f"[Trainer] history → {hist_path}")
    return logger


if __name__ == "__main__":
    main()
