"""The JAX trainer's compiled programs as CUDA graphs.

The JAX trainer keeps "ONE jitted XLA program per step
(forward+loss+backward+update)" (``vqa_tpu/training/train.py:9``; the
train steps at ``:152`` and ``:184``), a jitted validation step (``:259``),
a jitted evaluation step (``:301``) and ``jax.jit(device_augment)``
(``:401``), each compiled once per input shape. The port replays one CUDA
graph per shape in their place (``utils/graphs.py:GraphedCalls``):

- ``GraphedTrainStep``: forward, CE loss, backward, the gradient
  ``all_reduce`` where there is one, clip, AdamW update and BN's running
  statistics in one graph (``make_train_step``'s ``body``). The learning
  rate is a tensor on the card that ``TrainState.set_lr`` writes before
  each replay (AdamW is ``capturable`` there, ``make_optimizer``). The
  first ``WARM_FORWARDS`` steps of each shape are the run's first real
  steps, run eagerly; then the capture, which executes nothing, and a
  replay for the batch the capture was given: a graphed run follows the
  same sequence of states as the eager one. Dropout draws from the default
  CUDA generator, which every replay reads and advances, so each replay
  draws fresh masks, the masks the eager step would draw from that state.
  ``remat`` is captured as it is: ``torch.utils.checkpoint`` replays its
  dropout masks inside the graph.
- device augmentation (``Trainer.augment``): its own graph, drawing from
  the trainer's generator, which is registered with the graph and seeded
  before each replay per (seed, epoch, step).
- the validation and evaluation forwards (``Trainer.validate``,
  ``Evaluator``): eval forwards through the stem, SE and cross-attention
  kernels, each graph in its own pool.

The eager rule (``eager_reason``), decided when the ``Trainer`` or
``Evaluator`` is built and logged: a model on the CPU runs eagerly (CUDA
graphs exist on the card only), so does a train step under ``debug_nans``
(anomaly mode and the per-step host check cannot be captured, just as
``jax_debug_nans`` de-optimises), and so does every step and forward over
a gloo process group (its collectives go through the host and cannot be
captured). NCCL groups, remat, ``grad_accum`` and f32 are captured. A
capture that fails raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from vqa_tpu_torch.utils.graphs import GraphedCalls


def eager_reason(model, debug_nans: bool = False) -> Optional[str]:
    """Why ``model``'s steps (``debug_nans``: a train step checked for
    NaNs) or forwards run eagerly, or ``None`` when they are graphed."""
    if next(model.parameters()).device.type != "cuda":
        return "a model on the CPU (CUDA graphs exist on the card only)"
    if debug_nans:
        return "--debug-nans (anomaly mode and the per-step host check cannot be captured)"
    mesh = model.mesh
    if mesh is not None and mesh.world_group is not None and \
            dist.get_backend(mesh.world_group) == "gloo":
        return "a gloo process group (its collectives cannot be captured)"
    return None


def graphed(fn, reason: Optional[str], **kw):
    """``fn`` as ``GraphedCalls`` (``kw`` its options), or ``fn`` itself
    where the eager rule gave a ``reason``."""
    return fn if reason else GraphedCalls(fn, **kw)


def describe(reason: Optional[str]) -> str:
    """The rule's verdict (``eager_reason``'s) for a log line."""
    return "one CUDA graph per batch shape" if reason is None else f"eager ({reason})"


class GraphedTrainStep:
    """``train_step(state, images, token_ids, mask, labels) → metrics`` of
    ``make_train_step`` (``step``) with its ``body`` replayed as one CUDA
    graph per batch shape, for ``state`` (the one ``TrainState`` it steps).
    Each call writes ``schedule(step)`` into the learning-rate tensor,
    replays (or, for the first ``WARM_FORWARDS`` steps of a shape, runs
    the body eagerly) and counts the step; the metrics are copies, and each
    parameter's ``.grad`` holds the step's clipped gradient, as after the
    eager step."""

    def __init__(self, step, state):
        self.step, self.state = step, state
        self.model = step.model
        self.calls = GraphedCalls(lambda *batch: step.body(state, *batch))
        self.params = list(self.model.parameters())
        # each graph's .grad tensors, which its replays write
        self._grads: Dict[object, list] = {}

    def __call__(self, state, images, token_ids, mask, labels) -> Dict[str, torch.Tensor]:
        if state is not self.state:
            raise ValueError("a graphed train step steps the TrainState it was built for")
        self.step.check(images)
        if not self.model.training:
            self.model.train()
        state.set_lr()
        out = self.calls(images, token_ids, mask, labels)
        state.step += 1
        graph = self.calls.last
        if graph is not None:
            grads = self._grads.setdefault(graph, [p.grad for p in self.params])
            if self.params[0].grad is not grads[0]:  # another shape or an eager step ran
                for p, g in zip(self.params, grads):
                    p.grad = g
        return out
