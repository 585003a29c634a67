"""CUDA graphs: capture, replay and the kernels' launch counts.

Counterpart of the JAX package's compiled programs: where JAX replays one
compiled XLA program per input shape (``jax.jit``), the port replays one
``torch.cuda.CUDAGraph``. A graph reads static input buffers and writes
static outputs, so a replay costs the host a few copies and one graph
launch where the eager call issues tens to hundreds of kernel launches.
Three users share this module: the serving engine (a graph per landing
slot of each batch bucket and replica, ``serving/graphs.py``, which feeds
its graphs itself), the trainer (one graph per train-step shape, per
augmentation shape and per validation shape, ``training/step_graph.py``)
and the evaluator (one per evaluation shape).

Before a capture the function runs eagerly on a side stream
(``on_side_stream``), so that every one-time step happens outside it: the
kernel library's build and load, cuDNN's and cuBLAS's handles and
algorithm choices, the SE launch plan's cache, the normalize constants,
an optimizer's state. The engine's warm forwards (``capture_bucket``) are
thrown away; ``GraphedCalls`` makes its warm calls real ones, whose
results are returned, because a train step cannot be run for nothing: it
moves BN's statistics, AdamW's state and the dropout generator. A failed
capture raises; nothing falls back to the eager call.

The graphs of one pool may share memory, so a graph's output may lie
where another graph of the pool keeps its intermediates: ``BucketGraph.run``
returns a copy of the output, queued on the stream right after the
replay, before any other replay of the pool.

The kernels' wrappers count a launch each time they run (``ops``). In a
capture they run once and launch nothing, and a replay launches without
running them. So a capture takes back the counts it added and keeps them
as the graph's ``launches``, and every replay adds them again.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from vqa_tpu_torch import ops

# eager calls of each input signature before its capture
WARM_FORWARDS = 2


def _map(fn, out):
    """``fn`` over the tensors of ``out``: a tensor, or a dict, list or
    tuple of them, rebuilt with the results."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, dict):
        return {k: _map(fn, v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_map(fn, v) for v in out)
    return out


def on_device(device: torch.device):
    """``device`` current inside the block, the caller's again after it (on
    the CPU, nothing)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class BucketGraph:
    """One captured call: the graph, its static inputs (``None`` where the
    call took ``None``) and output (a tensor, or a dict, list or tuple of
    them), and the kernel launches one replay makes ({name: n}, names of
    ``ops.KERNELS``)."""

    def __init__(self, graph, inputs: Sequence[Optional[torch.Tensor]], output: Any,
                 launches: Dict[str, int]):
        self.graph = graph
        self.inputs = list(inputs)
        self.output = output
        self.launches = dict(launches)
        self.device = next(t for t in self.inputs if t is not None).device

    def run(self, host_inputs: Sequence[Optional[torch.Tensor]]):
        """Copy ``host_inputs`` (tensors of the static inputs' shapes, on
        the host, pinned where the copy should not wait on the card, or on
        the device) into the static inputs, replay, and return a copy of
        the output on its device.

        The caller runs the replays of one pool one at a time (the engine
        under its replica's lock, the trainer in its one thread): a replay
        of this graph or of another graph of its pool between the replay
        and the copy out could overwrite the output."""
        with on_device(self.device):
            for static, t in zip(self.inputs, host_inputs):
                if static is not None:
                    static.copy_(t, non_blocking=True)
            self.graph.replay()
            ops.add_launch_counts(self.launches)
            return _map(torch.Tensor.clone, self.output)


def capture(fn: Callable, inputs: Sequence[Optional[torch.Tensor]], pool,
            generators: Sequence[torch.Generator] = ()) -> BucketGraph:
    """Capture ``fn(*inputs)`` into ``pool`` (a ``torch.cuda.graph_pool_handle``)
    on the inputs' device, with ``generators`` (custom CUDA generators that
    ``fn`` draws from; the default one is always registered) registered,
    so that each replay draws from their state at the replay. The capture
    executes nothing; its launch counts are taken back."""
    device = next(t for t in inputs if t is not None).device
    with torch.cuda.device(device):
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        try:
            with torch.cuda.graph(graph, pool=pool):
                output = fn(*inputs)
        finally:
            after = ops.launch_counts()
            captured = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            ops.add_launch_counts({k: -n for k, n in captured.items()})
    return BucketGraph(graph, inputs, output, captured)


def on_side_stream(fn: Callable, args: Sequence[Optional[torch.Tensor]]):
    """``fn(*args)``, on a side stream of the arguments' device where that
    is the card (a capture's warm calls must not run on the stream that
    captures). The current stream waits for the side stream; the outputs,
    made on the side stream, are marked as used on the current one, where
    the caller frees them."""
    device = next(a for a in args if a is not None).device
    if device.type != "cuda":
        return fn(*args)
    with torch.cuda.device(device):
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = fn(*args)
        current.wait_stream(side)
        _map(lambda t: t.record_stream(current), out)
    return out


def capture_bucket(forward: Callable, inputs: Sequence[torch.Tensor], pool) -> BucketGraph:
    """Warm ``forward(*inputs)`` up (``WARM_FORWARDS`` calls whose results
    are dropped: the forward has no side effects), then capture it into
    ``pool`` on the inputs' device."""
    for _ in range(WARM_FORWARDS):
        on_side_stream(forward, inputs)
    return capture(forward, inputs, pool)


def signature(args: Sequence[Optional[torch.Tensor]]) -> tuple:
    """The input signature a graph is captured for: each argument's shape,
    dtype and device (``None`` stays ``None``)."""
    return tuple(None if a is None else (tuple(a.shape), a.dtype, a.device) for a in args)


class GraphedCalls:
    """``fn(*args)`` (tensors or ``None``) as one CUDA graph per input
    signature, as ``jax.jit`` compiles one program per shape. The first
    ``WARM_FORWARDS`` calls of a signature run ``fn`` eagerly on a side
    stream; they are real calls, and their results are returned. The next
    call captures ``fn`` on a copy of its arguments (the static inputs)
    and replays it; every later call of that signature replays. Each replay returns a copy
    of the output (``BucketGraph.run``). The graphs share one memory pool
    and run one at a time, from one thread.

    ``generators`` are the custom CUDA generators ``fn`` draws from,
    registered with each graph (the caller seeds them before each call).
    ``last`` is the graph the latest call replayed (``None`` after an
    eager call); ``eager_calls`` and ``replays`` count the calls."""

    def __init__(self, fn: Callable, generators: Sequence[torch.Generator] = ()):
        self.fn = fn
        self.generators = tuple(generators)
        self.graphs: Dict[tuple, BucketGraph] = {}
        self.warm_calls: Dict[tuple, int] = {}
        self.pool = None
        self.last: Optional[BucketGraph] = None
        self.eager_calls = self.replays = 0

    def __call__(self, *args):
        key = signature(args)
        graph = self.graphs.get(key)
        if graph is None:
            if self.warm_calls.get(key, 0) < WARM_FORWARDS:
                self.warm_calls[key] = self.warm_calls.get(key, 0) + 1
                self.eager_calls += 1
                self.last = None
                return on_side_stream(self.fn, args)
            static = [None if a is None else a.detach().clone() for a in args]
            device = next(a for a in static if a is not None).device
            if self.pool is None and device.type == "cuda":
                with torch.cuda.device(device):
                    self.pool = torch.cuda.graph_pool_handle()
            graph = self.graphs[key] = capture(self.fn, static, self.pool, self.generators)
        self.replays += 1
        self.last = graph
        return graph.run(args)
