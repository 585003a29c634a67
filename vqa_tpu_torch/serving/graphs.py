"""The serving forward as one CUDA graph per batch bucket and replica.

Counterpart of the JAX engine's "ONE compiled XLA program per batch
bucket" (``vqa_tpu/serving/engine.py:9-10``, the jitted ``forward`` at
``:168-174``): where JAX replays one compiled program per bucket, the port
replays one ``torch.cuda.CUDAGraph``. Each graph holds normalize → forward
→ softmax for one bucket's rows on one replica's device. It reads static
input buffers (uint8 pixels, token ids, mask) and writes a static
probability buffer, so a replay costs the host a few copies and one graph
launch where the eager forward issues several hundred kernel launches.

Capture (``capture_replica``): for each bucket, largest first, the forward
runs eagerly on a side stream (``WARM_FORWARDS`` times), so that every
one-time step happens before the capture: the kernel library's build and
load, cuDNN's and cuBLAS's handles and algorithm choices, the SE launch
plan's cache, the normalize constants. Then it is captured into the
replica's one memory pool, which its bucket graphs share. A graph's
output may then lie where another graph of the pool keeps its
intermediates, so the caller runs copy in → replay → copy out of one
replica's graphs under one lock: the copy out is queued before any other
replay of the pool, and the device's stream runs them in that order. A
failed capture raises; nothing falls back to the eager forward.

The kernels' wrappers count a launch each time they run (``ops``). In a
capture they run once and launch nothing, and a replay launches without
running them. So a capture takes back the counts it added and keeps them
as the graph's ``launches``, and every replay adds them again.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Sequence

import torch

from vqa_tpu_torch import ops

# eager forwards of each bucket before its capture
WARM_FORWARDS = 2


class BucketGraph:
    """One captured forward: the graph, its static inputs and output, and
    the kernel launches one replay makes ({name: n}, names of
    ``ops.KERNELS``)."""

    def __init__(self, graph, inputs: Sequence[torch.Tensor], output: torch.Tensor,
                 launches: Dict[str, int]):
        self.graph = graph
        self.inputs = list(inputs)
        self.output = output
        self.launches = dict(launches)

    def run(self, host_inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Copy ``host_inputs`` (host tensors of the static inputs' shapes,
        pinned where the copy should not wait on the card) into the static
        inputs, replay, and return a copy of the output on its device.

        The caller holds its replica's lock from the copy in to the copy
        out: a replay of this graph or of another graph of its pool in
        between could overwrite the output."""
        device = self.output.device
        with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
            for static, t in zip(self.inputs, host_inputs):
                static.copy_(t, non_blocking=True)
            self.graph.replay()
            ops.add_launch_counts(self.launches)
            return self.output.clone()


def capture_bucket(forward: Callable, inputs: Sequence[torch.Tensor], pool) -> BucketGraph:
    """Warm ``forward(*inputs)`` up on a side stream, then capture it into
    ``pool`` (a ``torch.cuda.graph_pool_handle``) on the inputs' device."""
    device = inputs[0].device
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARM_FORWARDS):
                forward(*inputs)
        torch.cuda.current_stream().wait_stream(side)
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=pool):
                output = forward(*inputs)
        finally:
            after = ops.launch_counts()
            captured = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            ops.add_launch_counts({k: -n for k, n in captured.items()})
    return BucketGraph(graph, inputs, output, captured)


def capture_replica(forward: Callable, inputs: Dict[int, Sequence[torch.Tensor]]
                    ) -> Dict[int, BucketGraph]:
    """One graph per bucket of ``inputs`` ({bucket: static inputs}, all on
    one device), sharing one memory pool, the largest bucket first so that
    the others fit in the blocks it frees."""
    device = next(iter(inputs.values()))[0].device
    with torch.cuda.device(device):
        pool = torch.cuda.graph_pool_handle()
    return {b: capture_bucket(forward, inputs[b], pool)
            for b in sorted(inputs, reverse=True)}
