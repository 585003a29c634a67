"""The serving forward as CUDA graphs per batch bucket and replica, fed
through landing slots on a copy stream of the engine's own.

Counterpart of the JAX engine's "ONE compiled XLA program per batch
bucket" (``vqa_tpu/serving/engine.py:9-10``, the jitted ``forward`` at
``:168-174``): where JAX replays one compiled program per bucket, the port
replays a ``torch.cuda.CUDAGraph``. Each graph holds normalize → forward
→ softmax for one bucket's rows on one replica's device, reading static
input buffers (uint8 pixels, token ids, mask) and writing a static
probability buffer.

The inputs of a dispatch reach the card under the previous forward:

- each bucket of each replica has ``SLOTS`` landing slots on the device,
  and one graph captured per slot, whose static inputs are the slot;
- a dispatch copies its pinned host rows into the next slot on the
  replica's copy stream (``Streams.copy``) and records an event there;
  the graph of that slot replays on the compute stream once that event
  has passed, so the copy runs while the card is still on the forward
  queued before it;
- each slot graph ends with an event of its own, a node of the graph that
  every replay records again at no cost to the host. The copy into a slot
  waits for it, on the copy stream, where the slot's previous forward is
  still queued or running: ``SlottedGraph.feed`` returns 1 then, 0 where
  the slot was free;
- PyTorch's pinned host allocator releases each host block once the copy
  stream's work that read it has passed.

``VQAInference.load`` captures them with ``capture_replica``: for each
bucket, largest first, ``WARM_FORWARDS`` eager forwards on a side stream,
then the capture of each slot's graph into the replica's one memory pool,
which all its graphs share. The caller feeds and replays one replica's
graphs under one lock: a feed, then the replay of the slot it filled,
before the next feed of that bucket. The capture and the launch-count
bookkeeping are ``vqa_tpu_torch.utils.graphs``'s, shared with the trainer
and the evaluator, whose graphs take their inputs through
``BucketGraph.run``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from vqa_tpu_torch import ops
from vqa_tpu_torch.utils.graphs import (  # noqa: F401
    WARM_FORWARDS,
    BucketGraph,
    capture,
    capture_bucket,
    on_device,
)

# landing slots per bucket and replica: a copy lands while the forward of
# the other slot runs
SLOTS = 2


class Streams:
    """One replica's streams: ``compute``, the device's current stream when
    the engine loads (the graphs replay there), and ``copy``, the engine's
    own, where each dispatch's inputs are copied to the card. Made once,
    at load; a dispatch switches between them with ``torch.cuda.set_stream``
    (no ``current_stream`` query)."""

    def __init__(self, device: torch.device):
        with torch.cuda.device(device):
            self.compute = torch.cuda.current_stream()
            self.copy = torch.cuda.Stream()

    def to_copy(self) -> None:
        torch.cuda.set_stream(self.copy)

    def to_compute(self) -> None:
        torch.cuda.set_stream(self.compute)


class SlottedGraph:
    """One bucket's forward on one replica: a graph per landing slot (its
    static inputs are the slot), the replica's ``Streams``, and per slot an
    event recorded on the copy stream after the copy (``copied``) and one
    recorded by the slot's graph at its end (``free``). ``launches``: the
    kernel launches one replay makes."""

    def __init__(self, graphs: Sequence[BucketGraph], streams: Streams,
                 copied: Sequence, free: Sequence):
        self.graphs = list(graphs)
        self.streams = streams
        self.copied, self.free = list(copied), list(free)
        self.launches = self.graphs[0].launches
        self.slot = 0  # the slot the next feed fills
        # the output a replay copies out: a tensor, or a tuple of them
        # (a model with routed experts adds its routing counts)
        self._copy = (torch.Tensor.clone if isinstance(self.graphs[0].output, torch.Tensor)
                      else lambda out: tuple(t.clone() for t in out))

    def feed(self, host_inputs: Sequence[torch.Tensor]) -> int:
        """Queue the copy of ``host_inputs`` (tensors of the static inputs'
        shapes, pinned on the host) into the next slot, on the copy stream,
        after the slot's previous forward. Returns 1 where that forward had
        not finished (the copy stream waits for it), else 0. Leaves the
        compute stream current."""
        k = self.slot
        held = not self.free[k].query()
        s = self.streams
        s.to_copy()
        if held:
            self.free[k].wait(s.copy)
        for static, t in zip(self.graphs[k].inputs, host_inputs):
            static.copy_(t, non_blocking=True)
        self.copied[k].record(s.copy)
        s.to_compute()
        return int(held)

    def replay(self):
        """Replay the graph of the slot the last ``feed`` filled, on the
        compute stream once its copy has landed, and return a copy of the
        output, a tensor or a tuple of them (queued right after the replay,
        before any other replay of the pool)."""
        k = self.slot
        self.slot = (k + 1) % len(self.graphs)
        self.copied[k].wait(self.streams.compute)
        graph = self.graphs[k]
        graph.graph.replay()
        ops.add_launch_counts(graph.launches)
        return self._copy(graph.output)


def _then_record(out, events):
    """``out``, with each event recorded on the current stream after the
    work that made it (inside a capture: a node of the graph)."""
    for event in events:
        event.record(torch.cuda.current_stream())
    return out


def capture_replica(forward: Callable, inputs: Dict[int, Sequence[torch.Tensor]],
                    done: Optional[torch.cuda.Event] = None) -> Dict[int, SlottedGraph]:
    """One ``SlottedGraph`` per bucket of ``inputs`` ({bucket: static
    inputs of one slot}, all on one device; the other slots are made like
    them), its ``SLOTS`` graphs and every other bucket's in one memory pool,
    the largest bucket first so that the others fit in the blocks it frees.
    ``done``, where given, is recorded by every graph at its end too."""
    device = next(iter(inputs.values()))[0].device
    streams = Streams(device)
    with torch.cuda.device(device):
        pool = torch.cuda.graph_pool_handle()
    out: Dict[int, SlottedGraph] = {}
    for b in sorted(inputs, reverse=True):
        slots: List[Sequence[torch.Tensor]] = [inputs[b]] + [
            [torch.empty_like(t) for t in inputs[b]] for _ in range(SLOTS - 1)]
        free = [torch.cuda.Event(external=True) for _ in slots]
        captured = []
        for i, (slot, event) in enumerate(zip(slots, free)):
            events = (event,) if done is None else (event, done)
            fn = lambda *t, events=events: _then_record(forward(*t), events)  # noqa: E731
            captured.append(capture_bucket(fn, slot, pool) if i == 0 else
                            capture(fn, slot, pool))
            for t in slot:  # written on the copy stream for as long as they live
                t.record_stream(streams.copy)
        out[b] = SlottedGraph(captured, streams,
                              [torch.cuda.Event() for _ in slots], free)
    # the first copies land after the capture's warm forwards have read the slots
    streams.copy.wait_stream(streams.compute)
    return out
