"""Host-to-device input pipeline: a producer thread and staged copies.

Counterpart of ``prefetch_to_device`` in ``vqa_tpu/data/pipeline.py``. A
producer thread assembles numpy batches (decode and augmentation, the slow
part) up to ``size`` ahead. The consumer thread moves each batch to the
device: on the card every array is copied into a block of PyTorch's pinned
host allocator and sent with ``non_blocking=True`` on a side stream, one
batch ahead of the one being yielded, so the copy overlaps the step that
runs on the batch before. Before a batch is yielded the consumer's current
stream waits for its copy (an event), and each tensor is marked with
``record_stream`` so its memory is not reused while that stream reads it.
Under data parallelism each rank iterates its own loader shard
(``data.dataset.shard_for_process``) and places its local batch on its
own card (the trainer passes the rank's device).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

_SENTINEL = object()


def _copy_batch(batch: dict, device: torch.device, stream) -> tuple:
    """(batch with tensors on ``device``, the copy's event or None)."""
    out = {}
    if stream is None:
        for k, v in batch.items():
            out[k] = (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                      if isinstance(v, np.ndarray) else v)
        return out, None
    with torch.cuda.stream(stream):
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                host = torch.from_numpy(np.ascontiguousarray(v))
                staged = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                staged.copy_(host)
                out[k] = staged.to(device, non_blocking=True)
            else:
                out[k] = v
        event = stream.record_event()
    return out, event


def _ready(batch: dict, event, device: torch.device) -> dict:
    if event is not None:
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for v in batch.values():
            if isinstance(v, torch.Tensor):
                v.record_stream(current)
    return batch


def prefetch_to_device(iterable: Iterable[dict], device="cuda", size: int = 2
                       ) -> Iterator[dict]:
    """Yield the batches of ``iterable`` (dicts of numpy arrays plus scalar
    metadata) with every array as a tensor on ``device``: the card unless
    the caller passes ``"cpu"``, as the JAX helper places batches on the
    default device.

    ``size`` bounds how many numpy batches the producer thread holds ready
    (2 = double buffering). An exception in the producer is raised in the
    consumer."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    err: list = []

    def producer():
        try:
            for batch in iterable:
                q.put(batch)
        except Exception as e:  # handed to the consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    threading.Thread(target=producer, daemon=True, name="vqa-prefetch").start()
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    pending = None
    while True:
        item = q.get()
        if item is _SENTINEL:
            break
        staged = _copy_batch(item, device, stream)
        if pending is not None:
            yield _ready(*pending, device)
        pending = staged
    if pending is not None:
        yield _ready(*pending, device)
    if err:
        raise err[0]
