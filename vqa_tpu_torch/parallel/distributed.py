"""Multi-process runtime: one process per card, joined by torch.distributed.

Counterpart of ``vqa_tpu/parallel/distributed.py``. Where JAX runs one
process per host that sees all of the host's chips, the port runs one
process per card (``torchrun --nproc-per-node N``); ``initialize`` joins
them into one process group, each rank bound to ``cuda:LOCAL_RANK``.

Single-process is the degenerate case: ``initialize`` with no arguments
and no launcher variables does nothing, and every helper collapses to the
trivial answer, so callers never branch on topology. A launched world of
one (``RANK=0 WORLD_SIZE=1``) does join a process group of one.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_rank: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
    timeout_s: Optional[float] = None,
) -> bool:
    """Join this process to the run's process group. Returns True iff the
    run is multi-process.

    Sources, checked in order:
      1. explicit arguments (``--coordinator host:port``, ``--num-processes``,
         ``--process-id``);
      2. the variables ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
         ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), which fill in only what
         the arguments leave out;
      3. nothing: a plain single process, no process group.

    ``backend=None`` takes NCCL for ``device`` on the card and gloo on the
    CPU; an explicit ``backend`` is honoured (gloo on CUDA tensors runs
    ``all_reduce`` and ``broadcast``, which is how two ranks share one
    card). A failed NCCL rendezvous fails the run: there is no fallback.
    On the card each rank binds ``cuda:local_rank`` (``LOCAL_RANK``, else
    the process id modulo the card count) before the group is made.
    Idempotent: a second call returns the first one's answer.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env_addr = os.environ.get("MASTER_ADDR")
    if coordinator_address is None and env_addr and os.environ.get("WORLD_SIZE"):
        coordinator_address = f"{env_addr}:{os.environ.get('MASTER_PORT', '29500')}"
        num_processes = num_processes or _env_int("WORLD_SIZE")
        process_id = process_id if process_id is not None else _env_int("RANK")
    if coordinator_address is None:
        return False  # plain single-process run
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address} given without the number of processes "
            "and this process's id (--num-processes, --process-id, or WORLD_SIZE and RANK)")

    on_card = torch.device(device).type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on an NVIDIA GPU unless "
                "--device cpu is asked for")
        if local_rank is None:
            local_rank = _env_int("LOCAL_RANK")
        if local_rank is None:
            local_rank = process_id % torch.cuda.device_count()
        torch.cuda.set_device(local_rank)
    backend = backend or ("nccl" if on_card else "gloo")
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kwargs)
    return num_processes > 1


@contextlib.contextmanager
def session(**kwargs):
    """``initialize(**kwargs)`` for the span of a run (a CLI's): a process
    group this call made is left at the end; one made before is kept."""
    made = not dist.is_initialized()
    initialize(**kwargs)
    try:
        yield
    finally:
        if made:
            shutdown()


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on exactly one process: gate file writes and chatty logging
    with this (every rank runs the same script)."""
    return process_index() == 0


def barrier() -> None:
    """Wait for every rank; does nothing in a world of one."""
    if process_count() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def local_batch_size(global_batch_size: int, shards: Optional[int] = None) -> int:
    """Per-process slice of the global batch each loader must yield;
    ``shards`` is the number of distinct slices (the data-parallel degree,
    where ranks of one model group read the same batch), by default the
    process count."""
    n = shards if shards is not None else process_count()
    if global_batch_size % n != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{n} processes"
        )
    return global_batch_size // n
