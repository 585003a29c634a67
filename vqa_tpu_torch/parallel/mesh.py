"""The (data, model) grid of ranks and the tensor-parallel rules.

Counterpart of ``vqa_tpu/parallel/mesh.py``. JAX builds one ``Mesh`` of
devices and lets GSPMD place every array; the port places them by hand.
``Mesh`` here is one grid type for two uses:

- **a grid of processes** (``devices`` empty): the run's ranks laid out
  row-major, rank = data_index·model_parallel + model_index, one process
  per card (training, evaluation). Ranks of one *data group* (one model
  coordinate) hold different batch slices and average their gradients;
  ranks of one *model group* (one data coordinate) read the same batch and
  split the tensor-parallel blocks between them;
- **a grid of devices in one process** (``devices`` given): the serving
  engine's replicas, one per device, as ``create_mesh(devices=...)`` does
  in JAX; two cells may name one device.

``param_spec`` is JAX's ``_TP_RULES`` table written over the reference
state_dict keys. Flax kernels are ``[in, out]`` and ``nn.Linear.weight``
is ``[out, in]``, so JAX's ``P(None, "model")`` on a kernel is
``("model", None)`` here: dim 0 of the torch weight. JAX leaves a leaf
whole when its dimension does not divide; here the unit is the block
(``models/vqa_model.py:shard_model``), which splits only when all of its
split dimensions divide.

``gather``/``split`` move a tensor between its full and its per-rank form
with ``all_reduce`` alone (a zero-filled full tensor that each rank fills
with its slice), so the gloo backend can run them on CUDA tensors.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from vqa_tpu_torch.parallel import distributed

_LAUNCH_HINT = ("launch one process per rank: torchrun --nproc-per-node {n} -m ..., "
                "or lower the degrees")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) grid; ``shape`` reads as JAX's ``Mesh.shape``."""

    data_parallel: int = 1
    model_parallel: int = 1
    # one process drives these cells, row-major; empty: one process per cell
    devices: Tuple[torch.device, ...] = ()
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None
    data_axis: str = "data"
    model_axis: str = "model"

    @property
    def shape(self) -> Dict[str, int]:
        return {self.data_axis: self.data_parallel, self.model_axis: self.model_parallel}

    @property
    def world_group(self):
        """Every rank of the grid (the whole process group), or None
        without one."""
        return None if self.data_group is None else dist.group.WORLD


def _too_small(dp: int, mp: int, n: int, processes: bool) -> ValueError:
    unit = "processes" if processes else "devices"
    hint = _LAUNCH_HINT.format(n=dp * mp) if processes else "lower the degrees"
    return ValueError(
        f"mesh {dp}×{mp} needs {dp * mp} {unit} but only {n} are available ({hint})")


def create_mesh(
    data_parallel: int = -1,
    model_parallel: int = 1,
    devices: Optional[Sequence] = None,
    data_axis: str = "data",
    model_axis: str = "model",
) -> Mesh:
    """A (data, model) grid over ``devices`` (one process drives them all),
    or, without ``devices``, over the run's processes.

    ``data_parallel=-1`` → every device or process not taken by
    ``model_parallel``. A grid of processes covers the whole run: each
    rank has one cell, and a grid smaller than the world raises."""
    processes = devices is None
    n = distributed.process_count() if processes else len(devices)
    if model_parallel <= 0:
        model_parallel = 1
    if data_parallel <= 0:
        data_parallel = n // model_parallel
    dp, mp = data_parallel, model_parallel
    if dp * mp > n:
        # named error (not assert) so direct callers keep the guard under -O
        raise _too_small(dp, mp, n, processes)
    axes = dict(data_axis=data_axis, model_axis=model_axis)
    if not processes:
        return Mesh(dp, mp, devices=tuple(torch.device(d) for d in devices[: dp * mp]), **axes)
    if dp * mp != n:
        raise ValueError(
            f"mesh {dp}×{mp} has {dp * mp} cells for {n} processes: each process takes "
            f"one cell ({_LAUNCH_HINT.format(n=dp * mp)})")
    rank = distributed.process_index()
    data_group = model_group = None
    if dist.is_initialized():
        # every rank makes every group, in one order
        data_group, _ = dist.new_subgroups_by_enumeration(
            [[d * mp + m for d in range(dp)] for m in range(mp)])
        model_group, _ = dist.new_subgroups_by_enumeration(
            [[d * mp + m for m in range(mp)] for d in range(dp)])
    return Mesh(dp, mp, data_index=rank // mp, model_index=rank % mp,
                data_group=data_group, model_group=model_group, **axes)


def mesh_from_config(cfg=None, batch_divisor: Optional[int] = None,
                     devices: Optional[Sequence] = None) -> Mesh:
    """The mesh a ``MeshConfig`` describes (default ``MeshConfig()``), over
    ``devices`` or the run's processes: the path the Trainer, the
    evaluator and the server take.

    ``data_parallel=-1`` (auto) takes every rank not consumed by
    ``model_parallel``; with ``batch_divisor`` the auto degree is clamped
    to a divisor of it, and an explicit degree that does not divide it
    raises."""
    from vqa_tpu_torch.utils.config import MeshConfig

    cfg = cfg or MeshConfig()
    processes = devices is None
    n_dev = distributed.process_count() if processes else len(devices)
    unit = "processes" if processes else "devices"
    mp = max(cfg.model_parallel, 1)
    if n_dev % mp != 0:
        need = mp * max(cfg.data_parallel, 1)
        hint = f" ({_LAUNCH_HINT.format(n=need)})" if processes else ""
        raise ValueError(f"model_parallel={mp} does not divide {n_dev} {unit}{hint}")
    dp = cfg.data_parallel
    if dp <= 0:
        dp = n_dev // mp
        if batch_divisor:
            dp = math.gcd(dp, batch_divisor) or 1
    elif batch_divisor and batch_divisor % dp != 0:
        raise ValueError(
            f"data_parallel={dp} does not divide the batch size "
            f"{batch_divisor}; pick a divisor or use data_parallel=-1 (auto)"
        )
    if dp * mp > n_dev:
        raise _too_small(dp, mp, n_dev, processes)
    return create_mesh(dp, mp, devices=devices, data_axis=cfg.data_axis,
                       model_axis=cfg.model_axis)


# ---------------------------------------------------------------------------
# Tensor-parallel partition rules
# ---------------------------------------------------------------------------
# Matched against the reference state_dict key; first hit wins; default is
# replication. Column-parallel (output features on 'model': dim 0 of the
# torch weight, and the bias) for Q/K/V and each FFN's first layer;
# row-parallel (input features: dim 1) for O and each FFN's second layer;
# the embedding split by vocabulary rows.

_M = "model"
_TP_RULES = [
    # attention projections (self- and cross-)
    (re.compile(r".*\.(W_q|W_k|W_v)\.weight$"), (_M, None)),
    (re.compile(r".*\.W_o\.weight$"), (None, _M)),
    # transformer FFN
    (re.compile(r"text_encoder\.layers\.\d+\.ffn\.fc1\.weight$"), (_M, None)),
    (re.compile(r"text_encoder\.layers\.\d+\.ffn\.fc1\.bias$"), (_M,)),
    (re.compile(r"text_encoder\.layers\.\d+\.ffn\.fc2\.weight$"), (None, _M)),
    # cross-attention FFN (flax ffn_fc1 / ffn_fc2)
    (re.compile(r".*cross_attention\.layers\.\d+\.ffn\.0\.weight$"), (_M, None)),
    (re.compile(r".*cross_attention\.layers\.\d+\.ffn\.0\.bias$"), (_M,)),
    (re.compile(r".*cross_attention\.layers\.\d+\.ffn\.3\.weight$"), (None, _M)),
    # answer head MLP (fc1, fc2; fc3 whole)
    (re.compile(r"answer_head\.classifier\.0\.weight$"), (_M, None)),
    (re.compile(r"answer_head\.classifier\.0\.bias$"), (_M,)),
    (re.compile(r"answer_head\.classifier\.3\.weight$"), (None, _M)),
    # vocab-sharded embedding
    (re.compile(r"text_encoder\.token_embedding\.weight$"), (_M, None)),
]


def param_spec(key: str) -> Tuple[Optional[str], ...]:
    """The partition of one state_dict entry: the mesh axis of each torch
    dimension, ``()`` for a replicated one."""
    for rx, spec in _TP_RULES:
        if rx.match(key):
            return spec
    return ()


def split_dim(key: str) -> Optional[int]:
    """The torch dimension ``param_spec`` splits over 'model', or None."""
    spec = param_spec(key)
    return spec.index(_M) if _M in spec else None


_BLOCK_MEMBER = re.compile(r"\.(W_[qkvo]|fc[12]|\d+)$")


def variables_shardings(shapes: Dict[str, Sequence[int]], mesh: Mesh,
                        num_heads: int) -> Dict[str, int]:
    """The entries of a full state_dict (key → shape) that split on
    ``mesh``, each with its split dimension.

    The unit is the tensor-parallel block: an attention (Q, K, V and O,
    with ``num_heads`` divisible by the model degree), an FFN or the
    answer head's fc1/fc2 pair, the embedding. A block splits only when
    every split dimension of it divides; otherwise it stays whole (JAX
    leaves single leaves whole; the function is the same either way)."""
    mp = mesh.model_parallel
    if mp <= 1:
        return {}
    blocks: Dict[str, Dict[str, int]] = {}
    for key, shape in shapes.items():
        dim = split_dim(key)
        if dim is not None:
            block = _BLOCK_MEMBER.sub("", key.rsplit(".", 1)[0])
            blocks.setdefault(block, {})[key] = dim
    out: Dict[str, int] = {}
    for block, members in blocks.items():
        if any(k.endswith(".W_q.weight") for k in members) and num_heads % mp:
            continue
        if all(shapes[k][d] % mp == 0 for k, d in members.items()):
            out.update(members)
    return out


def data_sharding(mesh: Mesh, batch_size: int) -> slice:
    """The rows of a global batch this rank's data coordinate takes."""
    if batch_size % mesh.data_parallel:
        raise ValueError(f"batch {batch_size} not divisible by data_parallel="
                         f"{mesh.data_parallel}")
    n = batch_size // mesh.data_parallel
    return slice(mesh.data_index * n, (mesh.data_index + 1) * n)


def replicated(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Make each rank hold its data group's first rank's values of
    ``tensors`` (in place, one ``broadcast`` each), as DDP starts its
    replicas; does nothing without a process group or data parallelism."""
    if mesh.data_group is None or mesh.data_parallel == 1:
        return
    for t in tensors:
        # the data group's first rank is global rank model_index
        dist.broadcast(t.detach(), src=mesh.model_index, group=mesh.data_group)


def split(t: torch.Tensor, dim: int, index: int, degree: int) -> torch.Tensor:
    """Rank ``index``'s contiguous slice of ``t`` along ``dim``, a copy."""
    n = t.shape[dim] // degree
    return t.narrow(dim, index * n, n).clone()


def gather(t: torch.Tensor, dim: int, index: int, degree: int, group) -> torch.Tensor:
    """The full tensor from every rank's slice along ``dim``: each rank
    writes its slice into a zero-filled full tensor and one ``all_reduce``
    sums them (adding zeros is exact)."""
    shape = list(t.shape)
    n = shape[dim]
    shape[dim] = n * degree
    full = t.new_zeros(shape)
    full.narrow(dim, index * n, n).copy_(t)
    dist.all_reduce(full, group=group)
    return full


def full_state_dict(state: Dict[str, torch.Tensor], splits: Dict[str, int],
                    mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The reference-layout state_dict from one rank's sharded one:
    every entry of ``splits`` (key → split dim) gathered over the model
    group, the rest as they are."""
    return {k: (gather(v, splits[k], mesh.model_index, mesh.model_parallel, mesh.model_group)
                if k in splits else v)
            for k, v in state.items()}


def shard_state_dict(state: Dict[str, torch.Tensor], splits: Dict[str, int],
                     mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's slice of a full state_dict (inverse of
    ``full_state_dict``)."""
    return {k: (split(v, splits[k], mesh.model_index, mesh.model_parallel)
                if k in splits else v)
            for k, v in state.items()}
