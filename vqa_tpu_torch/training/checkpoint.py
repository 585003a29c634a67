"""Crash-safe checkpoints with the JAX package's save/best/resume semantics.

Counterpart of ``vqa_tpu/training/checkpoint.py``. The JAX package writes
an Orbax tree; the port writes one torch file per checkpoint, and reads
both:

- ``<base>/<name>.pt``: ``{"model_state_dict", "optimizer_state_dict",
  "scheduler_step", "step"}`` — the model in the reference state_dict
  layout (the one ``vqa_tpu.compat.torch_import`` reads); a model-only
  checkpoint holds ``model_state_dict`` alone;
- ``<base>/<name>.meta.json``: the JAX package's sidecar schema unchanged,
  ``{"config": model_config_dict(...), "meta": {...}}``, so either
  package's ``load_checkpoint_meta`` reads it.

- ``<base>/<name>/`` with the same sidecar: the JAX trainer's Orbax tree,
  read without orbax (``compat/orbax.py``; ``load_orbax_checkpoint``).
  ``checkpoint_exists``, ``load_checkpoint_meta`` and
  ``load_model_for_inference`` take either; where both are there, the
  port's ``<name>.pt`` comes first.

A save writes ``<name>.tmp.pt`` and ``<name>.tmp.meta.json`` and swaps
them in with renames, so the previous checkpoint stays readable for the
whole write; a crash inside the swap's few renames is undone on the next
load (``_recover``).

In a multi-process run every rank calls ``save_checkpoint`` and
``save_best_copy`` with the same payload (the trainer gathers the full
reference-layout state_dict from the tensor-parallel shards first); the
primary alone writes and swaps, between two barriers, so no rank returns
(and reads) before the swap has landed (``vqa_tpu/training/checkpoint.py``'s
order).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Tuple

import torch

from vqa_tpu_torch.parallel import distributed
from vqa_tpu_torch.utils.config import ModelConfig, model_config_dict, model_config_from_dict

_DATA, _META = ".pt", ".meta.json"
_ORBAX = ""  # an Orbax checkpoint is the directory <base>/<name> itself


def _stem(base: str, name: str) -> str:
    return os.path.join(os.path.abspath(base), name)


def _remove(path: str) -> None:
    if os.path.exists(path):
        os.remove(path)


def _swap_into_place(tmp: str, stem: str) -> None:
    """Replace ``stem``'s data file and sidecar with ``tmp``'s: the
    previous pair is parked at ``<stem>.old`` for the two renames that
    bring the new pair in, then removed."""
    old = stem + ".old"
    for suffix in (_DATA, _META):
        _remove(old + suffix)
    if os.path.exists(stem + _DATA):
        os.rename(stem + _DATA, old + _DATA)
        if os.path.exists(stem + _META):
            os.rename(stem + _META, old + _META)
    os.rename(tmp + _DATA, stem + _DATA)
    os.rename(tmp + _META, stem + _META)
    for suffix in (_DATA, _META):
        _remove(old + suffix)


def _recover(stem: str, data: str = _DATA) -> None:
    """Undo a crash inside ``_swap_into_place``: the previous checkpoint
    parked at ``<stem>.old`` comes back when nothing replaced it; a new
    data file whose sidecar is still at ``<stem>.tmp.meta.json`` (it was
    fully written before the swap began) gets its sidecar. ``data`` is
    the data file's suffix: ``_ORBAX`` for the JAX trainer's directory,
    whose swap (``vqa_tpu/training/checkpoint.py:_recover``) parks the
    same names."""
    old = stem + ".old"
    if not os.path.exists(stem + data) and os.path.exists(old + data):
        try:
            os.rename(old + data, stem + data)
        except OSError:
            return  # another process won the recovery race
        if not os.path.exists(stem + _META) and os.path.exists(old + _META):
            try:
                os.rename(old + _META, stem + _META)
            except OSError:
                pass
        return
    tmp_meta = stem + ".tmp" + _META
    if (os.path.exists(stem + data) and not os.path.exists(stem + _META)
            and os.path.exists(tmp_meta)):
        try:
            os.rename(tmp_meta, stem + _META)
        except OSError:
            pass


def save_checkpoint(base_dir: str, name: str, payload: Dict[str, Any],
                    model_config: ModelConfig, meta: Dict[str, Any]) -> str:
    """Write ``payload`` (tensors on any device; saved as they are) and
    the sidecar, crash-safely (the primary, between two barriers). Returns
    the data file's path."""
    stem = _stem(base_dir, name)
    tmp = stem + ".tmp"
    distributed.barrier()
    if not distributed.is_primary():
        distributed.barrier()
        return stem + _DATA
    os.makedirs(os.path.dirname(stem), exist_ok=True)
    for suffix in (_DATA, _META):
        _remove(tmp + suffix)
    try:
        torch.save(payload, tmp + _DATA)
        with open(tmp + _META, "w", encoding="utf-8") as f:
            json.dump({"config": model_config_dict(model_config), "meta": meta}, f, indent=2)
        _swap_into_place(tmp, stem)
    finally:
        for suffix in (_DATA, _META):
            _remove(tmp + suffix)
        distributed.barrier()
    return stem + _DATA


def load_checkpoint(base_dir: str, name: str, map_location="cpu"
                    ) -> Tuple[Dict[str, Any], ModelConfig, Dict[str, Any]]:
    """(payload, model_config, meta); tensors land on ``map_location``."""
    stem = _stem(base_dir, name)
    _recover(stem)
    payload = torch.load(stem + _DATA, map_location=map_location, weights_only=True)
    with open(stem + _META, "r", encoding="utf-8") as f:
        sidecar = json.load(f)
    return payload, model_config_from_dict(sidecar["config"]), sidecar["meta"]


def load_orbax_checkpoint(base_dir: str, name: str
                          ) -> Tuple[Dict[str, Any], ModelConfig, Dict[str, Any]]:
    """(tree, model_config, meta) of the JAX trainer's checkpoint
    ``<base>/<name>/``: the counterpart of the JAX package's
    ``load_checkpoint`` without a target tree (numpy arrays, Python
    scalars; ``compat/orbax.py:read_checkpoint``), after the same
    crash recovery."""
    from vqa_tpu_torch.compat import orbax

    stem = _stem(base_dir, name)
    _recover(stem, _ORBAX)
    tree = orbax.read_checkpoint(stem)
    with open(stem + _META, "r", encoding="utf-8") as f:
        sidecar = json.load(f)
    return tree, model_config_from_dict(sidecar["config"]), sidecar["meta"]


def load_checkpoint_meta(base_dir: str, name: str) -> Dict[str, Any]:
    """Sidecar metadata only (epoch, best accuracy, history, run
    provenance such as the ``--synthetic`` dataset spec), of either
    layout."""
    stem = _stem(base_dir, name)
    _recover(stem)
    if not os.path.exists(stem + _DATA):
        _recover(stem, _ORBAX)
    with open(stem + _META, "r", encoding="utf-8") as f:
        return json.load(f)["meta"]


def save_best_copy(base_dir: str, src_name: str = "latest",
                   best_name: str = "best_model") -> None:
    """Copy a checkpoint as best, crash-safely: copy to ``.tmp`` files,
    then swap them in, so the previous best stays readable throughout (the
    primary, then a barrier)."""
    if not distributed.is_primary():
        distributed.barrier()
        return
    src, dst = _stem(base_dir, src_name), _stem(base_dir, best_name)
    tmp = dst + ".tmp"
    for suffix in (_DATA, _META):
        _remove(tmp + suffix)
    try:
        for suffix in (_DATA, _META):
            shutil.copyfile(src + suffix, tmp + suffix)
        _swap_into_place(tmp, dst)
    finally:
        for suffix in (_DATA, _META):
            _remove(tmp + suffix)
        distributed.barrier()


def _is_port_checkpoint(stem: str) -> bool:
    _recover(stem)
    return os.path.exists(stem + _DATA) and os.path.exists(stem + _META)


def checkpoint_exists(base_dir: str, name: str) -> bool:
    """Whether ``<name>`` is there: the port's ``<name>.pt`` or the JAX
    trainer's ``<name>/`` directory, each with its sidecar."""
    stem = _stem(base_dir, name)
    if _is_port_checkpoint(stem):
        return True
    _recover(stem, _ORBAX)
    return os.path.isdir(stem) and os.path.exists(stem + _META)


def load_model_for_inference(base_dir: str, name: str = "best_model", device="cuda",
                             dtype=None):
    """The model of a checkpoint (the port's ``.pt`` first, else the JAX
    trainer's Orbax tree through ``compat/jax_weights.py``), rebuilt from
    the sidecar's full config (CNN geometry included), loaded strictly, in
    eval mode on ``device``, computing in ``dtype`` (default f32, as the
    JAX loader's; the weights stay f32)."""
    from vqa_tpu_torch.models.vqa_model import create_vqa_model, resolve_device

    device = resolve_device(device)
    if _is_port_checkpoint(_stem(base_dir, name)):
        payload, cfg, _ = load_checkpoint(base_dir, name)
        state_dict = payload["model_state_dict"]
    else:
        from vqa_tpu_torch.compat.jax_weights import state_dict_from_jax
        from vqa_tpu_torch.compat.orbax import inference_variables

        tree, cfg, _ = load_orbax_checkpoint(base_dir, name)
        state_dict = state_dict_from_jax(inference_variables(tree), cfg)
    model = create_vqa_model(config=cfg, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval().set_compute_dtype(dtype or torch.float32)
