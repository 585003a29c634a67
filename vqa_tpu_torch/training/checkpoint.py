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
  ``checkpoint_exists``, ``load_checkpoint_meta``,
  ``load_model_for_inference`` and ``load_training_checkpoint`` (the
  trainer's resume, AdamW's state included) take either; where both are
  there, the port's ``<name>.pt`` comes first.

A name holds one checkpoint. A save writes ``<name>.tmp.pt`` and
``<name>.tmp.meta.json`` and swaps them in with renames: the previous
checkpoint under the name, the port's file or the JAX trainer's tree,
is parked at ``<name>.old.pt`` or ``<name>.old/`` with its sidecar at
``<name>.old.meta.json`` until the new pair is in, then removed, so it
stays readable for the whole write and a crash inside the swap's few
renames is undone on the next load (``_recover``). The JAX package's
save swaps its own tree the same way.

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
from typing import Any, Dict, List, Sequence, Tuple

import torch

from vqa_tpu_torch.parallel import distributed
from vqa_tpu_torch.utils.config import ModelConfig, model_config_dict, model_config_from_dict
from vqa_tpu_torch.utils.profiling import annotate

_DATA, _META = ".pt", ".meta.json"
_ORBAX = ""  # an Orbax checkpoint is the directory <base>/<name> itself
_FORMS = (_DATA, _ORBAX)


def _stem(base: str, name: str) -> str:
    return os.path.join(os.path.abspath(base), name)


def _remove(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)


def _has_data(stem: str) -> bool:
    """Whether ``stem`` holds a checkpoint's data: the port's file or the
    JAX trainer's tree."""
    return os.path.exists(stem + _DATA) or os.path.isdir(stem + _ORBAX)


def _swap_into_place(tmp: str, stem: str) -> None:
    """Replace the checkpoint under ``stem`` (the port's file or the JAX
    trainer's tree, with its sidecar) by ``tmp``'s pair: the previous one
    is parked at ``<stem>.old`` for the two renames that bring the new
    pair in, then removed."""
    old = stem + ".old"
    for suffix in _FORMS + (_META,):
        _remove(old + suffix)
    if _has_data(stem):
        for suffix in _FORMS:
            if os.path.exists(stem + suffix):
                os.rename(stem + suffix, old + suffix)
        if os.path.exists(stem + _META):
            os.rename(stem + _META, old + _META)
    os.rename(tmp + _DATA, stem + _DATA)
    os.rename(tmp + _META, stem + _META)
    for suffix in _FORMS + (_META,):
        _remove(old + suffix)


def _recover(stem: str) -> None:
    """Undo a crash inside ``_swap_into_place``, the port's or the JAX
    package's (``vqa_tpu/training/checkpoint.py:_recover``), which park
    the same names: the previous checkpoint parked at ``<stem>.old`` comes
    back when nothing replaced it; new data whose sidecar is still at
    ``<stem>.tmp.meta.json`` (it was fully written before the swap began)
    gets its sidecar."""
    old = stem + ".old"
    if not _has_data(stem) and _has_data(old):
        for suffix in _FORMS + (_META,):
            if os.path.exists(old + suffix) and not os.path.exists(stem + suffix):
                try:
                    os.rename(old + suffix, stem + suffix)
                except OSError:
                    pass  # another process won the recovery race
        return
    tmp_meta = stem + ".tmp" + _META
    if _has_data(stem) and not os.path.exists(stem + _META) and os.path.exists(tmp_meta):
        try:
            os.rename(tmp_meta, stem + _META)
        except OSError:
            pass


def save_checkpoint(base_dir: str, name: str, payload: Dict[str, Any],
                    model_config: ModelConfig, meta: Dict[str, Any]) -> str:
    """Write ``payload`` (tensors on any device; saved as they are) and
    the sidecar, crash-safely (the primary, between two barriers), in
    place of whatever checkpoint held the name. Returns the data file's
    path."""
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


def _sidecar(stem: str) -> Dict[str, Any]:
    with open(stem + _META, "r", encoding="utf-8") as f:
        return json.load(f)


def load_checkpoint(base_dir: str, name: str, map_location="cpu"
                    ) -> Tuple[Dict[str, Any], ModelConfig, Dict[str, Any]]:
    """(payload, model_config, meta) of the port's ``<name>.pt``; tensors
    land on ``map_location``."""
    stem = _stem(base_dir, name)
    _recover(stem)
    payload = torch.load(stem + _DATA, map_location=map_location, weights_only=True)
    sidecar = _sidecar(stem)
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
    _recover(stem)
    tree = orbax.read_checkpoint(stem + _ORBAX)
    sidecar = _sidecar(stem)
    return tree, model_config_from_dict(sidecar["config"]), sidecar["meta"]


def load_training_checkpoint(base_dir: str, name: str, param_names: Sequence[str],
                             param_groups: List[Dict[str, Any]], map_location="cpu"
                             ) -> Tuple[Dict[str, Any], ModelConfig, Dict[str, Any]]:
    """(payload, model_config, meta) of a checkpoint to resume training
    from, in the port's payload form (``model_state_dict``,
    ``optimizer_state_dict``, ``scheduler_step``, ``step``), tensors on
    ``map_location``: the port's ``<name>.pt`` as it was saved, else the
    JAX trainer's tree ``<name>/``.

    From the tree: the weights and BN statistics through
    ``compat/jax_weights.py:state_dict_from_jax``; optax's AdamW moments
    and count (``compat/orbax.py:training_state`` checks the chain) as
    torch AdamW's state, keyed by each parameter's position in
    ``param_names`` (the model's ``named_parameters()`` order); the
    schedule's count as ``scheduler_step``. A tree holds no
    hyperparameters, so ``param_groups`` (the caller's optimizer's) go
    with it, as the JAX trainer's restore keeps its own optimizer's. A
    sidecar flagged ``model_only`` gives ``model_state_dict`` alone."""
    stem = _stem(base_dir, name)
    if _is_port_checkpoint(stem):
        return load_checkpoint(base_dir, name, map_location=map_location)
    from vqa_tpu_torch.compat.jax_weights import adamw_state_from_jax, state_dict_from_jax
    from vqa_tpu_torch.compat.orbax import training_state

    tree, cfg, meta = load_orbax_checkpoint(base_dir, name)
    state = training_state(tree, model_only=bool(meta.get("model_only", False)))
    weights = state_dict_from_jax(
        {"params": state["params"], "batch_stats": state["batch_stats"]}, cfg)
    payload: Dict[str, Any] = {
        "model_state_dict": {k: v.to(map_location) for k, v in weights.items()}}
    if state["mu"] is not None:
        moments = adamw_state_from_jax(state["mu"], state["nu"], state["adam_count"],
                                       param_names)
        payload.update(
            optimizer_state_dict={
                "state": {i: {k: v if k == "step" else v.to(map_location)
                              for k, v in st.items()} for i, st in moments.items()},
                "param_groups": param_groups},
            scheduler_step=state["schedule_count"], step=state["step"])
    return payload, cfg, meta


def load_checkpoint_meta(base_dir: str, name: str) -> Dict[str, Any]:
    """Sidecar metadata only (epoch, best accuracy, history, run
    provenance such as the ``--synthetic`` dataset spec), of either
    layout."""
    stem = _stem(base_dir, name)
    _recover(stem)
    return _sidecar(stem)["meta"]


def save_best_copy(base_dir: str, src_name: str = "latest",
                   best_name: str = "best_model") -> None:
    """Copy the port's checkpoint ``src_name`` as ``best_name``,
    crash-safely: copy to ``.tmp`` files, then swap them in, so the
    previous best (the port's or a JAX tree) stays readable throughout
    (the primary, then a barrier)."""
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
    _recover(stem)
    return _has_data(stem) and os.path.exists(stem + _META)


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
    # the random initialisation the loaded state then overwrites
    with annotate("model.init"):
        model = create_vqa_model(config=cfg, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval().set_compute_dtype(dtype or torch.float32)
