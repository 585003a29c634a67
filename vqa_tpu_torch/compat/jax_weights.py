"""Carry the JAX package's weights into the port.

``state_dict_from_jax(variables, config)`` takes the flax
``{'params', 'batch_stats'}`` tree (numpy or anything ``np.asarray``
takes) and returns the port's ``state_dict``, which loads with
``strict=True``. It is the port's own copy of the mapping in
``vqa_tpu/compat/torch_export.py:34-193``:

- conv kernels HWIO → OIHW;
- dense kernels [in, out] → [out, in];
- BN scale/bias → weight/bias, batch_stats mean/var → running_mean/var,
  and a ``num_batches_tracked`` of 0 beside each;
- the sinusoidal ``text_encoder.positional_encoding.pe`` buffer, which
  flax recomputes instead of storing, synthesized as the exporter does.

An unknown flax path raises ``KeyError``, so structural drift fails loudly.

``module_state_dict_from_jax(variables)`` does the same for one module of
``models/attention_modules.py`` used alone (``CBAMBlock``,
``SelfAttention2D``, ``SEAttention``, ``SpatialAttention``,
``AttentionWrapper``): its flax ``{'params': ...}`` → its ``state_dict``.

``reference_config(config)`` is the ``config`` entry of a reference-schema
``.pth``; ``model_config_from_reference(config, state_dict)`` reads a
model config back from one, its backbone geometry from the weights'
shapes.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from vqa_tpu_torch.utils.config import ModelConfig

_LN = {"scale": "weight", "bias": "bias"}


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (3, 2, 0, 1))


def _linear_kernel(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))


def sinusoidal_pe(max_length: int, embed_dim: int) -> np.ndarray:
    """The reference's ``pe`` buffer [1, L, D], computed as the exporter
    computes it (float64 angles rounded to f32)."""
    position = np.arange(max_length, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, embed_dim, 2, dtype=np.float32) * (-np.log(10000.0) / embed_dim))
    pe = np.zeros((max_length, embed_dim), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe[None]


def _flatten(tree: dict, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def _torch_key(collection: str, path: Tuple[str, ...]
               ) -> Tuple[str, Optional[Callable[[np.ndarray], np.ndarray]]]:
    """Map one flax (collection, path) to (state_dict key, transform)."""
    top, rest = path[0], path[1:]

    def bn(prefix: str, leaf: str):
        if collection == "batch_stats":
            return f"{prefix}.running_{'mean' if leaf == 'mean' else 'var'}", None
        return f"{prefix}.{_LN[leaf]}", None

    if top == "image_encoder":
        if rest[0] == "stem_conv":
            return "image_encoder.stem.0.weight", _conv_kernel
        if rest[0] == "stem_bn":
            return bn("image_encoder.stem.1", rest[1])
        stage = rest[0]
        if rest[1] == "attention":
            if rest[2] == "se":
                return f"image_encoder.{stage}.attention.se.{rest[3]}.weight", _linear_kernel
            if rest[2] == "spatial":
                return f"image_encoder.{stage}.attention.spatial.conv.weight", _conv_kernel
        if rest[1].startswith("block"):
            base = f"image_encoder.{stage}.blocks.{rest[1][len('block'):]}"
            sub = rest[2]
            if sub in ("conv1", "conv2"):
                return f"{base}.{sub}.weight", _conv_kernel
            if sub in ("bn1", "bn2"):
                return bn(f"{base}.{sub}", rest[3])
            if sub == "down_conv":
                return f"{base}.downsample.0.weight", _conv_kernel
            if sub == "down_bn":
                return bn(f"{base}.downsample.1", rest[3])

    if top == "text_encoder":
        if rest[0] == "token_embedding":
            return "text_encoder.token_embedding.weight", None
        if rest[0] == "final_norm":
            return f"text_encoder.final_norm.{_LN[rest[1]]}", None
        if rest[0].startswith("layer"):
            base = f"text_encoder.layers.{rest[0][len('layer'):]}"
            sub = rest[1]
            if sub == "self_attention":
                return f"{base}.self_attention.{rest[2]}.weight", _linear_kernel
            if sub in ("norm1", "norm2"):
                return f"{base}.{sub}.{_LN[rest[2]]}", None
            if sub == "ffn":
                if rest[3] == "kernel":
                    return f"{base}.ffn.{rest[2]}.weight", _linear_kernel
                return f"{base}.ffn.{rest[2]}.bias", None

    if top == "fusion":
        if rest[0] == "image_projector":
            if rest[1] == "proj":
                if rest[2] == "kernel":
                    return "fusion.image_projector.projection.0.weight", _linear_kernel
                return "fusion.image_projector.projection.0.bias", None
            if rest[1] == "proj_norm":
                return f"fusion.image_projector.projection.1.{_LN[rest[2]]}", None
            if rest[1] == "position_embedding":
                return "fusion.image_projector.position_embedding", None
        if rest[0] == "cross_attention":
            base = f"fusion.cross_attention.layers.{rest[1][len('layer'):]}"
            sub = rest[2]
            if sub in ("norm_query", "norm_kv", "norm_ffn"):
                return f"{base}.{sub}.{_LN[rest[3]]}", None
            if sub == "cross_attention":
                return f"{base}.cross_attention.{rest[3]}.weight", _linear_kernel
            if sub in ("ffn_fc1", "ffn_fc2"):
                idx = "0" if sub == "ffn_fc1" else "3"
                if rest[3] == "kernel":
                    return f"{base}.ffn.{idx}.weight", _linear_kernel
                return f"{base}.ffn.{idx}.bias", None
        if rest[0] == "gate":
            if rest[2] == "kernel":
                return "fusion.gate.gate.0.weight", _linear_kernel
            return "fusion.gate.gate.0.bias", None
        if rest[0] == "output_norm":
            return f"fusion.output_norm.{_LN[rest[1]]}", None

    if top == "answer_head":
        idx = {"fc1": "0", "fc2": "3", "fc3": "6"}[rest[0]]
        if rest[1] == "kernel":
            return f"answer_head.classifier.{idx}.weight", _linear_kernel
        return f"answer_head.classifier.{idx}.bias", None

    raise KeyError(f"no mapping for {collection}:{'/'.join(path)}")


def state_dict_from_jax(variables: Dict[str, Any], config: ModelConfig
                        ) -> Dict[str, torch.Tensor]:
    """flax ``{'params', 'batch_stats'}`` → the port's state_dict (CPU
    tensors, contiguous)."""
    out: Dict[str, np.ndarray] = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(collection, {})):
            key, transform = _torch_key(collection, path)
            out[key] = transform(arr) if transform is not None else arr
    out["text_encoder.positional_encoding.pe"] = sinusoidal_pe(
        config.max_question_length, config.embed_dim)
    for key in list(out):
        if key.endswith("running_mean"):
            out[key[: -len("running_mean")] + "num_batches_tracked"] = np.asarray(0, np.int64)
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}


def module_state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``{'params': ...}`` of one attention module used alone → its
    state_dict: ``se/fc1/kernel`` → ``se.fc1.weight`` ([in, out] →
    [out, in]), ``spatial/conv/kernel`` and ``query``/``key``/``value``
    kernels HWIO → OIHW, biases as they are, ``gamma`` as it is. Loads with
    ``strict=True``."""
    out: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(variables.get("params", {})):
        leaf = path[-1]
        if leaf == "kernel" and arr.ndim in (2, 4):
            transform = _conv_kernel if arr.ndim == 4 else _linear_kernel
            out[".".join(path[:-1] + ("weight",))] = transform(arr)
        elif leaf == "bias" or path == ("gamma",):
            out[".".join(path)] = arr
        else:
            raise KeyError(f"no mapping for params:{'/'.join(path)}")
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}


# the reference config's keys, in the reference's order
REFERENCE_CONFIG_KEYS = (
    "vocab_size", "embed_dim", "num_answers", "use_se_attention",
    "use_spatial_attention", "se_reduction", "num_transformer_layers",
    "num_attention_heads", "ffn_hidden_dim", "max_question_length",
    "num_cross_layers", "use_gating", "dropout", "answer_dropout",
)
_BLOCK = re.compile(r"^image_encoder\.stage(\d)\.blocks\.(\d+)\.conv1\.weight$")


def reference_config(config: ModelConfig) -> Dict[str, Any]:
    """The ``config`` entry of a reference ``.pth``."""
    return {k: getattr(config, k) for k in REFERENCE_CONFIG_KEYS}


def model_config_from_reference(ref_config: Mapping[str, Any],
                                state_dict: Mapping[str, torch.Tensor]) -> ModelConfig:
    """A ``.pth``'s model config: its reference keys, plus the backbone
    geometry its weights' shapes give (the image size stays the default,
    which the weights do not fix)."""
    kw = {k: ref_config[k] for k in REFERENCE_CONFIG_KEYS if k in ref_config}
    stem = state_dict.get("image_encoder.stem.0.weight")
    if stem is not None:
        kw["base_channels"], kw["in_channels"] = int(stem.shape[0]), int(stem.shape[1])
    first = {}
    blocks = {}
    for key, value in state_dict.items():
        m = _BLOCK.match(key)
        if m:
            stage, block = int(m.group(1)), int(m.group(2))
            blocks[stage] = max(blocks.get(stage, 0), block + 1)
            if block == 0:
                first[stage] = int(value.shape[0])
    if sorted(first) == [1, 2, 3, 4]:
        kw["stage_channels"] = tuple(first[s] for s in (1, 2, 3, 4))
        kw["blocks_per_stage"] = tuple(blocks[s] for s in (1, 2, 3, 4))
    for stage in (3, 4):
        spatial = state_dict.get(f"image_encoder.stage{stage}.attention.spatial.conv.weight")
        if spatial is not None:
            kw["spatial_kernel_size"] = int(spatial.shape[-1])
            break
    position = state_dict.get("fusion.image_projector.position_embedding")
    if position is not None:
        kw["feature_spatial_size"] = math.isqrt(int(position.shape[1]))
    return ModelConfig(**kw)
