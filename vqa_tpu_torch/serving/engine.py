"""Inference engine: model loading + bucket-batched forward on the card.

Counterpart of ``vqa_tpu/serving/engine.py``, with the same degradation
chain — no checkpoint → seeded random model at the configured width; no
tokenizer JSON → a tiny built-in vocab; no answer vocab → ``answer_i``
placeholders — and the same request mechanics:

- requests are padded to the smallest batch bucket (1/4/16/32) that fits
  by repeating the first row, so the card sees a few fixed batch shapes;
  requests larger than the largest bucket are cut into chunks of it, all
  launched before any result is fetched;
- the host ships uint8 pixels, staged through pinned memory so that
  ``dispatch_probs_from_pixels`` returns before the card finishes; /255
  and ImageNet normalize run on the card.

Weights, in the JAX engine's order (its own checkpoint, a ``.pth``, a
random model): the port's checkpoint ``checkpoint_dir/<name>.pt`` with its
sidecar (``training/checkpoint.py``; the model rebuilt from the sidecar's
full config), else a reference-schema ``.pth`` (``model_state_dict`` +
``config``, loaded strictly) named by ``checkpoint_dir/checkpoint_name``,
else a seeded random model. The JAX package's Orbax checkpoints are not
read yet: export one with ``python -m vqa_tpu.compat.torch_export`` first.

The engine runs on ``device="cuda"`` unless the caller asks for the CPU,
and raises when no CUDA device is present. Its compute dtype is the JAX
engine's (``engine.py:83-87``): ``dtype=None`` picks bf16 on the card and
f32 on the CPU, and an explicit ``dtype`` overrides either. In bf16 the
model computes from bf16 copies of its weights and runs the kernels' bf16
forms (``models/layers.py``); pixels are normalized in f32 and then cast,
and the logits, probabilities and attention maps come back f32. On the
card the engine turns TF32 off for cuDNN convolutions and matmuls, which
matters for f32: cuDNN's TF32 default keeps ~3 decimal digits per conv,
which over the backbone's 17 convs would spend the whole 1e-3 logit budget
the f32 port is held to.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from vqa_tpu_torch.data.preprocess import (
    ImageInput,
    device_normalize,
    resize_batch_to_uint8,
)
from vqa_tpu_torch.data.vocab import AnswerVocabulary
from vqa_tpu_torch.models.fusion import attention_visualization
from vqa_tpu_torch.models.vqa_model import (
    VQAModel,
    count_parameters,
    create_vqa_model,
    resolve_device,
)
from vqa_tpu_torch.training import checkpoint as ckpt_lib
from vqa_tpu_torch.utils.config import InferenceConfig, ModelConfig
from vqa_tpu_torch.utils.tokenizer import Tokenizer

_DEFAULT_QUESTION_WORDS = [
    "what", "is", "this", "color", "how", "many", "are", "there", "the",
    "a", "in", "on", "of", "man", "woman", "dog", "cat", "doing", "wearing",
]

# reference checkpoint config keys → ModelConfig fields (the reference keeps
# no CNN geometry, so those stay at their defaults)
_REFERENCE_CONFIG_KEYS = (
    "vocab_size", "embed_dim", "num_answers", "use_se_attention",
    "use_spatial_attention", "se_reduction", "num_transformer_layers",
    "num_attention_heads", "ffn_hidden_dim", "max_question_length",
    "num_cross_layers", "use_gating", "dropout", "answer_dropout",
)


def load_reference_checkpoint(path: str, device, dtype=torch.float32) -> VQAModel:
    """A reference-schema ``.pth`` → a model on ``device``, loaded strictly,
    computing in ``dtype``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("model_state_dict", ckpt)
    ref_cfg = ckpt.get("config", {}) if isinstance(ckpt, dict) else {}
    cfg = ModelConfig(**{k: ref_cfg[k] for k in _REFERENCE_CONFIG_KEYS if k in ref_cfg})
    model = create_vqa_model(config=cfg, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    return model.to(device).set_compute_dtype(dtype)


class VQAInference:
    """Lazy-loading inference engine."""

    def __init__(
        self,
        checkpoint_dir: Optional[str] = None,
        checkpoint_name: str = "best_model",
        config: Optional[InferenceConfig] = None,
        model_config: Optional[ModelConfig] = None,
        device="cuda",
        seed: int = 0,
        dtype: Optional[torch.dtype] = None,
    ):
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_name = checkpoint_name
        self.cfg = config or InferenceConfig()
        self._model_config = model_config
        self.device = resolve_device(device)
        self.seed = seed
        # the JAX engine's policy: bf16 off the CPU unless a dtype is given
        self.dtype = dtype or (torch.bfloat16 if self.device.type == "cuda" else torch.float32)
        self.model: Optional[VQAModel] = None
        self.tokenizer: Optional[Tokenizer] = None
        self.answer_vocab: Optional[AnswerVocabulary] = None
        self.model_loaded_from_checkpoint = False
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def load(self) -> "VQAInference":
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False

        loaded = False
        if self.checkpoint_dir:
            path = os.path.join(self.checkpoint_dir, self.checkpoint_name)
            if ckpt_lib.checkpoint_exists(self.checkpoint_dir, self.checkpoint_name):
                self.model = ckpt_lib.load_model_for_inference(
                    self.checkpoint_dir, self.checkpoint_name, device=self.device,
                    dtype=self.dtype)
                loaded = True
                print(f"[Inference] loaded checkpoint {self.checkpoint_name}")
            elif os.path.isdir(path):
                raise NotImplementedError(
                    f"{path} looks like an Orbax checkpoint, which the port does "
                    "not read yet; export it with "
                    "`python -m vqa_tpu.compat.torch_export --checkpoint-dir ... "
                    "--out X.pth` and load the .pth")
            elif path.endswith(".pth") and os.path.exists(path):
                self.model = load_reference_checkpoint(path, self.device, self.dtype)
                loaded = True
                print(f"[Inference] loaded PyTorch checkpoint {path}")
        if not loaded:
            print("[Inference] no checkpoint — using randomly initialized model")
            self.model = create_vqa_model(
                config=self._model_config or ModelConfig(), device=self.device,
                seed=self.seed, dtype=self.dtype)
        self.model_loaded_from_checkpoint = loaded
        mcfg = self.model.config

        tok_path = (os.path.join(self.checkpoint_dir, "tokenizer.json")
                    if self.checkpoint_dir else None)
        self.tokenizer = Tokenizer(max_length=mcfg.max_question_length)
        if tok_path and os.path.exists(tok_path):
            self.tokenizer.load(tok_path)
        else:
            self.tokenizer.build_vocab([" ".join(_DEFAULT_QUESTION_WORDS)], min_freq=1)

        vocab_path = (os.path.join(self.checkpoint_dir, "answer_vocab.json")
                      if self.checkpoint_dir else None)
        self.answer_vocab = AnswerVocabulary(num_answers=mcfg.num_answers)
        if vocab_path and os.path.exists(vocab_path):
            self.answer_vocab.load(vocab_path)
        else:
            self.answer_vocab.answer2idx = {f"answer_{i}": i for i in range(mcfg.num_answers)}
            self.answer_vocab.idx2answer = {i: f"answer_{i}" for i in range(mcfg.num_answers)}
            self.answer_vocab._is_built = True
        return self

    def _ensure_loaded(self):
        if self.model is None:
            with self._lock:
                if self.model is None:
                    self.load()

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run the full ``predict_batch_raw`` path once per batch bucket, so
        the first real request pays no kernel build or first-launch cost."""
        self._ensure_loaded()
        size = self.model.config.image_size
        img = np.zeros((size, size, 3), np.uint8)
        for b in buckets or self.cfg.batch_buckets:
            self.predict_batch_raw([img] * b, ["warm up question"] * b)
        print(f"[Inference] warmed buckets {tuple(buckets or self.cfg.batch_buckets)}")

    # ------------------------------------------------------------------
    def _bucket(self, n: int) -> int:
        """Smallest bucket that fits n; callers chunk larger requests."""
        for b in self.cfg.batch_buckets:
            if n <= b:
                return b
        raise AssertionError(
            f"batch {n} exceeds the largest bucket {self.cfg.batch_buckets[-1]}; "
            "caller must chunk (predict_probs_from_pixels does)")

    def _to_device(self, pixels: np.ndarray, ids: np.ndarray, mask: np.ndarray):
        """Host arrays → tensors on the device without waiting on the card.

        A copy from pageable memory would block the host until the stream's
        earlier work (the previous forward) finishes; a copy from pinned
        memory is queued. Each array is copied into a block from PyTorch's
        pinned host allocator, which keeps the block until the copy's event
        has passed, so it may go out of scope here. (``Tensor.pin_memory()``
        would first ask the CUDA runtime whether the numpy memory is pinned,
        a slow query for memory it did not allocate.)"""
        tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in (pixels, ids, mask)]
        if self.device.type == "cpu":
            return tensors
        out = []
        for t in tensors:
            staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            staged.copy_(t)
            out.append(staged.to(self.device, non_blocking=True))
        return out

    def _preprocess_images(self, images: Sequence[ImageInput]) -> np.ndarray:
        """Decode and resize → [N, S, S, 3] u8 (what the micro-batcher calls)."""
        self._ensure_loaded()
        return resize_batch_to_uint8(images, self.model.config.image_size)

    @torch.inference_mode()
    def dispatch_probs_from_pixels(self, pixels: np.ndarray, questions):
        """Pad to a bucket and launch the forward: returns the padded
        probabilities on the device (not yet fetched) and n, without
        waiting on the card, so the caller can prepare the next batch while
        this one runs. n must fit the largest bucket."""
        self._ensure_loaded()
        n = len(questions)
        bucket = self._bucket(n)
        ids, mask = self.tokenizer.encode_batch_np(list(questions))
        if bucket > n:
            pad = bucket - n
            pixels = np.concatenate([pixels, np.repeat(pixels[:1], pad, 0)])
            ids = np.concatenate([ids, np.repeat(ids[:1], pad, 0)])
            mask = np.concatenate([mask, np.repeat(mask[:1], pad, 0)])
        pixels_t, ids_t, mask_t = self._to_device(pixels, ids, mask)
        logits, _ = self.model(device_normalize(pixels_t), ids_t.long(), mask_t)
        return torch.softmax(logits, dim=-1), n

    def predict_probs_from_pixels(self, pixels: np.ndarray,
                                  questions: Sequence[str]) -> np.ndarray:
        """Pre-resized uint8 pixels [N,S,S,3] + questions → probabilities
        [N, num_answers]."""
        self._ensure_loaded()
        n = len(questions)
        if n == 0:
            return np.zeros((0, self.model.config.num_answers), np.float32)
        max_bucket = self.cfg.batch_buckets[-1]
        dispatched = [
            self.dispatch_probs_from_pixels(pixels[i:i + max_bucket],
                                            questions[i:i + max_bucket])
            for i in range(0, n, max_bucket)
        ]
        return np.concatenate([p.cpu().numpy()[:k] for p, k in dispatched])

    def predict_batch_raw(self, images: Sequence[ImageInput],
                          questions: Sequence[str]) -> np.ndarray:
        """Batched probabilities [N, num_answers]: decode/resize, then the
        pixels forward. The serving hot path."""
        self._ensure_loaded()
        if len(images) == 0:
            return np.zeros((0, self.model.config.num_answers), np.float32)
        pixels = self._preprocess_images(images)
        return self.predict_probs_from_pixels(pixels, questions)

    def _format_result(self, question: str, probs: np.ndarray, top_k: int
                       ) -> Dict[str, Any]:
        top_idx = np.argsort(-probs)[:top_k]
        answers = [
            {"answer": self.answer_vocab.decode(int(i)),
             "probability": float(probs[i]), "index": int(i)}
            for i in top_idx
        ]
        return {
            "question": question,
            "answers": answers,
            "top_answer": answers[0]["answer"],
            "confidence": answers[0]["probability"],
        }

    def predict(self, image: ImageInput, question: str,
                top_k: Optional[int] = None) -> Dict[str, Any]:
        """Single prediction."""
        probs = self.predict_batch_raw([image], [question])[0]
        return self._format_result(question, probs, top_k or self.cfg.top_k)

    @torch.inference_mode()
    def attention_map(self, image: ImageInput, question: str,
                      top_k: Optional[int] = None) -> Dict[str, Any]:
        """Prediction plus the question's cross-attention heatmap over the
        image grid: per real token, the layer- and head-averaged [S, S]
        map."""
        self._ensure_loaded()
        cfg = self.model.config
        pixels = self._preprocess_images([image])
        ids, mask = self.tokenizer.encode_batch_np([question])
        pixels_t, ids_t, mask_t = self._to_device(pixels, ids, mask)
        logits, aux = self.model(device_normalize(pixels_t), ids_t.long(), mask_t,
                                 return_aux=True)
        spatial = attention_visualization(
            aux["cross_attention_weights"], cfg.feature_spatial_size)
        probs = torch.softmax(logits, dim=-1)[0].cpu().numpy()
        spatial = spatial[0].float().cpu().numpy()  # [L, S, S]
        n_tokens = int(mask[0].sum())
        tokens = [self.tokenizer.idx2word.get(int(t), "<UNK>") for t in ids[0][:n_tokens]]
        result = self._format_result(question, probs, top_k or self.cfg.top_k)
        result["attention"] = {
            "tokens": tokens,
            "spatial_size": int(cfg.feature_spatial_size),
            "maps": spatial[:n_tokens].tolist(),
        }
        return result

    def predict_batch(self, images: Sequence[ImageInput], questions: Sequence[str],
                      top_k: Optional[int] = None) -> List[Dict[str, Any]]:
        """Batch prediction."""
        top_k = top_k or self.cfg.top_k
        probs = self.predict_batch_raw(images, questions)
        return [self._format_result(q, p, top_k) for q, p in zip(questions, probs)]

    def get_model_info(self) -> Dict[str, Any]:
        """The JAX engine's keys; ``backend`` is ``"gpu"`` on the card and
        ``"cpu"`` on the CPU, as ``jax.default_backend()`` names them. No
        ``device`` key: the server derives its served ``device`` field from
        ``backend`` and then spreads this dict over it."""
        self._ensure_loaded()
        cfg = self.model.config
        return {
            "model_loaded": self.model_loaded_from_checkpoint,
            "embed_dim": cfg.embed_dim,
            "num_answers": cfg.num_answers,
            "vocab_size": cfg.vocab_size,
            "max_question_length": cfg.max_question_length,
            "image_size": cfg.image_size,
            "parameters": count_parameters(self.model),
            "backend": "gpu" if self.device.type == "cuda" else self.device.type,
        }


_ENGINE: Optional[VQAInference] = None
_ENGINE_LOCK = threading.Lock()


def get_inference_engine(checkpoint_dir: Optional[str] = None, **kwargs) -> VQAInference:
    """Lazy process-wide engine, loaded on first call."""
    global _ENGINE
    if _ENGINE is None:
        with _ENGINE_LOCK:
            if _ENGINE is None:
                _ENGINE = VQAInference(checkpoint_dir=checkpoint_dir, **kwargs)
                _ENGINE.load()
    return _ENGINE


def reset_engine() -> None:
    global _ENGINE
    _ENGINE = None
