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

On the card the forward is a CUDA graph per landing slot of each batch
bucket and replica, the counterpart of the JAX engine's one compiled
program per bucket (``serving/graphs.py``): ``load`` captures them, after
eager warm forwards of each bucket, so ``warmup`` (and the server's
preload) ends with every bucket captured and replayed once. Every
dispatch then copies its padded inputs, on a copy stream of the engine's
own, into the next of the bucket's two landing slots (the static inputs
of one graph each), so that the copy runs under the forward queued before
it; it replays that slot's graph on the compute stream once the copy has
landed, and returns a copy of the static probabilities. A failed capture raises, and so does
a dispatch for a bucket without a graph: nothing falls back to the eager
forward. On the CPU the engine runs eagerly. ``attention_map`` is eager
everywhere, as the JAX one is.

A model whose fusion tower is the decoder with routed experts
(``models/decoder.py``) is loaded, captured and replayed the same way;
its graphs also write the rows routed to each held expert of each MoE
layer, on the device, and every dispatch copies them out with the
probabilities. ``predict_probs_from_pixels`` reads them once the call's
probabilities are on the host and records, per dispatch, the counters
``moe.route`` and ``moe.route_max`` (``record_routes``), so no dispatch
waits for them.

Weights, in the JAX engine's order (its own checkpoint, a ``.pth``, a
random model): the port's checkpoint ``checkpoint_dir/<name>.pt`` or the
JAX trainer's Orbax directory ``checkpoint_dir/<name>/``, each with its
sidecar (``training/checkpoint.py``; the model rebuilt from the sidecar's
full config), else a reference-schema ``.pth`` (``model_state_dict`` +
``config``, loaded strictly, the backbone's geometry read from the
weights' shapes) named by ``checkpoint_dir/checkpoint_name``, else a
seeded random model.

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

Replicas (``mesh``, the JAX engine's ``mesh=`` over its 'data' axis): a
grid of devices from ``parallel.mesh_from_config(..., devices=...)`` (the
server's ``--data-parallel N`` takes ``cuda:0…N-1``; two cells may name
one card) holds one copy of the model per device. Buckets round up to a
multiple of N (``_effective_buckets``), each replica forwards its
``bucket/N`` rows, every replica is launched before any result is
gathered, and the probabilities are gathered on the first replica's
device. The attention map runs on the first replica alone.
"""

from __future__ import annotations

import copy
import os
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from vqa_tpu_torch.compat.jax_weights import model_config_from_reference
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
from vqa_tpu_torch.serving import graphs
from vqa_tpu_torch.training import checkpoint as ckpt_lib
from vqa_tpu_torch.utils.config import InferenceConfig, ModelConfig
from vqa_tpu_torch.utils.profiling import annotate, count, watch_gc
from vqa_tpu_torch.utils.tokenizer import Tokenizer

_DEFAULT_QUESTION_WORDS = [
    "what", "is", "this", "color", "how", "many", "are", "there", "the",
    "a", "in", "on", "of", "man", "woman", "dog", "cat", "doing", "wearing",
]


def forward_probs(model: VQAModel, pixels: torch.Tensor, ids: torch.Tensor,
                  mask: torch.Tensor):
    """uint8 pixels, token ids and mask on the model's device → answer
    probabilities: normalize → forward → softmax, the function each CUDA
    graph of the engine holds. A model with routed experts
    (``models/decoder.py``) gives (probabilities, the rows routed to each
    held expert of each MoE layer [layers, held] int32)."""
    logits, aux = model(device_normalize(pixels), ids.long(), mask)
    probs = torch.softmax(logits, dim=-1)
    return probs if aux is None else (probs, aux["route_counts"])


def record_routes(dispatched) -> None:
    """The counters of the dispatches of one call (probabilities carrying
    each replica's routing counts as ``route_counts``; their forwards have
    finished): per dispatch, ``moe.route``, the rows routed to the held
    experts over every layer and replica, and ``moe.route_max``, the most
    rows one held expert got in one layer."""
    replicas = len(dispatched[0][0].route_counts)
    counts = torch.stack([c.to(p.device) for p, _ in dispatched for c in p.route_counts]).cpu()
    for c in counts.view(len(dispatched), replicas, *counts.shape[1:]):
        count("moe.route", int(c.sum()))
        count("moe.route_max", int(c.max()))


def load_reference_checkpoint(path: str, device, dtype=torch.float32) -> VQAModel:
    """A reference-schema ``.pth`` → a model on ``device``, loaded strictly,
    computing in ``dtype``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("model_state_dict", ckpt)
    ref_cfg = ckpt.get("config", {}) if isinstance(ckpt, dict) else {}
    cfg = model_config_from_reference(ref_cfg, state_dict)
    with annotate("model.init"):  # no initialisation: the state is loaded over it
        model = create_vqa_model(config=cfg, device=device, init=False)
    model.load_state_dict(state_dict, strict=True)
    return model.set_compute_dtype(dtype)


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
        mesh=None,
    ):
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_name = checkpoint_name
        self.cfg = config or InferenceConfig()
        self._model_config = model_config
        if mesh is not None and (mesh.model_parallel != 1 or not mesh.devices):
            raise ValueError("serving replicas take a data-parallel grid of devices "
                             "(model_parallel=1, mesh_from_config(..., devices=...))")
        self.mesh = mesh
        self.devices = [resolve_device(d) for d in mesh.devices] if mesh else [
            resolve_device(device)]
        self.device = self.devices[0]
        self.seed = seed
        # the JAX engine's policy: bf16 off the CPU unless a dtype is given
        self.dtype = dtype or (torch.bfloat16 if self.device.type == "cuda" else torch.float32)
        self.model: Optional[VQAModel] = None
        # one model per device of the mesh; replicas[0] is self.model
        self.replicas: List[VQAModel] = []
        self.tokenizer: Optional[Tokenizer] = None
        self.answer_vocab: Optional[AnswerVocabulary] = None
        self.model_loaded_from_checkpoint = False
        self._lock = threading.Lock()
        # on the card: {bucket: one slotted graph per replica}, captured by
        # load; one lock over every feed and replay (graphs.SlottedGraph)
        self._graphed = self.device.type == "cuda"
        self._graphs: Optional[Dict[int, List[graphs.SlottedGraph]]] = None
        self._replay_lock = threading.Lock()
        # recorded on the card after each dispatch's forward on the first
        # replica (by the graph itself, a node at the end of each capture),
        # queried when the next dispatch begins: engine.dispatch's value
        self._done: Optional[torch.cuda.Event] = None

    # ------------------------------------------------------------------
    def load(self) -> "VQAInference":
        """Build or read the model, tokenizer and answer vocab, then, on
        the card, capture the forward of every effective bucket on every
        replica (raises if a capture fails). Set-up is recorded as the
        spans ``engine.load.weights`` and ``engine.load.graphs``, and from
        here on the process's garbage collections as ``python.gc``."""
        watch_gc()
        self._graphs = None
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        with annotate("engine.load.weights"):
            self.model_loaded_from_checkpoint = self._load_weights()
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
        if self._graphed:
            with annotate("engine.load.graphs"):
                self._capture_graphs()
        return self

    def _load_weights(self) -> bool:
        """``self.model`` and its replicas from the checkpoint, else a seeded
        random model; whether a checkpoint was read."""
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
                # a directory named as the checkpoint is never replaced by
                # a random model: the JAX trainer's tree needs its sidecar
                raise FileNotFoundError(
                    f"{path} is a directory but no checkpoint: a JAX trainer's "
                    f"checkpoint directory comes with {path}.meta.json")
            elif path.endswith(".pth") and os.path.exists(path):
                self.model = load_reference_checkpoint(path, self.device, self.dtype)
                loaded = True
                print(f"[Inference] loaded PyTorch checkpoint {path}")
        if not loaded:
            print("[Inference] no checkpoint — using randomly initialized model")
            self.model = create_vqa_model(
                config=self._model_config or ModelConfig(), device=self.device,
                seed=self.seed, dtype=self.dtype)
        self.replicas = [self.model] + [copy.deepcopy(self.model).to(d)
                                        for d in self.devices[1:]]
        return loaded

    def _ensure_loaded(self):
        if self.model is None:
            with self._lock:
                if self.model is None:
                    self.load()

    def _capture_graphs(self) -> None:
        """A graph per landing slot of each effective bucket on each
        replica, each replica's graphs in one memory pool, with the
        replica's copy stream (``graphs.capture_replica``)."""
        size = self.model.config.image_size
        captured: Dict[int, List[graphs.SlottedGraph]] = {}
        buckets = self._effective_buckets()
        # an external event: recorded inside a capture, it is a node of the
        # graph that every replay records again, at no cost to the host
        self._done = torch.cuda.Event(external=True) if self.device.type == "cuda" else None
        for model, device in zip(self.replicas, self.devices):
            done = self._done if model is self.model else None
            inputs = {}
            for b in buckets:
                rows = b // len(self.replicas)
                ids, mask = self.tokenizer.encode_batch_np(["warm up question"] * rows)
                inputs[b] = [torch.zeros((rows, size, size, 3), dtype=torch.uint8, device=device),
                             torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)]
            with torch.inference_mode():
                graphed = graphs.capture_replica(
                    lambda *t, model=model: forward_probs(model, *t), inputs, done)
            for b in buckets:
                captured.setdefault(b, []).append(graphed[b])
        self._graphs = captured
        print(f"[Inference] captured a CUDA graph per bucket {tuple(buckets)} on each of "
              f"{len(self.replicas)} replica(s)")

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Load (on the card: capture) and run the full ``predict_batch_raw``
        path once per batch bucket, so the first real request pays no
        kernel build, capture or first-launch cost."""
        self._ensure_loaded()
        size = self.model.config.image_size
        img = np.zeros((size, size, 3), np.uint8)
        buckets = buckets or self._effective_buckets()
        for b in buckets:
            self.predict_batch_raw([img] * b, ["warm up question"] * b)
        print(f"[Inference] warmed buckets {tuple(buckets)}")

    # ------------------------------------------------------------------
    def _effective_buckets(self) -> List[int]:
        """The configured buckets, each rounded up to a multiple of the
        replica count so a batch splits evenly over the replicas."""
        dp = len(self.devices)
        out: List[int] = []
        for b in self.cfg.batch_buckets:
            eb = -(-b // dp) * dp
            if eb not in out:
                out.append(eb)
        return out

    def _bucket(self, n: int) -> int:
        """Smallest bucket that fits n; callers chunk larger requests."""
        buckets = self._effective_buckets()
        for b in buckets:
            if n <= b:
                return b
        raise AssertionError(
            f"batch {n} exceeds the largest bucket {buckets[-1]}; "
            "caller must chunk (predict_probs_from_pixels does)")

    def _stage(self, device: torch.device, *arrays: np.ndarray) -> List[torch.Tensor]:
        """Host arrays → host tensors that a copy to ``device`` reads
        without waiting on the card.

        A copy from pageable memory would block the host until the stream's
        earlier work (the previous forward) finishes; a copy from pinned
        memory is queued. Each array is copied into a block from PyTorch's
        pinned host allocator, which keeps the block until the copy's event
        has passed, so it may go out of scope once the copy is queued.
        (``Tensor.pin_memory()`` would first ask the CUDA runtime whether
        the numpy memory is pinned, a slow query for memory it did not
        allocate.) For the CPU the arrays' own memory."""
        tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if device.type == "cpu":
            return tensors
        out = []
        for t in tensors:
            staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            staged.copy_(t)
            out.append(staged)
        return out

    def _to_device(self, pixels: np.ndarray, ids: np.ndarray, mask: np.ndarray,
                   device: Optional[torch.device] = None):
        """Host arrays → tensors on the device without waiting on the card."""
        device = device or self.device
        return [t.to(device, non_blocking=True)
                for t in self._stage(device, pixels, ids, mask)]

    def _preprocess_images(self, images: Sequence[ImageInput]) -> np.ndarray:
        """Decode and resize → [N, S, S, 3] u8 (what the micro-batcher calls)."""
        self._ensure_loaded()
        return resize_batch_to_uint8(images, self.model.config.image_size)

    def _padded(self, pixels: np.ndarray, questions):
        """(pixels, ids, mask) padded to the bucket by repeating the first
        row, n and the bucket. n must fit the largest bucket."""
        n = len(questions)
        bucket = self._bucket(n)
        ids, mask = self.tokenizer.encode_batch_np(list(questions))
        if bucket > n:
            pad = bucket - n
            pixels = np.concatenate([pixels, np.repeat(pixels[:1], pad, 0)])
            ids = np.concatenate([ids, np.repeat(ids[:1], pad, 0)])
            mask = np.concatenate([mask, np.repeat(mask[:1], pad, 0)])
        return (pixels, ids, mask), n, bucket

    def _gather(self, outs: List) -> torch.Tensor:
        """Every replica is launched; gather on the first one's device. A
        forward that also gives its routing counts (``forward_probs``'s
        (probabilities, counts)) has them carried on the gathered
        probabilities, one tensor a replica, as ``route_counts`` (read at
        the fetch, ``record_routes``)."""
        routed = isinstance(outs[0], tuple)
        probs = [o[0] for o in outs] if routed else outs
        out = (probs[0] if len(probs) == 1
               else torch.cat([p.to(self.device, non_blocking=True) for p in probs]))
        if routed:
            out.route_counts = [o[1] for o in outs]
        return out

    def dispatch_probs_from_pixels(self, pixels: np.ndarray, questions):
        """Pad to a bucket and launch the forward: returns the padded
        probabilities on the device (not yet fetched) and n, without
        waiting on the card, so the caller can prepare the next batch while
        this one runs. n must fit the largest bucket.

        On the card each replica stages its rows in pinned memory, queues
        their copy into the bucket's next landing slot on its copy stream,
        replays that slot's graph on the compute stream once the copy has
        landed and copies the static output out, so every dispatch returns
        a tensor of its own, however many are in flight.

        Recorded as the span ``engine.dispatch``, whose value is 1 where the
        card had finished every earlier dispatch's forward when this one
        began (the host kept it waiting) and 0 where work was still queued,
        with three phases: ``engine.tokenize`` (``_padded``),
        ``engine.stage`` (every replica's staging and the copies queued, the
        replay lock's wait included) and ``engine.replay`` (replay and copy
        out of every replica; the eager path's copies and forward).
        ``engine.stage``'s value is 1 where a replica's landing slot was
        still held by a forward the card had not finished, so its copy
        waits on the copy stream, and 0 where every slot was free (always
        0 on the eager path)."""
        with annotate("engine.dispatch") as span, torch.inference_mode():
            self._ensure_loaded()
            span.value = int(self._done is None or self._done.query())
            if not self._graphed:
                return self._dispatch_eager(pixels, questions, span)
            span.phase("engine.tokenize")
            arrays, n, bucket = self._padded(pixels, questions)
            bucket_graphs = (self._graphs or {}).get(bucket)
            if bucket_graphs is None:
                raise RuntimeError(
                    f"no CUDA graph for bucket {bucket} (captured: "
                    f"{sorted(self._graphs or {})}); load captures every effective bucket")
            per = bucket // len(bucket_graphs)
            span.phase("engine.stage")
            staged = [self._stage(d, *(a[i * per:(i + 1) * per] for a in arrays))
                      for i, d in enumerate(self.devices)]
            # switching streams switches the current device: the caller's
            # is put back at the end
            with self._replay_lock, graphs.on_device(self.device):
                held = [g.feed(s) for g, s in zip(bucket_graphs, staged)]
                span.phase_value = max(held)
                span.phase("engine.replay")
                probs = [g.replay() for g in bucket_graphs]
            return self._gather(probs), n

    @torch.inference_mode()
    def _dispatch_eager(self, pixels: np.ndarray, questions, span=None):
        """``dispatch_probs_from_pixels`` through the eager forward: the
        CPU's path, and on the card the yardstick the graphs are timed and
        checked against (no request takes it there). ``span``: the
        dispatch's, whose phases it records."""
        self._ensure_loaded()
        phase = span.phase if span is not None else (lambda name: None)
        phase("engine.tokenize")
        arrays, n, bucket = self._padded(pixels, questions)
        per = bucket // len(self.replicas)
        phase("engine.stage")
        staged = [self._stage(d, *(a[i * per:(i + 1) * per] for a in arrays))
                  for i, d in enumerate(self.devices)]
        phase("engine.replay")
        probs = [forward_probs(model, *(t.to(d, non_blocking=True) for t in s))
                 for model, d, s in zip(self.replicas, self.devices, staged)]
        if self.device.type == "cuda":  # (the CPU has no queue to wait on)
            self._done = self._done or torch.cuda.Event()
            with torch.cuda.device(self.device):
                self._done.record()
        return self._gather(probs), n

    def predict_probs_from_pixels(self, pixels: np.ndarray,
                                  questions: Sequence[str]) -> np.ndarray:
        """Pre-resized uint8 pixels [N,S,S,3] + questions → probabilities
        [N, num_answers]."""
        self._ensure_loaded()
        n = len(questions)
        if n == 0:
            return np.zeros((0, self.model.config.num_answers), np.float32)
        max_bucket = self._effective_buckets()[-1]
        dispatched = [
            self.dispatch_probs_from_pixels(pixels[i:i + max_bucket],
                                            questions[i:i + max_bucket])
            for i in range(0, n, max_bucket)
        ]
        with annotate("engine.fetch"):  # the host waits here for the card
            out = np.concatenate([p.cpu().numpy()[:k] for p, k in dispatched])
            if hasattr(dispatched[0][0], "route_counts"):
                record_routes(dispatched)
            return out

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
