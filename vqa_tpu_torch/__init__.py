"""vqa_tpu_torch — the PyTorch/CUDA port of the vqa_tpu VQA framework.

The JAX package ``vqa_tpu`` is the reference this port is held against;
module paths mirror it (``vqa_tpu_torch.models.fusion`` is the counterpart
of ``vqa_tpu.models.fusion``). The three Pallas TPU kernels of the
reference are hand-written CUDA kernels for Hopper here
(``vqa_tpu_torch/csrc``), built with ``nvcc`` on first use and bound with
ctypes (``vqa_tpu_torch.ops._build``). Each kernel keeps a plain PyTorch
version beside it, used for CPU tensors and as the on-card oracle.

This package imports torch, numpy and PIL only — never jax, flax or
anything under ``vqa_tpu``. Its host resize runs in its own C++ library
(``vqa_tpu_torch/native``), built with g++ on first use.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API, the JAX package's (``vqa_tpu/__init__.py:20-46``):
    ``from vqa_tpu_torch import VQAInference``. ``load_torch_checkpoint``
    loads a reference-schema ``.pth`` (``serving/engine.py:
    load_reference_checkpoint``). ``init_vqa_model`` has no counterpart:
    ``create_vqa_model`` returns an initialised model (seeded weights)."""
    _API = {
        "VQAModel": ("vqa_tpu_torch.models.vqa_model", "VQAModel"),
        "create_vqa_model": ("vqa_tpu_torch.models.vqa_model", "create_vqa_model"),
        "predict_topk": ("vqa_tpu_torch.models.vqa_model", "predict_topk"),
        "forward_logits": ("vqa_tpu_torch.models.vqa_model", "forward_logits"),
        "count_parameters": ("vqa_tpu_torch.models.vqa_model", "count_parameters"),
        "Trainer": ("vqa_tpu_torch.training.train", "Trainer"),
        "Evaluator": ("vqa_tpu_torch.training.evaluate", "Evaluator"),
        "VQAInference": ("vqa_tpu_torch.serving.engine", "VQAInference"),
        "VQAServer": ("vqa_tpu_torch.serving.server", "VQAServer"),
        "MicroBatcher": ("vqa_tpu_torch.serving.batcher", "MicroBatcher"),
        "Tokenizer": ("vqa_tpu_torch.utils.tokenizer", "Tokenizer"),
        "AnswerVocabulary": ("vqa_tpu_torch.data.vocab", "AnswerVocabulary"),
        "VQADataset": ("vqa_tpu_torch.data.dataset", "VQADataset"),
        "create_train_val_loaders": ("vqa_tpu_torch.data.dataset", "create_train_val_loaders"),
        "create_demo_loaders": ("vqa_tpu_torch.data.dataset", "create_demo_loaders"),
        "create_mesh": ("vqa_tpu_torch.parallel.mesh", "create_mesh"),
        "ModelConfig": ("vqa_tpu_torch.utils.config", "ModelConfig"),
        "TrainingConfig": ("vqa_tpu_torch.utils.config", "TrainingConfig"),
        "InferenceConfig": ("vqa_tpu_torch.utils.config", "InferenceConfig"),
        "load_torch_checkpoint": ("vqa_tpu_torch.serving.engine", "load_reference_checkpoint"),
        "state_dict_from_jax": ("vqa_tpu_torch.compat.jax_weights", "state_dict_from_jax"),
    }
    if name in _API:
        import importlib

        module, attr = _API[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'vqa_tpu_torch' has no attribute {name!r}")
