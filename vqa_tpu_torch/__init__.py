"""vqa_tpu_torch — the PyTorch/CUDA port of the vqa_tpu VQA framework.

The JAX package ``vqa_tpu`` is the reference this port is held against;
module paths mirror it (``vqa_tpu_torch.models.fusion`` is the counterpart
of ``vqa_tpu.models.fusion``). The three Pallas TPU kernels of the
reference are hand-written CUDA kernels for Hopper here
(``vqa_tpu_torch/csrc``), built with ``nvcc`` on first use and bound with
ctypes (``vqa_tpu_torch.ops._build``). Each kernel keeps a plain PyTorch
version beside it, used for CPU tensors and as the on-card oracle.

This package imports torch, numpy and PIL only — never jax, flax or
anything under ``vqa_tpu``.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API: ``from vqa_tpu_torch import VQAInference``."""
    _API = {
        "VQAModel": "vqa_tpu_torch.models.vqa_model",
        "create_vqa_model": "vqa_tpu_torch.models.vqa_model",
        "count_parameters": "vqa_tpu_torch.models.vqa_model",
        "forward_logits": "vqa_tpu_torch.models.vqa_model",
        "predict_topk": "vqa_tpu_torch.models.vqa_model",
        "VQAInference": "vqa_tpu_torch.serving.engine",
        "Tokenizer": "vqa_tpu_torch.utils.tokenizer",
        "AnswerVocabulary": "vqa_tpu_torch.data.vocab",
        "ModelConfig": "vqa_tpu_torch.utils.config",
        "InferenceConfig": "vqa_tpu_torch.utils.config",
        "state_dict_from_jax": "vqa_tpu_torch.compat.jax_weights",
    }
    if name in _API:
        import importlib

        return getattr(importlib.import_module(_API[name]), name)
    raise AttributeError(f"module 'vqa_tpu_torch' has no attribute {name!r}")
