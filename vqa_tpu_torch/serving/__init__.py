"""Serving layer of the port. Lazy re-exports: importing
``vqa_tpu_torch.serving`` must not pull in torch, because the recycle
supervisor (``python -m vqa_tpu_torch.serving.supervisor``) lives here and
is a stdlib-only monitoring process whose RSS would otherwise carry a torch
import it never uses."""

_API = {
    "MicroBatcher": "vqa_tpu_torch.serving.batcher",
    "VQAInference": "vqa_tpu_torch.serving.engine",
    "get_inference_engine": "vqa_tpu_torch.serving.engine",
    "VQAServer": "vqa_tpu_torch.serving.server",
}

__all__ = list(_API) + ["schemas", "supervisor"]


def __getattr__(name):
    import importlib

    if name in ("schemas", "supervisor"):
        return importlib.import_module(f"vqa_tpu_torch.serving.{name}")
    mod = _API.get(name)
    if mod is None:
        raise AttributeError(f"module 'vqa_tpu_torch.serving' has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)
