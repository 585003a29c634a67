"""Export a JAX trainer's checkpoint directory to a reference-schema
``.pth``, with nothing but the port installed.

Counterpart of ``vqa_tpu/compat/torch_export.py:244-283``, which needs
JAX, flax and orbax: this one reads the Orbax tree with
``training/checkpoint.py:load_orbax_checkpoint`` and maps it with
``compat/jax_weights.py:state_dict_from_jax``, and writes the same file:
``model_state_dict``, the reference ``config`` (the ``VQAModel(**config)``
keyword arguments), ``epoch``, ``best_val_accuracy``,
``metrics_history``, and empty optimizer and scheduler states.

The reference config keeps no CNN geometry;
``compat/jax_weights.py:model_config_from_reference`` reads it back from
the weights' shapes, so a checkpoint of any backbone width loads
(``serving/engine.py:load_reference_checkpoint``).

    python -m vqa_tpu_torch.compat.torch_export --checkpoint-dir D \\
        --which best_model --out X.pth
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch


def export_checkpoint_dir(checkpoint_dir: str, out_path: str, which: str = "best_model"
                          ) -> None:
    """Write the reference ``.pth`` of ``<checkpoint_dir>/<which>``, an
    Orbax tree and its sidecar as the JAX trainer saves them."""
    from vqa_tpu_torch.compat.jax_weights import reference_config, state_dict_from_jax
    from vqa_tpu_torch.compat.orbax import inference_variables
    from vqa_tpu_torch.training.checkpoint import load_orbax_checkpoint

    tree, config, meta = load_orbax_checkpoint(checkpoint_dir, which)
    # the JAX exporter's np.ascontiguousarray makes each 0-d tensor (the
    # num_batches_tracked counters) 1-d; a strict load takes either
    state_dict = {k: v.reshape(1) if v.dim() == 0 else v
                  for k, v in state_dict_from_jax(inference_variables(tree), config).items()}
    torch.save({
        "epoch": int(meta.get("epoch", 0)),
        "model_state_dict": state_dict,
        "optimizer_state_dict": {},
        "scheduler_state_dict": {},
        "best_val_accuracy": float(meta.get("best_val_accuracy", 0.0)),
        "config": reference_config(config),
        "metrics_history": meta.get("metrics_history") or {},
    }, out_path)


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(
        description="Export a JAX trainer checkpoint directory (Orbax tree + sidecar) to a "
        "reference-compatible PyTorch .pth, without JAX or orbax.")
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--out", required=True, help="output .pth path")
    p.add_argument("--which", default="best_model", choices=["best_model", "latest"],
                   help="which checkpoint in the directory to export")
    args = p.parse_args(argv)
    export_checkpoint_dir(args.checkpoint_dir, args.out, which=args.which)
    print(f"[export] {args.which} from {args.checkpoint_dir} → {args.out}")


if __name__ == "__main__":
    main()
