"""Render cross-attention heatmaps for a (checkpoint, image, question).

    python -m vqa_tpu_torch.tools.visualize_attention --checkpoint-dir D \
        --image scene.jpg --question "what color is the circle" --out attn/
    python -m vqa_tpu_torch.tools.visualize_attention --device cpu ...

Counterpart of ``scripts/visualize_attention.py:1-94``. The question's
cross-attention over the image grid comes from ``get_attention_maps``
(``models/vqa_model.py:338``): the probabilities the cross-attention kernel
returns in the eval forward. Per layer, the heads' mean over the question's
real tokens, and the mean over layers and heads
(``attention_visualization``), are each upsampled bilinearly and blended
in red over the resized input, one PNG each:
``cross_attention_layer{i}.png`` and ``cross_attention_mean.png``. The
model runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import numpy as np
from PIL import Image


def attention_heats(maps: dict, mask: np.ndarray, side: int) -> Dict[str, np.ndarray]:
    """``get_attention_maps`` of one image and question (batch 1) and its
    token mask [L_q] → {"layer{i}": [side, side], ..., "mean": [side, side]},
    each the mean over the question's real tokens."""
    valid = np.asarray(mask).astype(bool)
    heats = {}
    for layer, w in enumerate(maps["cross_attention"]):
        w = w.float().cpu().numpy()[0].mean(0).reshape(-1, side, side)  # [L_q, s, s]
        heats[f"layer{layer}"] = w[valid].mean(0)
    spatial = maps["cross_attention_spatial"].float().cpu().numpy()[0]
    heats["mean"] = spatial[valid].mean(0)
    return heats


def overlay(pixels: np.ndarray, heat: np.ndarray) -> np.ndarray:
    """[S, S, 3] u8 image and a [s, s] heat → the heat, scaled to [0, 1] and
    upsampled to S, blended in red over the image (u8)."""
    size = pixels.shape[0]
    heat = (heat - heat.min()) / max(heat.max() - heat.min(), 1e-9)
    heat_img = Image.fromarray((heat * 255).astype(np.uint8)).resize((size, size),
                                                                     Image.BILINEAR)
    base = pixels.astype(np.float32)
    h = np.asarray(heat_img, np.float32)[..., None] / 255.0
    red = np.zeros_like(base)
    red[..., 0] = 255
    return (base * (1 - 0.6 * h) + red * 0.6 * h).astype(np.uint8)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--checkpoint", default="best_model")
    p.add_argument("--image", required=True)
    p.add_argument("--question", required=True)
    p.add_argument("--out", default="attention_maps")
    p.add_argument("--device", default="cuda", help="cpu only when asked")
    args = p.parse_args(argv)

    import torch

    from vqa_tpu_torch.data.preprocess import device_normalize, resize_to_uint8
    from vqa_tpu_torch.models.vqa_model import get_attention_maps
    from vqa_tpu_torch.training.checkpoint import load_model_for_inference
    from vqa_tpu_torch.utils.tokenizer import Tokenizer

    model = load_model_for_inference(args.checkpoint_dir, args.checkpoint, device=args.device)
    device = next(model.parameters()).device
    tokenizer = Tokenizer(max_length=model.config.max_question_length)
    tok_path = os.path.join(args.checkpoint_dir, "tokenizer.json")
    if os.path.exists(tok_path):
        tokenizer.load(tok_path)
    else:
        tokenizer.build_vocab([args.question], min_freq=1)

    size = model.config.image_size
    pixels = resize_to_uint8(args.image, size)
    ids, mask = tokenizer.encode_batch_np([args.question])
    images = device_normalize(torch.from_numpy(pixels[None]).to(device))
    maps = get_attention_maps(model, images, torch.from_numpy(ids).to(device).long(),
                              torch.from_numpy(mask).to(device))
    heats = attention_heats(maps, mask[0], model.config.feature_spatial_size)

    os.makedirs(args.out, exist_ok=True)
    for name, heat in heats.items():
        path = os.path.join(args.out, f"cross_attention_{name}.png")
        Image.fromarray(overlay(pixels, heat)).save(path)
        print(f"wrote {path} (peak cell: {np.unravel_index(heat.argmax(), heat.shape)})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
