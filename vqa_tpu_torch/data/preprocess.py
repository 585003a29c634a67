"""Image and question preprocessing for the serving path.

Counterpart of ``vqa_tpu/data/preprocess.py:27-120,290-303``: host decode
and bilinear resize through PIL to ``[N,S,S,3]`` uint8 (NHWC),
``device_normalize`` — /255 and ImageNet mean/std — on a tensor on the
serving device, so the host ships uint8 pixels (4x fewer bytes than f32),
and the question helpers the HTTP layer validates with.

The JAX package resizes through its own C++ resampler, which is
bit-identical to PIL bilinear; the port uses PIL itself until that
resampler is ported, so both packages feed the model the same pixels.
"""

from __future__ import annotations

import io
from typing import Sequence, Tuple, Union

import numpy as np
import torch
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

ImageInput = Union[str, bytes, Image.Image, np.ndarray]


def load_image(image: ImageInput) -> Image.Image:
    """Open path/bytes/PIL/array as an RGB PIL image."""
    if isinstance(image, Image.Image):
        img = image
    elif isinstance(image, bytes):
        img = Image.open(io.BytesIO(image))
    elif isinstance(image, np.ndarray):
        img = Image.fromarray(image)
    else:
        img = Image.open(image)
    return img.convert("RGB")


def resize_to_uint8(image: ImageInput, size: int) -> np.ndarray:
    """Decode → RGB → bilinear resize (size, size) → [size, size, 3] u8."""
    img = load_image(image).resize((size, size), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def resize_batch_to_uint8(images: Sequence[ImageInput], size: int) -> np.ndarray:
    """Decode + resize a batch → [N, size, size, 3] u8."""
    out = np.empty((len(images), size, size, 3), np.uint8)
    for i, im in enumerate(images):
        out[i] = resize_to_uint8(im, size)
    return out


def device_normalize(pixels_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3] → normalized f32 on the tensor's device, computed as
    the JAX twin does: (x·(1/255) − mean)·(1/std)."""
    x = pixels_uint8.to(torch.float32) * (1.0 / 255.0)
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std_inv = torch.as_tensor(1.0 / IMAGENET_STD, device=x.device)
    return (x - mean) * std_inv


def normalize_question(q: str) -> str:
    """Display normalization: strip, collapse spaces, ensure trailing '?'."""
    q = " ".join(q.strip().split())
    if q and not q.endswith("?"):
        q += "?"
    return q


def validate_question(q: str, min_words: int = 2) -> Tuple[bool, str]:
    """Minimum-length validation."""
    words = q.strip().split()
    if len(words) < min_words:
        return False, f"Question must have at least {min_words} words"
    return True, ""
