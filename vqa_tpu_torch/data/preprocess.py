"""Image and question preprocessing.

Counterpart of ``vqa_tpu/data/preprocess.py``: host decode through PIL
and bilinear resize to ``[N,S,S,3]`` uint8 (NHWC); ``device_normalize`` —
/255 and ImageNet mean/std — on a tensor on the serving device, so the host
ships uint8 pixels (4x fewer bytes than f32); the host train path
(``augment_image``: resize S+32, random crop, flip, colour jitter,
normalize, numpy with an explicit generator); its batched twin on the
card (``device_augment`` = ``draw_augment`` + ``apply_augment``); the
question helpers the HTTP layer validates with; and ``vqa_collate``.

The resize goes through the port's C++ resampler (``vqa_tpu_torch.native``,
bit-identical to PIL bilinear) when it is available, as the JAX package's
does (``vqa_tpu/data/preprocess.py:61-92``): ``resize_batch_to_uint8``, the
serving engine's and the micro-batcher's path, resizes a whole group on
its thread pool. Without it PIL resizes, to the same bytes.
"""

from __future__ import annotations

import functools
import io
from typing import Sequence, Tuple, Union

import numpy as np
import torch
from PIL import Image

from vqa_tpu_torch import native

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
    img = load_image(image)
    if native.available():
        return native.resize_bilinear(np.asarray(img, np.uint8), size, size)
    return np.asarray(img.resize((size, size), Image.BILINEAR), dtype=np.uint8)


def resize_batch_to_uint8(images: Sequence[ImageInput], size: int) -> np.ndarray:
    """Decode + resize a batch → [N, size, size, 3] u8; the native path
    resizes the batch on its thread pool (one thread per core)."""
    decoded = [load_image(im) for im in images]
    if native.available():
        return native.resize_bilinear_batch(
            [np.asarray(im, np.uint8) for im in decoded], size, size, num_threads=0)
    out = np.empty((len(decoded), size, size, 3), np.uint8)
    for i, im in enumerate(decoded):
        out[i] = np.asarray(im.resize((size, size), Image.BILINEAR), dtype=np.uint8)
    return out


def normalize_image(x: np.ndarray) -> np.ndarray:
    """[H,W,3] uint8 or [0,1] float → ImageNet-normalized float32."""
    if x.dtype == np.uint8:
        x = x.astype(np.float32) / 255.0
    return (x.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD


def denormalize_image(x: np.ndarray) -> np.ndarray:
    """Inverse of normalize_image → [0,1] float."""
    return np.clip(x * IMAGENET_STD + IMAGENET_MEAN, 0.0, 1.0)


def preprocess_image(image: ImageInput, image_size: int = 224,
                     normalize: bool = True) -> np.ndarray:
    """Val/inference path: resize (S,S) → normalize → [H,W,3] f32, or the
    resized uint8 pixels with ``normalize=False``."""
    arr = resize_to_uint8(image, image_size)
    return normalize_image(arr) if normalize else arr


def preprocess_image_bytes(data: bytes, image_size: int = 224) -> np.ndarray:
    """Bytes → resized uint8 [H,W,3] for the on-device-normalize path."""
    return resize_to_uint8(data, image_size)


_RGB2YIQ = np.array(
    [[0.299, 0.587, 0.114],
     [0.5959, -0.2746, -0.3213],
     [0.2115, -0.5227, 0.3112]],
    dtype=np.float32,
)
_YIQ2RGB = np.linalg.inv(_RGB2YIQ).astype(np.float32)
_LUMA = np.array([0.299, 0.587, 0.114], dtype=np.float32)


def augment_image(
    image: ImageInput,
    rng: np.random.Generator,
    image_size: int = 224,
    brightness: float = 0.2,
    contrast: float = 0.2,
    saturation: float = 0.2,
    hue: float = 0.1,
) -> np.ndarray:
    """Train path on the host: resize (S+32) → random crop S → h-flip p=.5
    → brightness, contrast, saturation, hue (YIQ rotation) in that order →
    normalize. Draws from ``rng`` in the JAX package's order, so the same
    generator state gives the same pixels."""
    x = resize_to_uint8(image, image_size + 32).astype(np.float32) / 255.0

    max_off = x.shape[0] - image_size
    oy, ox = rng.integers(0, max_off + 1, size=2)
    x = x[oy: oy + image_size, ox: ox + image_size]
    if rng.random() < 0.5:
        x = x[:, ::-1]

    x = x * rng.uniform(1 - brightness, 1 + brightness)
    f = rng.uniform(1 - contrast, 1 + contrast)
    gray_mean = x.mean()
    x = (x - gray_mean) * f + gray_mean
    f = rng.uniform(1 - saturation, 1 + saturation)
    gray = x @ _LUMA
    x = (x - gray[..., None]) * f + gray[..., None]
    theta = rng.uniform(-hue, hue) * 2 * np.pi
    yiq = x @ _RGB2YIQ.T
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float32)
    x = (yiq @ rot.T) @ _YIQ2RGB.T

    x = np.clip(x, 0.0, 1.0).astype(np.float32)
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def draw_augment(batch: int, source_size: int, image_size: int,
                 generator: torch.Generator, brightness: float = 0.2,
                 contrast: float = 0.2, saturation: float = 0.2,
                 hue: float = 0.1) -> dict:
    """The random draws of ``device_augment`` for a batch, from
    ``generator`` on its own device: per sample a crop offset (row, col) in
    [0, source_size − image_size], a flip, and brightness, contrast and
    saturation factors in [1 − a, 1 + a), and a hue angle in
    [−2π·hue, 2π·hue) radians."""
    dev = generator.device
    max_off = source_size - image_size

    def uniform(lo, hi):
        return torch.rand(batch, generator=generator, device=dev) * (hi - lo) + lo

    return {
        "offsets": torch.randint(0, max_off + 1, (batch, 2), generator=generator, device=dev),
        "flip": torch.rand(batch, generator=generator, device=dev) < 0.5,
        "brightness": uniform(1 - brightness, 1 + brightness),
        "contrast": uniform(1 - contrast, 1 + contrast),
        "saturation": uniform(1 - saturation, 1 + saturation),
        "hue": uniform(-hue, hue) * (2 * np.pi),
    }


def apply_augment(pixels_u8: torch.Tensor, draws: dict, image_size: int) -> torch.Tensor:
    """[B, S+32, S+32, 3] uint8 and the draws of ``draw_augment`` →
    [B, S, S, 3] f32, ImageNet-normalized, on the pixels' device: the
    per-sample crop and flip as one gather, then brightness, contrast
    (blend with the image mean), saturation (blend with per-pixel luma), hue
    (a per-sample RGB→YIQ→rotate→RGB matrix), clip to [0, 1], normalize —
    the arithmetic of the JAX package's ``device_augment``."""
    b = pixels_u8.shape[0]
    dev = pixels_u8.device
    x = pixels_u8.to(torch.float32) * (1.0 / 255.0)
    ar = torch.arange(image_size, device=dev)
    offs = draws["offsets"].to(dev)
    rows = offs[:, 0:1] + ar                                   # [B, S]
    cols = torch.where(draws["flip"].to(dev)[:, None],
                       offs[:, 1:2] + (image_size - 1 - ar), offs[:, 1:2] + ar)
    x = x[torch.arange(b, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]

    def per_sample(v):
        return v.to(device=dev, dtype=torch.float32).view(b, 1, 1, 1)

    luma, yiq2rgb, rgb2yiq, mean_t, std_inv = _augment_constants(dev)
    x = x * per_sample(draws["brightness"])
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    x = (x - mean) * per_sample(draws["contrast"]) + mean
    gray = (x @ luma)[..., None]
    x = (x - gray) * per_sample(draws["saturation"]) + gray
    theta = draws["hue"].to(device=dev, dtype=torch.float32)
    c, s = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    rot = torch.stack([torch.stack([one, zero, zero], -1),
                       torch.stack([zero, c, -s], -1),
                       torch.stack([zero, s, c], -1)], -2)          # [B, 3, 3]
    m = torch.einsum("dc,bce->bde", yiq2rgb, rot) @ rgb2yiq   # RGB → RGB per sample
    x = torch.einsum("bhwc,bdc->bhwd", x, m)
    x = torch.clamp(x, 0.0, 1.0)
    return (x - mean_t) * std_inv


@functools.lru_cache(maxsize=None)
def _augment_constants(device: torch.device) -> Tuple[torch.Tensor, ...]:
    """``apply_augment``'s constants on ``device`` (luma weights, YIQ→RGB,
    RGB→YIQ, ImageNet mean and 1/std), copied there once: the trainer
    captures the augmentation in a CUDA graph, which may not copy from host
    memory. Made outside inference mode."""
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(a, device=device) for a in (
            _LUMA, _YIQ2RGB, _RGB2YIQ, IMAGENET_MEAN, 1.0 / IMAGENET_STD))


def device_augment(pixels_u8: torch.Tensor, generator: torch.Generator,
                   image_size: int = 224, **factors) -> torch.Tensor:
    """The train-time pipeline on the card for a uint8 batch
    [B, S+32, S+32, 3]: ``draw_augment`` from ``generator`` (on the
    batch's device), then ``apply_augment``."""
    draws = draw_augment(pixels_u8.shape[0], pixels_u8.shape[1], image_size,
                         generator, **factors)
    return apply_augment(pixels_u8, draws, image_size)


@functools.lru_cache(maxsize=None)
def _normalize_constants(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """ImageNet mean and 1/std on ``device``, copied there once: a CUDA
    graph capture may not copy from host memory (the serving engine
    captures ``device_normalize``). Made outside inference mode, so that
    autograd may read them too."""
    with torch.inference_mode(False):
        return (torch.as_tensor(IMAGENET_MEAN, device=device),
                torch.as_tensor(1.0 / IMAGENET_STD, device=device))


def device_normalize(pixels_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3] → normalized f32 on the tensor's device, computed as
    the JAX twin does: (x·(1/255) − mean)·(1/std)."""
    x = pixels_uint8.to(torch.float32) * (1.0 / 255.0)
    mean, std_inv = _normalize_constants(x.device)
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


def vqa_collate(samples: Sequence[dict]) -> dict:
    """Stack per-sample dicts into batch arrays (image dtype kept: a uint8
    batch is what the trainer augments on the card)."""
    return {
        "image": np.stack([s["image"] for s in samples]),
        "token_ids": np.stack([s["token_ids"] for s in samples]).astype(np.int32),
        "attention_mask": np.stack([s["attention_mask"] for s in samples]).astype(np.int32),
        "answer": np.asarray([s["answer"] for s in samples], dtype=np.int32),
    }
