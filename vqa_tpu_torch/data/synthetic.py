"""Synthetic learnable VQA data: colored shapes + programmatic questions.

Counterpart of ``vqa_tpu/data/synthetic.py`` (a copy: the same
``(seed, index)`` gives byte-identical samples, and the same vocabularies).
Images a VQA model can learn without downloading COCO: 1-3 colored shapes
(circle / square / triangle) on a plain background with three question
families —

    "what color is the {shape}"   → color name
    "how many shapes are there"   → "1" | "2" | "3"
    "is there a {shape}"          → "yes" | "no"

Everything is deterministic per (seed, index). Samples follow the same dict
protocol as VQADataset (image/token_ids/attention_mask/answer/question_type/
annotator_answers), so BatchLoader and the Trainer consume them unchanged;
``--synthetic`` in the train CLI wires it up.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import threading
import numpy as np
from PIL import Image, ImageDraw

from vqa_tpu_torch.data.preprocess import augment_image, normalize_image
from vqa_tpu_torch.data.vocab import AnswerVocabulary
from vqa_tpu_torch.utils.tokenizer import Tokenizer, create_tokenizer_from_questions

COLORS = {
    "red": (220, 50, 40),
    "green": (50, 180, 70),
    "blue": (40, 90, 220),
    "yellow": (235, 220, 50),
    "purple": (150, 60, 200),
    "orange": (240, 140, 30),
}
SHAPES = ("circle", "square", "triangle")
ANSWERS = list(COLORS) + ["1", "2", "3", "yes", "no"]
# 2x2 grid cell → position name (cells: 0 top-left, 1 top-right,
# 2 bottom-left, 3 bottom-right — see _draw_scene's cx/cy layout)
POSITIONS = ("top left", "top right", "bottom left", "bottom right")
SPATIAL_ANSWERS = ANSWERS + list(SHAPES)
# spatial-corpus rendering: radius 13-21% of the image side (vs the 10-18%
# default) and ±size/36 center jitter (vs ±size/12) — max radius + jitter
# = 0.238·size < the 0.25·size cell half-width, so cells stay exact
SPATIAL_DRAW = {"r_frac": (0.13, 0.21), "jitter_div": 36}


def _draw_scene(
    rng: np.random.Generator,
    size: int,
    r_frac: Tuple[float, float] = (0.10, 0.18),
    jitter_div: int = 12,
) -> Tuple[Image.Image, List[Tuple[str, str, int]]]:
    """Render 1-3 non-overlapping shapes; returns
    (image, [(shape, color, cell)]) with cell indexing the 2x2 grid.

    ``r_frac`` bounds the shape radius as a fraction of ``size``;
    ``jitter_div`` sets the center jitter (±size/jitter_div). The spatial
    corpus uses larger shapes with less jitter (``SPATIAL_DRAW``) so shape
    IDENTITY is resolvable after the backbone's 32x downsampling.
    Radius+jitter stays ≤ size/4 so shapes never cross their grid cell
    (position labels stay exact)."""
    bg = 235 + rng.integers(-8, 8, size=3)
    img = Image.new("RGB", (size, size), tuple(int(v) for v in bg))
    draw = ImageDraw.Draw(img)
    n = int(rng.integers(1, 4))
    # distinct shapes so "what color is the X" is unambiguous
    shapes = list(rng.choice(SHAPES, size=n, replace=False))
    placed = []
    cells = rng.permutation(4)[:n]  # 2x2 grid cells, no overlap
    jit = max(size // jitter_div, 1)
    for shape, cell in zip(shapes, cells):
        color_name = str(rng.choice(list(COLORS)))
        color = COLORS[color_name]
        cx = (cell % 2) * size // 2 + size // 4 + int(rng.integers(-jit, jit))
        cy = (cell // 2) * size // 2 + size // 4 + int(rng.integers(-jit, jit))
        r = int(size * (r_frac[0] + (r_frac[1] - r_frac[0]) * rng.random()))
        if shape == "circle":
            draw.ellipse([cx - r, cy - r, cx + r, cy + r], fill=color)
        elif shape == "square":
            draw.rectangle([cx - r, cy - r, cx + r, cy + r], fill=color)
        else:
            draw.polygon(
                [(cx, cy - r), (cx - r, cy + r), (cx + r, cy + r)], fill=color
            )
        placed.append((shape, color_name, int(cell)))
    return img, placed


def _make_qa(rng: np.random.Generator, placed) -> Tuple[str, str, str]:
    """(question, answer, question_type)."""
    kind = int(rng.integers(0, 3))
    if kind == 0:
        shape, color, _ = placed[int(rng.integers(0, len(placed)))]
        return f"what color is the {shape}", color, "what color"
    if kind == 1:
        return "how many shapes are there", str(len(placed)), "how many"
    shape = str(rng.choice(SHAPES))
    present = any(s == shape for s, _, _ in placed)
    return f"is there a {shape}", "yes" if present else "no", "is there"


def _make_spatial_qa(rng: np.random.Generator, placed) -> Tuple[str, str, str]:
    """Spatially-grounded (question, answer, question_type): answering
    requires LOCALIZING a shape in the 2x2 grid, which global average
    pooling cannot do when several differently-colored shapes are present
    — the question family that gives the spatial-attention ablation a
    real signal."""
    shape, color, cell = placed[int(rng.integers(0, len(placed)))]
    pos = POSITIONS[cell]
    if int(rng.integers(0, 2)):
        return f"what color is the shape in the {pos}", color, "what color where"
    return f"what shape is in the {pos}", shape, "what shape where"


class SyntheticVQADataset:
    """Deterministic colored-shapes VQA samples (VQADataset protocol)."""

    def __init__(
        self,
        num_samples: int = 2000,
        image_size: int = 224,
        max_question_length: int = 20,
        is_training: bool = True,
        device_augment: bool = False,
        tokenizer: Optional[Tokenizer] = None,
        answer_vocab: Optional[AnswerVocabulary] = None,
        seed: int = 42,
        spatial: bool = False,
    ):
        self.num_samples = num_samples
        self.image_size = image_size
        self.is_training = is_training
        self.device_augment = device_augment
        self.seed = seed
        # spatial=True mixes in grid-localized questions ("what color is
        # the shape in the top left") — the variant where the spatial-
        # attention ablation has a measurable signal
        self.spatial = spatial
        self._aug_rng = np.random.default_rng(seed + 1)
        self._rng_lock = threading.Lock()

        answers = SPATIAL_ANSWERS if spatial else ANSWERS
        if answer_vocab is None:
            answer_vocab = AnswerVocabulary(num_answers=len(answers))
            answer_vocab.build_from_qa_pairs([{"answer": a} for a in answers])
        self.answer_vocab = answer_vocab
        if tokenizer is None:
            all_questions = (
                [f"what color is the {s}" for s in SHAPES]
                + ["how many shapes are there"]
                + [f"is there a {s}" for s in SHAPES]
            )
            if spatial:
                all_questions += [
                    f"what color is the shape in the {p}" for p in POSITIONS
                ] + [f"what shape is in the {p}" for p in POSITIONS]
            tokenizer = create_tokenizer_from_questions(
                all_questions * 2, max_length=max_question_length,
                vocab_size=100, min_freq=1,
            )
        self.tokenizer = tokenizer

    def __len__(self) -> int:
        return self.num_samples

    def type_vocab(self):
        """Question templates of _make_qa (+_make_spatial_qa), sorted."""
        base = ["how many", "is there", "what color"]
        if self.spatial:
            base += ["what color where", "what shape where"]
        return sorted(base)

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        draw_kw = SPATIAL_DRAW if self.spatial else {}
        if self.is_training and self.device_augment:
            img, placed = _draw_scene(rng, self.image_size + 32, **draw_kw)
            image = np.asarray(img, np.uint8)
        elif self.is_training:
            img, placed = _draw_scene(rng, self.image_size + 32, **draw_kw)
            # thread-safe: spawn a child generator (see dataset.BatchLoader
            # num_workers) instead of mutating the shared one concurrently
            with self._rng_lock:
                aug_rng = self._aug_rng.spawn(1)[0]
            image = augment_image(img, aug_rng, self.image_size)
        else:
            img, placed = _draw_scene(rng, self.image_size, **draw_kw)
            image = normalize_image(np.asarray(img, np.uint8))
        if self.spatial and int(rng.integers(0, 2)):
            question, answer, qtype = _make_spatial_qa(rng, placed)
        else:
            question, answer, qtype = _make_qa(rng, placed)
        ids, mask = self.tokenizer.encode(question)
        ann = np.full(10, self.answer_vocab.encode(answer), np.int32)
        return {
            "image": image,
            "token_ids": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(mask, np.int32),
            "answer": self.answer_vocab.encode(answer),
            "question_type": qtype,
            "annotator_answers": ann,
        }


def create_synthetic_loaders(
    num_samples: int = 2000,
    batch_size: int = 32,
    eval_batch_size: int = 64,
    image_size: int = 224,
    max_question_length: int = 20,
    train_split: float = 0.8,
    device_augment: bool = False,
    seed: int = 42,
    num_workers: int = 0,
    spatial: bool = False,
):
    """(train_loader, val_loader, tokenizer, answer_vocab) over disjoint
    deterministic sample ranges (val never sees a training scene)."""
    from vqa_tpu_torch.data.dataset import BatchLoader

    base = SyntheticVQADataset(
        num_samples, image_size, max_question_length,
        is_training=True, device_augment=device_augment, seed=seed,
        spatial=spatial,
    )
    val_ds = SyntheticVQADataset(
        num_samples, image_size, max_question_length,
        is_training=False,
        tokenizer=base.tokenizer, answer_vocab=base.answer_vocab, seed=seed,
        spatial=spatial,
    )
    n_train = int(num_samples * train_split)
    train = BatchLoader(
        base, batch_size, shuffle=True, drop_last=True, seed=seed,
        indices=np.arange(n_train), num_workers=num_workers,
    )
    val = BatchLoader(
        val_ds, eval_batch_size, shuffle=False, drop_last=False,
        indices=np.arange(n_train, num_samples),
    )
    return train, val, base.tokenizer, base.answer_vocab


def generate_scene(seed: int, image_size: int = 224):
    """One fresh scene for demos/serving smoke tests: returns
    ``(png_bytes, question, answer)``. Deterministic per seed. Training
    scenes are seeded with a single integer (``train_seed * 1_000_003 +
    idx``); this uses a two-element ``SeedSequence`` entropy list — a
    structurally different entropy domain — so no generate_scene stream can
    coincide with a training scene stream (an additive offset could)."""
    import io

    rng = np.random.default_rng(np.random.SeedSequence([0xDEC0DE, seed]))
    img, placed = _draw_scene(rng, image_size)
    question, answer, _ = _make_qa(rng, placed)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue(), question, answer
