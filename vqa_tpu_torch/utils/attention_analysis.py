"""Quantitative cross-attention faithfulness analysis.

The port's copy of ``vqa_tpu/utils/attention_analysis.py:1-89`` (numpy
only). For spatially grounded questions ("what color is the shape in the
top left") it computes how much of the question's cross-attention mass
falls in each 2x2-grid quadrant of the image feature map, so "the model
looks where the question points" is a testable claim against a 0.25
uniform baseline (``tools/attention_faithfulness.py``).

Quadrants follow ``vqa_tpu_torch.data.synthetic.POSITIONS``: 0 = top
left, 1 = top right, 2 = bottom left, 3 = bottom right. For an odd grid
side (the default 7x7 feature map) the middle row and column belong to no
quadrant; masses are normalized over the four quadrants, so a uniform map
scores exactly 0.25 per quadrant whatever the grid's parity.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

QUADRANT_NAMES = ("top left", "top right", "bottom left", "bottom right")


def quadrant_slices(side: int) -> Tuple[Tuple[slice, slice], ...]:
    """Row/col slices of the four quadrants of a ``side x side`` grid,
    excluding the middle row/column when ``side`` is odd."""
    half = side // 2
    lo = slice(0, half)
    hi = slice(side - half, side)
    return ((lo, lo), (lo, hi), (hi, lo), (hi, hi))


def aggregate_token_maps(
    spatial_attn: np.ndarray,
    attention_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """[B, L_q, H, W] per-token attention maps → [B, H, W] question-level
    map via a mask-weighted mean over question tokens. Each token's map is
    row-stochastic (sums to 1 over H*W), so the aggregate is too."""
    spatial_attn = np.asarray(spatial_attn, np.float64)
    if attention_mask is None:
        return spatial_attn.mean(axis=1)
    w = np.asarray(attention_mask, np.float64)
    # an all-zero mask row would yield an all-zero map (and corrupt
    # downstream quadrant means silently): those rows take the unmasked
    # mean
    empty = w.sum(axis=1) <= 0
    if empty.any():
        w = np.where(empty[:, None], 1.0, w)
    w = w[:, :, None, None]
    denom = np.maximum(w.sum(axis=1), 1e-9)
    return (spatial_attn * w).sum(axis=1) / denom


def quadrant_masses(
    spatial_attn: np.ndarray,
    attention_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """[B, L_q, H, W] (or pre-aggregated [B, H, W]) → [B, 4] attention
    mass per quadrant, normalized over the four quadrants (rows sum to 1;
    uniform attention → 0.25 each)."""
    m = np.asarray(spatial_attn, np.float64)
    if m.ndim == 4:
        m = aggregate_token_maps(m, attention_mask)
    if m.ndim != 3 or m.shape[-1] != m.shape[-2]:
        raise ValueError(f"expected [B,L_q,S,S] or [B,S,S], got {m.shape}")
    side = m.shape[-1]
    masses = np.stack(
        [m[:, rs, cs].sum(axis=(1, 2)) for rs, cs in quadrant_slices(side)],
        axis=1,
    )
    return masses / np.maximum(masses.sum(axis=1, keepdims=True), 1e-12)


def position_from_question(question: str) -> Optional[int]:
    """Quadrant index queried by a spatially-grounded question, or None.
    Matches the synthetic corpus templates '... in the {top left|top right|
    bottom left|bottom right}' (vqa_tpu_torch/data/synthetic.py)."""
    q = question.lower()
    for idx, name in enumerate(QUADRANT_NAMES):
        if name in q:
            return idx
    return None
