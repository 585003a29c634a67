"""The requests whose answers ``expected.npz`` holds, numpy only (no
random generator, so any numpy version makes the same pixels)."""

import numpy as np

QUESTIONS = (
    "what color is the cat",
    "how many dogs are there",
    "is there a man in the picture",
    "what is on the table",
    "where is the red ball",
)


def images(n: int = len(QUESTIONS), size: int = 224) -> np.ndarray:
    """``n`` uint8 [size, size, 3] images: stripes, rings and a checker
    pattern that differ per image and channel."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.int64)
    out = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        for c in range(3):
            stripes = xx * (i + 1 + c) + yy * (2 * i + 3) + 40 * c
            rings = ((xx - 37 * i) ** 2 + (yy - 61 * c) ** 2) // (9 + 4 * i)
            checker = ((xx // (8 + 4 * i)) + (yy // (8 + 2 * c))) % 2 * 90
            out[i, :, :, c] = (stripes + rings + checker) % 256
    return out
