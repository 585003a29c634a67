"""The comparison that decides `correct`, against the plain reference.

The reference (`benchmark/reference/`) works out again everything the
program derived: the token ids from the benchmark's word table, the BN
fold and the bf16 copies (by not making them: it runs in float32, TF32
off). It reads the program's outputs only to judge them.

The number compared, `logprob_gap`, is a largest gap in natural-log
probability: over every answer of every sampled pair, |ln p_program -
ln p_reference|.
"""

from __future__ import annotations

import gc
from typing import Dict, Sequence

import numpy as np
import torch

from benchmark.reference.model import log_probs_in_blocks
from benchmark.reference.prep import Vocabulary


def reference_log_probs(cfg: dict, state_cpu: Dict[str, torch.Tensor], pixels: np.ndarray,
                        questions: Sequence[str], word2idx: Dict[str, int], device,
                        quant=None) -> np.ndarray:
    """ln p of the reference for each pair, [n, answers] float64 on the host."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ids, mask = Vocabulary(word2idx, cfg["max_question_length"]).encode_all(questions)
    state = {k: v.to(device) for k, v in state_cpu.items()}
    out = log_probs_in_blocks(cfg, state, torch.from_numpy(pixels).to(device),
                              torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device),
                              quant=quant)
    return out.double().numpy()


def logprob_gap(probs: np.ndarray, ref_lp: np.ndarray) -> float:
    lp = np.log(np.maximum(probs.astype(np.float64), np.finfo(np.float64).tiny))
    return float(np.abs(lp - ref_lp).max())

