"""Time reading a JAX trainer's Orbax checkpoint with the port's reader
(``compat/orbax.py`` over the C++ zstd decoder), on the host it runs on.

    python -m vqa_tpu_torch.tools.checkpoint_read --checkpoint-dir D \\
        [--which best_model] [--out J.json]

It prints one JSON line (also written to ``--out``): the checkpoint's
zstd chunks and the MB they decode to; the decoder's MB/s over them on
one thread and on the pool, in one call over as many copies of the
chunks as reach ``POOL_MB`` decoded (one copy for a checkpoint that
large), so that a small checkpoint keeps every core busy; and the whole
read (``load_orbax_checkpoint``: manifest, nodes, chunks, the tree) in
ms, each the median of five, with the arrays' count and MB.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import time
from typing import Optional

import numpy as np


ROUNDS = 5
POOL_MB = 64  # the decoded MB of the pool's one call, at least


def _median_s(fn) -> float:
    times = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, np.ndarray):
        yield tree


def measure(checkpoint_dir: str, which: str = "best_model") -> dict:
    from vqa_tpu_torch.compat import orbax
    from vqa_tpu_torch.native import zstd
    from vqa_tpu_torch.training.checkpoint import load_orbax_checkpoint

    zstd.load()  # a build, if one is due, is not timed here
    frames, sizes = orbax.zstd_frames(os.path.join(checkpoint_dir, which))
    frames = [bytes(f) for f in frames]
    decoded = sum(sizes)
    copies = max(1, math.ceil(POOL_MB * 1e6 / decoded))
    out = dict(checkpoint=os.path.join(checkpoint_dir, which), chunks=len(frames),
               chunk_mb=decoded / 1e6, compressed_mb=sum(map(len, frames)) / 1e6)
    for name, k, threads in (("one_thread", 1, 1), ("pool", copies, 0)):
        s = _median_s(lambda: zstd.decompress_many(frames * k, sizes * k, threads))
        out[name] = dict(mb_per_s=decoded * k / s / 1e6, ms=s * 1e3, copies=k)
    s = _median_s(lambda: load_orbax_checkpoint(checkpoint_dir, which))
    tree, _, _ = load_orbax_checkpoint(checkpoint_dir, which)
    arrays = list(_leaves(tree))
    out.update(read_ms=s * 1e3, arrays=len(arrays),
               array_mb=sum(a.nbytes for a in arrays) / 1e6, cores=os.cpu_count())
    return out


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--which", default="best_model")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    res = measure(args.checkpoint_dir, args.which)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
