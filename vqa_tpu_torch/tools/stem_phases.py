"""Where the bf16 stem kernel's time goes, phase by phase, on the card.

    python -m vqa_tpu_torch.tools.stem_phases            # from the repository root
    python -m vqa_tpu_torch.tools.stem_phases --batch 8

Builds a copy of ``csrc/stem.cu`` in which thread 0 of blocks 0-3 stamps
``clock64()`` at each ``// phase N:`` line of the bf16 kernel's tile loop,
launches it on the engine's stem shapes (224 px, cout 64, the plan
``stem_plan`` picks), checks the output against ``plain_stem`` and prints,
per phase, the SM cycles of each of those blocks' tiles and their median:
0-1 waiting for the box, 1-2 the products, 2-3 the epilogue, 3-4 the block
barrier, 4-5 the pool, 5-0 the loop to the next tile. Every stamp is one
store by one thread per block. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys
import tempfile

PHASES = ("box wait", "products", "epilogue", "barrier", "pool", "loop")
BLOCKS, TILES = 4, 16  # blocks stamped, tiles stamped per block


def instrumented_source(src: str) -> str:
    """stem.cu with a stamp after every ``// phase N:`` line and a reader."""
    head = ("__device__ long long vqa_phase_t[%d][%d][6];\n"
            "#define VQA_STAMP(k) do { if (threadIdx.x == 0 && blockIdx.x < %d && it < %d) "
            "vqa_phase_t[blockIdx.x][it][k] = clock64(); } while (0)\n" % (BLOCKS, TILES, BLOCKS,
                                                                           TILES))
    src, n = re.subn(r"^(\s*)// phase (\d):.*$", r"\g<0>\n\1VQA_STAMP(\2);", src, flags=re.M)
    if n != len(PHASES):
        raise SystemExit(f"stem_phases: expected {len(PHASES)} phase lines in stem.cu, found {n}")
    src = src.replace('#include "common.cuh"\n', '#include "common.cuh"\n' + head, 1)
    return src + ('\nVQA_EXPORT int vqa_stem_phases(long long* t) {\n'
                  '  return cudaMemcpyFromSymbol(t, vqa_phase_t, sizeof(vqa_phase_t));\n}\n')


def build(tmp: str) -> ctypes.CDLL:
    from vqa_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC_DIR, "stem.cu")) as f:
        src = instrumented_source(f.read())
    with open(os.path.join(tmp, "stem.cu"), "w") as f:
        f.write(src)
    for name in ("common.cuh", "common.cu"):
        with open(os.path.join(_build.CSRC_DIR, name)) as f, open(os.path.join(tmp, name), "w") as g:
            g.write(f.read())
    lib = os.path.join(tmp, "libstem_phases.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
                    os.path.join(tmp, "stem.cu"), os.path.join(tmp, "common.cu")], check=True)
    out = ctypes.CDLL(lib)
    out.vqa_stem_bf16.argtypes = _build._SIGNATURES["vqa_stem_bf16"]
    out.vqa_stem_phases.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=32)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("stem_phases: needs a CUDA device", file=sys.stderr)
        return 2
    from vqa_tpu_torch.ops import plain_stem
    from vqa_tpu_torch.ops.stem_kernel import stem_output_hw, stem_plan
    from vqa_tpu_torch.testing import STEM_BF16_ATOL, bf16_compare, card_line
    from vqa_tpu_torch.tools.stem_sweep import inputs

    print(card_line(), flush=True)
    b = args.batch
    x, w, scale, bias = inputs(torch, b)
    plan = stem_plan(b, 224, 224, 64, 2, x.data_ptr() % 16 == 0)
    out = torch.empty((b, *stem_output_hw(224, 224), 64), dtype=torch.bfloat16, device=x.device)
    with tempfile.TemporaryDirectory(prefix="stem_phases.") as tmp:
        lib = build(tmp)
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(5):  # the last launch's stamps are read
            rc = lib.vqa_stem_bf16(x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                   out.data_ptr(), b, 224, 224, 64, int(plan.tma),
                                   plan.smem_bytes, stream)
            if rc:
                raise SystemExit(f"stem_phases: launch refused: CUDA error {rc}")
        torch.cuda.synchronize()
        c = bf16_compare(torch, out, plain_stem(x, w, scale, bias), STEM_BF16_ATOL)
        if not c["ok"]:
            raise SystemExit(f"stem_phases: FAILED: the instrumented kernel disagrees: {c}")
        t = (ctypes.c_longlong * (BLOCKS * TILES * 6))()
        if lib.vqa_stem_phases(t):
            raise SystemExit("stem_phases: reading the stamps failed")
    per_block = -(-plan.tiles // plan.grid)
    tiles = min(TILES, plan.tiles // plan.grid)  # tiles every stamped block ran
    print(f"B={b}: {plan.tiles} tiles over {plan.grid} blocks ({per_block} at most a block); "
          f"SM cycles per tile, blocks 0-{BLOCKS - 1}, tiles 0-{tiles - 1}", flush=True)

    def stamp(blk, it, k):
        return t[(blk * TILES + it) * 6 + k]

    for k, name in enumerate(PHASES):
        cycles = []
        for blk in range(min(BLOCKS, plan.grid)):
            for it in range(tiles):
                if k < 5:
                    cycles.append(stamp(blk, it, k + 1) - stamp(blk, it, k))
                elif it + 1 < tiles:
                    cycles.append(stamp(blk, it + 1, 0) - stamp(blk, it, 5))
        if cycles:
            print(f"  {name:9s} median {statistics.median(cycles):7.0f}  "
                  f"({', '.join(str(v) for v in cycles)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
