"""Roofline accounting of the VQA forward and train step on one H100.

    python -m vqa_tpu_torch.tools.roofline [--train] [--batch 1024]
        [--dtype bf16|f32|tf32] [--peak-tflops T] [--hbm-gbps G]
        [--measured-pairs-per-sec N] [--out FILE.json]

The port of ``scripts/roofline.py``, with its accounting kept stage for
stage: per pair, the FLOPs and device-memory bytes of the stem, the four
residual stages, the text encoder, fusion and the answer head, and with
``--train`` those of the train step (each conv's backward twice its
forward FLOPs, except the stem's, whose input gradient is never needed;
the backward re-reads the saved input, reads the output gradient and
writes the input gradient; gradients and AdamW's parameter, m and v
traffic in f32, amortised over the batch). Every conv output goes through
device memory once; weight reads of the forward are not counted. From
these, each stage's floor is the larger of its FLOPs over the peak rate
and its bytes over the memory rate; the totals give the additive floor
(no overlap) and the perfect-overlap floor per pair.

What changed from the JAX script: the element size comes from ``--dtype``
(bf16: 2 bytes, the JAX script's only case; f32 and tf32: 4), the uint8
pixels stay 1 byte each, and the peak rates are the H100 SXM's published
dense ones (3.35 TB/s; 67 TFLOP/s for f32 outside the tensor cores, 495 for
TF32 and 989 for bf16 on them; ``--peak-tflops`` defaults to the dtype's).
``rows`` and ``floors`` return the numbers the printed table holds; a
file is written only with ``--out``. Counts only: no device is touched.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

N_PARAMS = 19_310_316  # count_parameters of the full-width ModelConfig()
HBM_GBPS = 3350.0      # H100 SXM
PEAK_TFLOPS = {"f32": 67.0, "tf32": 495.0, "bf16": 989.0}
ELEMENT_BYTES = {"f32": 4, "tf32": 4, "bf16": 2}
# the full-width ModelConfig()'s geometry, as the JAX script fixes it
IMAGE = 224
STAGES = ((56, 64, 64), (28, 64, 128), (14, 128, 256), (7, 256, 512))  # (hw, cin, cout)
EMBED, TOKENS, FFN, TEXT_LAYERS = 256, 20, 1024, 4
IMAGE_TOKENS, ANSWERS = 49, 1000


def conv_cost(h, w, k, cin, cout, stride=1):
    """(flops, out_elems, in_elems) for one conv at [h,w,cin] input."""
    oh, ow = h // stride, w // stride
    return 2 * oh * ow * k * k * cin * cout, oh * ow * cout, h * w * cin


def rows(batch: int = 1024, train: bool = False, dtype: str = "bf16") -> List[Dict]:
    """Per pair, one dict per stage: ``name``, ``flops`` and ``bytes`` of
    the forward, ``bwd_flops`` and ``bwd_bytes`` of the backward (0 without
    ``train``), in ``dtype``'s element size."""
    e = ELEMENT_BYTES[dtype]
    out: List[Dict] = []

    def add(name, flops, nbytes, bwd_flops=0, bwd_bytes=0):
        out.append(dict(name=name, flops=flops, bytes=nbytes,
                        bwd_flops=bwd_flops if train else 0, bwd_bytes=bwd_bytes if train else 0))

    # stem: 224² x3 (uint8) → 7×7/2 conv → 112² x64 → 3×3/2 maxpool → 56² x64
    f, o, i = conv_cost(IMAGE, IMAGE, 7, 3, 64, 2)
    add("stem conv", f, IMAGE * IMAGE * 3 + o * 2 * e, f, (i + o) * e)  # bwd: dW only
    add("stem maxpool", 112 * 112 * 64 * 9, 56 * 56 * 64 * 2 * e,
        0, (56 * 56 * 64 + 112 * 112 * 64) * e)  # bwd: read dOut, scatter dIn

    # stages: [2,2,2,2] blocks, channels 64→512, spatial 56→7
    for n, (hw, cin, cout) in enumerate(STAGES, 1):
        stride = 1 if n == 1 else 2
        in_hw = hw * stride
        convs = [(in_hw, 3, cin, stride), (hw, 3, cout, 1)]  # block 1 (may downsample)
        if stride != 1 or cin != cout:
            convs.append((in_hw, 1, cin, stride))            # its projection
        convs += [(hw, 3, cout, 1)] * 2                      # block 2
        sf = st = sbf = sbt = 0
        for h, k, ci, s in convs:
            f, o, i = conv_cost(h, h, k, ci, cout, s)
            sf += f
            st += o * 2
            sbf += 2 * f          # dX + dW
            sbt += 2 * i + o      # re-read act, read dOut, write dIn
        # SE's pool re-reads the stage activation once (fwd and bwd)
        st += hw * hw * cout
        sbt += hw * hw * cout
        add(f"stage{n}", sf, st * e, sbf, sbt * e)

    d, L = EMBED, TOKENS
    text_f = TEXT_LAYERS * (4 * 2 * L * d * d + 2 * 2 * L * L * d + 2 * 2 * L * d * FFN)
    add("text encoder", text_f, TEXT_LAYERS * L * d * 6 * e,
        2 * text_f, TEXT_LAYERS * L * d * 12 * e)
    # per cross-attention layer: Q and O project the L text tokens, K and V
    # the 49 image tokens; then the image projection 512 → d
    t = IMAGE_TOKENS
    fusion_f = 2 * (2 * 2 * L * d * d + 2 * 2 * t * d * d + 2 * 2 * L * t * d
                    + 2 * 2 * L * d * 4 * d) + 2 * t * 512 * d
    add("fusion", fusion_f, (t * d * 4 + L * d * 8) * e,
        2 * fusion_f, (t * d * 8 + L * d * 16) * e)
    head_f = 2 * (d * 512 + 512 * d + d * ANSWERS)
    add("answer head", head_f, 3000 * e, 2 * head_f, 6000 * e)

    if train:
        # gradients f32 written and read (2·P·4) + AdamW's p/m/v read and
        # written (6·P·4), per step, amortised per pair
        add("grads+AdamW", 0, 0, 20 * N_PARAMS / batch, 8 * N_PARAMS * 4 / batch)
    return out


def floors(table: List[Dict], peak_tflops: float, hbm_gbps: float = HBM_GBPS) -> Dict:
    """Totals of ``table`` (forward plus backward) per pair, and the floors
    in µs per pair: ``compute_us`` (FLOPs over the peak), ``memory_us``
    (bytes over the memory rate), ``additive_us`` (their sum: no overlap)
    and ``overlap_us`` (their maximum: perfect overlap)."""
    flops = sum(r["flops"] + r["bwd_flops"] for r in table)
    nbytes = sum(r["bytes"] + r["bwd_bytes"] for r in table)
    tc = flops / (peak_tflops * 1e12) * 1e6
    tm = nbytes / (hbm_gbps * 1e9) * 1e6
    return dict(flops=flops, bytes=nbytes, compute_us=tc, memory_us=tm,
                additive_us=tc + tm, overlap_us=max(tc, tm),
                bound_by="bytes" if tm > tc else "operations")


def forward_floor_ms(batch: int, dtype: str) -> Dict:
    """The floors of one inference forward of ``batch`` pairs in ``dtype``
    at the H100's peaks, in ms: ``overlap_ms``, ``additive_ms``, and what
    bounds it."""
    fl = floors(rows(batch, False, dtype), PEAK_TFLOPS[dtype])
    return dict(overlap_ms=fl["overlap_us"] * batch / 1e3,
                additive_ms=fl["additive_us"] * batch / 1e3,
                flops=fl["flops"] * batch, bytes=fl["bytes"] * batch,
                bound_by=fl["bound_by"])


def report(table: List[Dict], train: bool, batch: int, peak_tflops: float, hbm_gbps: float,
           measured_pairs_per_sec: Optional[float] = None) -> str:
    """The JAX script's table, at these peaks."""
    peak, bw = peak_tflops * 1e12, hbm_gbps * 1e9
    mode = "TRAIN STEP" if train else "INFERENCE FORWARD"
    lines = [f"== {mode} (per pair, batch={batch}) =="]
    hdr_b = f"{'bwd GF':>9}{'bwd MB':>9}" if train else ""
    lines.append(f"{'component':<14}{'GFLOP':>9}{'MB':>8}{hdr_b}"
                 f"{'t_ops µs':>10}{'t_hbm µs':>10}{'bound':>8}")
    for r in table:
        fo, bo = r["flops"] + r["bwd_flops"], r["bytes"] + r["bwd_bytes"]
        tc, tm = fo / peak * 1e6, bo / bw * 1e6
        ext = f"{r['bwd_flops'] / 1e9:>9.2f}{r['bwd_bytes'] / 1e6:>9.2f}" if train else ""
        lines.append(f"{r['name']:<14}{r['flops'] / 1e9:>9.3f}{r['bytes'] / 1e6:>8.2f}{ext}"
                     f"{tc:>10.2f}{tm:>10.2f}{'mem' if tm > tc else 'ops':>8}")
    fl = floors(table, peak_tflops, hbm_gbps)
    lines.append("-" * (82 if train else 64))
    lines.append(f"{'TOTAL':<14}{fl['flops'] / 1e9:>9.3f}{fl['bytes'] / 1e6:>8.2f}"
                 f"{'':>{18 if train else 0}}{fl['compute_us']:>10.2f}{fl['memory_us']:>10.2f}")
    lines.append("")
    lines.append(f"additive floor (no overlap): {fl['additive_us']:.1f} µs/pair "
                 f"→ {1e6 / fl['additive_us']:,.0f} pairs/s")
    lines.append(f"perfect-overlap floor:        {fl['overlap_us']:.1f} µs/pair "
                 f"→ {1e6 / fl['overlap_us']:,.0f} pairs/s")
    if measured_pairs_per_sec:
        t = 1e6 / measured_pairs_per_sec
        lines.append(f"measured:                     {t:.1f} µs/pair "
                     f"({measured_pairs_per_sec:,.0f} pairs/s, "
                     f"{fl['additive_us'] / t * 100:.0f}% of additive floor)")
    return "\n".join(lines)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--train", action="store_true",
                   help="account the full train step (fwd+bwd+AdamW)")
    p.add_argument("--dtype", choices=sorted(ELEMENT_BYTES), default="bf16",
                   help="element type of activations and its peak (default bf16)")
    p.add_argument("--peak-tflops", type=float, default=None,
                   help="dense peak, TFLOP/s (default: the H100 SXM's for --dtype)")
    p.add_argument("--hbm-gbps", type=float, default=HBM_GBPS, help="H100 SXM HBM3 rate")
    p.add_argument("--measured-pairs-per-sec", type=float, default=None)
    p.add_argument("--out", default=None, help="also write the numbers as JSON here")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    peak = args.peak_tflops if args.peak_tflops is not None else PEAK_TFLOPS[args.dtype]
    table = rows(args.batch, args.train, args.dtype)
    print(report(table, args.train, args.batch, peak, args.hbm_gbps,
                 args.measured_pairs_per_sec))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(batch=args.batch, train=args.train, dtype=args.dtype,
                           peak_tflops=peak, hbm_gbps=args.hbm_gbps, rows=table,
                           floors=floors(table, peak, args.hbm_gbps),
                           measured_pairs_per_sec=args.measured_pairs_per_sec), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
