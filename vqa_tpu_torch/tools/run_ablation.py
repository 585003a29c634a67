"""Spatial-attention ablation study: full / no-spatial / no-attention.

Counterpart of ``scripts/run_ablation.py``. On 2x2-grid scenes with
grid-localized questions ("what color is the shape in the top left"),
which global average pooling cannot answer, each variant is trained by
the port's train CLI on the spatial corpus and evaluated by the port's
evaluate CLI on a held-out corpus (another seed, unseen scenes), with the
per-question-type breakdown:

  1. ``python -m vqa_tpu_torch.tools.make_vqa_corpus --spatial`` writes the
     corpora on first use (seeds 42 and 4242);
  2. ``python -m vqa_tpu_torch.training.train`` trains each (variant,
     seed) cell (``--no-spatial``, ``--no-attention``; bf16 on the card);
  3. ``python -m vqa_tpu_torch.training.evaluate`` evaluates it on the
     held-out corpus (f32, as the JAX evaluator).

The table (``ABLATION.json``, the JAX script's schema: per-seed cells, and
per variant the mean held-out top-1 with a 95% Student-t half-width) is
printed, and written only where ``--out`` says, after every cell. With
``--out`` the runner resumes: a (variant, seed) already there is reused,
not rerun, the old single-seed schema is read too, and every variant with
cells is kept on each write, whatever ``--variants`` names.

    python -m vqa_tpu_torch.tools.run_ablation --epochs 16 --seeds 42,7,11 \\
        --out ABLATION.json
    python -m vqa_tpu_torch.tools.run_ablation --epochs 1 --num-images 40 \\
        --val-num-images 20 --device cpu --train-corpus D/train \\
        --val-corpus D/val --checkpoint-root D/checkpoints

The flags and defaults are the JAX script's, apart from the outputs: the
table only with ``--out``, checkpoints under ``--checkpoint-root``, the
subprocesses' output appended to ``--log`` or passed through; ``--device``
(the card unless ``cpu``) goes to the train and evaluate CLIs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# the package's parent directory, put on the subprocesses' PYTHONPATH
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = {
    "full": [],
    "no_spatial": ["--no-spatial"],
    "no_attention": ["--no-attention"],
}


def sh(cmd, log_path=None):
    """Run ``cmd``; its output goes to ``log_path`` (appended) or passes
    through. A non-zero exit stops the run."""
    print(f"[ablation] $ {' '.join(cmd)}", flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    if log_path is None:
        rc = subprocess.call(cmd, env=env)
    else:
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        with open(log_path, "ab") as log:
            rc = subprocess.call(cmd, env=env, stdout=log, stderr=log)
    if rc != 0:
        raise SystemExit(f"command failed rc={rc}: {' '.join(cmd)}"
                         + (f" (log: {log_path})" if log_path else ""))


def ensure_corpus(out_dir, num_images, seed, log):
    if os.path.exists(os.path.join(out_dir, "questions.json")):
        print(f"[ablation] corpus {out_dir} exists", flush=True)
        return
    sh([sys.executable, "-m", "vqa_tpu_torch.tools.make_vqa_corpus", "--out", out_dir,
        "--num-images", str(num_images), "--seed", str(seed), "--spatial"], log)


def mean_ci95(values):
    """Mean and 95% CI half-width (Student-t for the small n here)."""
    n = len(values)
    m = sum(values) / n
    if n < 2:
        return m, 0.0
    var = sum((v - m) ** 2 for v in values) / (n - 1)
    # two-sided 97.5% t quantiles (n-1 df); the z fallback 1.96 would
    # understate the half-width by ~15% already at df=8, so the table runs
    # far past any plausible seed count and stays slightly conservative
    # beyond it (t_inf = 1.960)
    t = {1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571,
         6: 2.447, 7: 2.365, 8: 2.306, 9: 2.262, 10: 2.228,
         11: 2.201, 12: 2.179, 13: 2.160, 14: 2.145, 15: 2.131,
         16: 2.120, 17: 2.110, 18: 2.101, 19: 2.093, 20: 2.086,
         }.get(n - 1, 2.06 if n - 1 <= 30 else 2.00)
    return m, t * (var ** 0.5) / (n ** 0.5)


def _load_existing(path):
    """Existing per-seed cells from ``path``, reading the old single-seed
    schema ({"seed": 42, "variants": {v: {...metrics}}}) too."""
    if not path or not os.path.exists(path):
        return {}
    with open(path) as f:
        old = json.load(f)
    cells = {}
    seed = old.get("seed")
    for v, payload in old.get("variants", {}).items():
        if "per_seed" in payload:
            for s, metrics in payload["per_seed"].items():
                cells[(v, int(s))] = metrics
        elif seed is not None:
            cells[(v, int(seed))] = payload
    return cells


def table(cells, args) -> dict:
    """The ABLATION.json payload over every variant with cells (not only
    ``--variants``: a partial rerun never drops another variant's
    results)."""
    variants = {}
    for v in sorted({vv for (vv, _) in cells}):
        per_seed = {str(s): cells[(v, s)] for s in sorted(
            {s for (vv, s) in cells if vv == v})}
        top1 = [m["heldout_top1"] for m in per_seed.values()]
        m, ci = mean_ci95(top1)
        variants[v] = {
            "per_seed": per_seed,
            "n_seeds": len(per_seed),
            "mean_heldout_top1": round(m, 4),
            "ci95_heldout_top1": round(ci, 4),
        }
    return {
        "train_corpus": args.train_corpus,
        "val_corpus": args.val_corpus,
        "epochs": args.epochs,
        "batch_size": args.batch_size,
        "seeds": sorted({s for (_, s) in cells}),
        "variants": variants,
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--seeds", default="42",
                   help="comma-separated training seeds; with --out, (variant, seed) "
                        "cells already there are reused, not rerun")
    p.add_argument("--train-corpus", default="data/vqa_synth_spatial")
    p.add_argument("--val-corpus", default="data/vqa_synth_spatial_val")
    p.add_argument("--num-images", type=int, default=2500)
    p.add_argument("--val-num-images", type=int, default=500)
    p.add_argument("--variants", default="full,no_spatial,no_attention")
    p.add_argument("--out", default=None, help="write the table (JSON) here, and resume from it")
    p.add_argument("--log", default=None,
                   help="append the subprocesses' output here (default: passed through)")
    p.add_argument("--checkpoint-root", default="checkpoints",
                   help="each cell trains into <root>/ablation_<variant>_s<seed>")
    p.add_argument("--device", default="cuda",
                   help="torch device of the train and evaluate CLIs (cpu only when asked)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    for v in args.variants.split(","):
        if v not in VARIANTS:
            raise SystemExit(f"unknown variant {v!r}: expected one of {sorted(VARIANTS)}")
    ensure_corpus(args.train_corpus, args.num_images, 42, args.log)
    ensure_corpus(args.val_corpus, args.val_num_images, 4242, args.log)

    seeds = [int(s) for s in args.seeds.split(",")]
    cells = _load_existing(args.out)

    def write_out():
        payload = table(cells, args)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(payload, f, indent=2)
        return payload

    device = ["--device", args.device]
    for variant in args.variants.split(","):
        for seed in seeds:
            if (variant, seed) in cells:
                print(f"[ablation] {variant} seed {seed}: cached in {args.out}", flush=True)
                continue
            ckpt_dir = os.path.join(args.checkpoint_root, f"ablation_{variant}_s{seed}")
            eval_dir = os.path.join(ckpt_dir, "heldout_eval")
            t0 = time.time()
            sh([sys.executable, "-m", "vqa_tpu_torch.training.train",
                "--questions", f"{args.train_corpus}/questions.json",
                "--annotations", f"{args.train_corpus}/annotations.json",
                "--images-dir", f"{args.train_corpus}/images",
                "--subset-size", "999999",
                "--epochs", str(args.epochs),
                "--batch-size", str(args.batch_size),
                "--device-aug", "--seed", str(seed),
                "--checkpoint-dir", ckpt_dir, *device,
                *VARIANTS[variant]], args.log)
            train_wall = time.time() - t0
            sh([sys.executable, "-m", "vqa_tpu_torch.training.evaluate",
                "--checkpoint-dir", ckpt_dir,
                "--questions", f"{args.val_corpus}/questions.json",
                "--annotations", f"{args.val_corpus}/annotations.json",
                "--images-dir", f"{args.val_corpus}/images",
                "--batch-size", str(args.batch_size),
                "--max-samples", "999999",
                "--output-dir", eval_dir, *device], args.log)
            with open(os.path.join(eval_dir, "evaluation_results.json")) as f:
                ev = json.load(f)
            cells[(variant, seed)] = {
                "train_wall_s": round(train_wall, 1),
                "heldout_top1": ev["top1_accuracy"],
                "heldout_top5": ev["top5_accuracy"],
                "vqa_soft_accuracy": ev.get("vqa_soft_accuracy"),
                "per_type_accuracy": ev.get("per_type_accuracy"),
                "num_samples": ev["num_samples"],
            }
            write_out()  # the table after every cell
            print(f"[ablation] {variant} seed {seed}: "
                  f"{json.dumps(cells[(variant, seed)], indent=2)}", flush=True)

    print(json.dumps(write_out(), indent=2))
    return cells


if __name__ == "__main__":
    main()
