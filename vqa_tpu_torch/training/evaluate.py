"""Evaluation: accuracy, confusion analysis, error pairs, reports.

Counterpart of ``vqa_tpu/training/evaluate.py``, with the same outputs —
top-1/top-5, per-question-type accuracy, the official VQA soft accuracy
min(1, agreement/3) where annotator answers ride in the batch, a confusion
matrix and per-class accuracy over the top-100 classes, the most common
(pred, target) error pairs decoded through the answer vocab, sample top-5
predictions, a text report and ``evaluation_results.json`` with the
reference's key names beside the package's own.

The batch math is the trainer's ``make_eval_step`` in eval mode, so every
evaluation forward runs the stem, SE and cross-attention kernels (1, 4 and
2 launches); the results of batch N are fetched after batch N+1 has been
launched, so the device-to-host copy overlaps the next forward. The first
64 samples' logits are kept, so ``sample_predictions`` on the same loader
needs no second pass.

The evaluator computes in f32 by default, as the JAX one does; ``--bf16``
computes in bf16 (the engine's policy, ``models/layers.py``), top-1/top-5
argmax-stable and probabilities moved at bf16's epsilon. Multi-device
evaluation (``--data-parallel``, ``--model-parallel``) is not ported.

    python -m vqa_tpu_torch.training.evaluate --checkpoint-dir checkpoints --synthetic
    python -m vqa_tpu_torch.training.evaluate --checkpoint-dir checkpoints --synthetic --bf16
    python -m vqa_tpu_torch.training.evaluate --checkpoint-dir D --demo --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
from collections import Counter
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from vqa_tpu_torch.data.dataset import BatchLoader, DemoVQADataset, VQADataset
from vqa_tpu_torch.data.pipeline import prefetch_to_device
from vqa_tpu_torch.data.vocab import AnswerVocabulary
from vqa_tpu_torch.training.train import make_eval_step
from vqa_tpu_torch.utils.metrics import confusion_matrix, per_class_accuracy
from vqa_tpu_torch.utils.tokenizer import Tokenizer


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class Evaluator:
    """Full-dataset evaluation with error analysis, on the model's device."""

    def __init__(self, model, answer_vocab: Optional[AnswerVocabulary] = None):
        self.model = model
        self.device = next(model.parameters()).device
        self.answer_vocab = answer_vocab
        self.eval_step = make_eval_step(model)
        # first-N (logits, token_ids, answer) captured during evaluate() so
        # sample_predictions can decode without a second pass over the loader
        self._sample_cache: Optional[Dict[str, np.ndarray]] = None
        self._sample_cache_complete = False
        # the loader evaluate() filled the cache from: the cache never
        # answers sample_predictions for another loader
        self._sample_cache_loader: Optional[BatchLoader] = None

    def evaluate(self, loader: BatchLoader, top_classes: int = 100,
                 sample_cache: int = 64) -> Dict[str, Any]:
        preds: List[np.ndarray] = []
        targets: List[np.ndarray] = []
        c1 = c5 = n = 0
        loss_sum = 0.0
        type_total: Dict[str, int] = {}
        type_correct: Dict[str, int] = {}
        soft_sum, soft_n = 0.0, 0
        cache = {"logits": [], "token_ids": [], "answer": []}
        cached = 0

        def consume(out, batch):
            nonlocal c1, c5, n, loss_sum, soft_sum, soft_n, cached
            valid = int(batch["valid"])
            pred = _host(out["pred"])[:valid]  # waits for this batch
            tgt = _host(batch["answer"])[:valid]
            correct1 = _host(out["correct1"])[:valid]
            preds.append(pred)
            targets.append(tgt)
            c1 += int(correct1.sum())
            c5 += int(_host(out["correct5"])[:valid].sum())
            loss_sum += float(_host(out["loss_vec"])[:valid].sum())
            n += valid
            if cached < sample_cache:
                take = min(valid, sample_cache - cached)
                cache["logits"].append(_host(out["logits"])[:take])
                cache["token_ids"].append(_host(batch["token_ids"])[:take])
                cache["answer"].append(_host(batch["answer"])[:take])
                cached += take
            qtypes = batch.get("question_types")
            if qtypes:
                for qt, ok in zip(qtypes[:valid], correct1):
                    type_total[qt] = type_total.get(qt, 0) + 1
                    if ok:
                        type_correct[qt] = type_correct.get(qt, 0) + 1
            ann = batch.get("annotator_answers")
            if ann is not None:
                agree = (_host(ann)[:valid] == pred[:, None]).sum(-1)
                soft_sum += float(np.minimum(1.0, agree / 3.0).sum())
                soft_n += valid

        pending = None
        for batch in prefetch_to_device(loader, self.device):
            out = self.eval_step(batch["image"], batch["token_ids"], batch["attention_mask"],
                                 batch["answer"])
            if pending is not None:
                consume(*pending)
            pending = (out, batch)
        if pending is not None:
            consume(*pending)

        if cached:
            self._sample_cache = {k: np.concatenate(v) for k, v in cache.items()}
            # complete: the cache holds every evaluated sample, so it answers
            # requests for more samples than it holds
            self._sample_cache_complete = cached == n
            self._sample_cache_loader = loader

        preds_all = np.concatenate(preds) if preds else np.zeros(0, np.int64)
        targets_all = np.concatenate(targets) if targets else np.zeros(0, np.int32)
        n = max(n, 1)
        results: Dict[str, Any] = {
            "num_samples": int(len(preds_all)),
            "loss": loss_sum / n,
            "top1_accuracy": c1 / n,
            "top5_accuracy": c5 / n,
            "per_type_accuracy": {
                qt: type_correct.get(qt, 0) / tot for qt, tot in sorted(type_total.items())
            },
        }
        if soft_n:
            results["vqa_soft_accuracy"] = soft_sum / soft_n

        # confusion analysis over the most frequent classes
        if len(preds_all):
            k = min(top_classes, int(targets_all.max()) + 1)
            sel = (targets_all < k) & (preds_all < k)
            cm = confusion_matrix(torch.from_numpy(preds_all[sel]),
                                  torch.from_numpy(targets_all[sel]), k)
            results["per_class_accuracy_top"] = per_class_accuracy(cm).tolist()
            results["error_pairs"] = self._analyze_errors(preds_all, targets_all)
        return results

    def _analyze_errors(self, preds: np.ndarray, targets: np.ndarray,
                        top_n: int = 20) -> List[Dict[str, Any]]:
        """Most common (pred, target) mistakes, decoded."""
        wrong = preds != targets
        pairs = Counter(zip(preds[wrong].tolist(), targets[wrong].tolist()))
        out = []
        for (p, t), count in pairs.most_common(top_n):
            item = {"predicted": int(p), "target": int(t), "count": int(count)}
            if self.answer_vocab is not None:
                item["predicted_answer"] = self.answer_vocab.decode(p)
                item["target_answer"] = self.answer_vocab.decode(t)
            out.append(item)
        return out

    def _decode_samples(self, logits: np.ndarray, token_ids: np.ndarray, answers: np.ndarray,
                        tokenizer: Optional[Tokenizer], num: int) -> List[Dict[str, Any]]:
        """softmax and top-5 on the host over the whole array."""
        take = min(num, len(logits))
        logits = logits[:take]
        z = logits - logits.max(axis=-1, keepdims=True)
        probs = np.exp(z)
        probs /= probs.sum(axis=-1, keepdims=True)
        top_i = np.argsort(-probs, axis=-1)[:, :5]
        top_p = np.take_along_axis(probs, top_i, axis=-1)
        samples = []
        for i in range(take):
            entry = {
                "target": int(answers[i]),
                "top5_indices": top_i[i].tolist(),
                "top5_probs": top_p[i].tolist(),
            }
            if tokenizer is not None:
                entry["question"] = tokenizer.decode(token_ids[i])
            if self.answer_vocab is not None:
                entry["target_answer"] = self.answer_vocab.decode(int(answers[i]))
                entry["top5_answers"] = [self.answer_vocab.decode(int(j)) for j in top_i[i]]
            samples.append(entry)
        return samples

    def sample_predictions(self, loader: BatchLoader, tokenizer: Optional[Tokenizer],
                           num: int = 20) -> List[Dict[str, Any]]:
        """Decoded sample top-5 predictions: from the logits ``evaluate``
        kept when it ran on this loader (and kept enough of them), else from
        forwards over the loader."""
        cache = self._sample_cache
        if cache is not None and loader is self._sample_cache_loader and (
            len(cache["logits"]) >= num or self._sample_cache_complete
        ):
            return self._decode_samples(cache["logits"], cache["token_ids"], cache["answer"],
                                        tokenizer, num)
        samples: List[Dict[str, Any]] = []
        for batch in loader:
            out = self.eval_step(*(torch.from_numpy(batch[k]).to(self.device)
                                   for k in ("image", "token_ids", "attention_mask", "answer")))
            valid = int(batch["valid"])
            samples.extend(self._decode_samples(
                _host(out["logits"])[:valid], batch["token_ids"][:valid],
                batch["answer"][:valid], tokenizer, num - len(samples)))
            if len(samples) >= num:
                break
        return samples

    def generate_report(self, results: Dict[str, Any]) -> str:
        """Text report."""
        lines = [
            "=" * 60,
            "VQA Evaluation Report",
            "=" * 60,
            f"samples:        {results['num_samples']}",
            f"loss:           {results['loss']:.4f}",
            f"top-1 accuracy: {results['top1_accuracy']:.4f}",
            f"top-5 accuracy: {results['top5_accuracy']:.4f}",
        ]
        if "vqa_soft_accuracy" in results:
            lines.append(f"VQA soft acc:   {results['vqa_soft_accuracy']:.4f}")
        if results.get("per_type_accuracy"):
            lines.append("\nPer-question-type accuracy:")
            for qt, acc in results["per_type_accuracy"].items():
                lines.append(f"  {qt:30s} {acc:.4f}")
        if results.get("error_pairs"):
            lines.append("\nMost common errors (pred ← target):")
            for e in results["error_pairs"][:10]:
                p = e.get("predicted_answer", e["predicted"])
                t = e.get("target_answer", e["target"])
                lines.append(f"  {p!s:20s} ← {t!s:20s} ×{e['count']}")
        lines.append("=" * 60)
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a VQA checkpoint (PyTorch/CUDA port)")
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--checkpoint", default="best_model")
    p.add_argument("--questions", default=None)
    p.add_argument("--annotations", default=None)
    p.add_argument("--images-dir", default=None)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--max-samples", type=int, default=5000)
    p.add_argument("--demo", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="evaluate on the colored-shapes val split (data/synthetic.py), "
                        "rebuilt from the checkpoint's sidecar")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--data-parallel", type=int, default=None,
                   help="not ported (ROADMAP A.11): stops with a message")
    p.add_argument("--model-parallel", type=int, default=None,
                   help="not ported (ROADMAP A.11): stops with a message")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute for the eval forward (default f32, as the JAX "
                        "evaluator; top-1/top-5 are argmax-stable, probabilities move at "
                        "bf16's epsilon)")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on; the CPU only when asked (--device cpu)")
    return p.parse_args(argv)


def main(argv=None):
    from vqa_tpu_torch.models.vqa_model import resolve_device
    from vqa_tpu_torch.training.checkpoint import (
        checkpoint_exists,
        load_checkpoint_meta,
        load_model_for_inference,
    )

    args = parse_args(argv)
    if args.data_parallel is not None or args.model_parallel is not None:
        raise NotImplementedError(
            "multi-device evaluation (--data-parallel / --model-parallel) is not ported "
            "yet (ROADMAP A.11); evaluate on one device")
    device = resolve_device(args.device)  # no card and no --device cpu: raise

    name = args.checkpoint
    if not checkpoint_exists(args.checkpoint_dir, name) and checkpoint_exists(
            args.checkpoint_dir, "latest"):
        # a run whose val accuracy never improved has no best_model copy
        print(f"[Evaluator] no '{name}' checkpoint — falling back to 'latest'")
        name = "latest"
    model = load_model_for_inference(args.checkpoint_dir, name, device=device,
                                     dtype=torch.bfloat16 if args.bf16 else None)
    cfg = model.config

    tokenizer = answer_vocab = None
    tok_path = os.path.join(args.checkpoint_dir, "tokenizer.json")
    vocab_path = os.path.join(args.checkpoint_dir, "answer_vocab.json")
    if os.path.exists(tok_path):
        tokenizer = Tokenizer()
        tokenizer.load(tok_path)
    if os.path.exists(vocab_path):
        answer_vocab = AnswerVocabulary()
        answer_vocab.load(vocab_path)

    # demo data unless every real-data path is present on disk
    real_paths = [args.questions, args.annotations, args.images_dir]
    have_real = all(p and os.path.exists(p) for p in real_paths)
    if args.synthetic:
        from vqa_tpu_torch.data.synthetic import create_synthetic_loaders

        # the exact val split of the training run: scenes are deterministic
        # per (seed, index), and the spec rides in the checkpoint sidecar
        syn_spec = (load_checkpoint_meta(args.checkpoint_dir, name) or {}).get("synthetic")
        spatial = False
        if syn_spec:
            num_samples, seed = int(syn_spec["num_samples"]), int(syn_spec["seed"])
            spatial = bool(syn_spec.get("spatial", False))
        else:
            num_samples, seed = max(args.max_samples, 64), 42
            print("[Evaluator] WARNING: checkpoint has no synthetic-split metadata "
                  "(a non-synthetic training run); the rebuilt val split may overlap "
                  "the training scenes")
        _, loader, syn_tok, syn_vocab = create_synthetic_loaders(
            num_samples=num_samples, eval_batch_size=args.batch_size,
            image_size=cfg.image_size, max_question_length=cfg.max_question_length,
            seed=seed, spatial=spatial)
        # --max-samples caps the work: the val index range is cut, and stays
        # inside the held-out range
        if args.max_samples and len(loader.indices) > args.max_samples:
            loader.indices = loader.indices[: args.max_samples]
            print(f"[Evaluator] --max-samples caps the val split to "
                  f"{args.max_samples} of {num_samples - int(num_samples * 0.8)}")
        # decode with the vocab that labeled the loader
        if answer_vocab is not None and answer_vocab.answer2idx != syn_vocab.answer2idx:
            print("[Evaluator] WARNING: checkpoint answer vocab differs from the synthetic "
                  "answer set — decoding with the synthetic vocab")
        answer_vocab = syn_vocab
        tokenizer = syn_tok
    elif args.demo or not have_real:
        if not args.demo and any(real_paths):
            print("[Evaluator] real-data paths missing/incomplete — demo data")
        ds = DemoVQADataset(
            num_samples=min(args.max_samples, 256), image_size=cfg.image_size,
            max_question_length=cfg.max_question_length, vocab_size=cfg.vocab_size,
            num_answers=cfg.num_answers)
        loader = BatchLoader(ds, args.batch_size, drop_last=False)
    else:
        ds = VQADataset(
            args.questions, args.annotations, args.images_dir, tokenizer=tokenizer,
            answer_vocab=answer_vocab, num_answers=cfg.num_answers,
            max_question_length=cfg.max_question_length, max_samples=args.max_samples,
            is_training=False, image_size=cfg.image_size)
        loader = BatchLoader(ds, args.batch_size, drop_last=False)

    ev = Evaluator(model, answer_vocab)
    results = ev.evaluate(loader)
    results["sample_predictions"] = ev.sample_predictions(loader, tokenizer)
    report = ev.generate_report(results)
    print(report)

    out_dir = args.output_dir or args.checkpoint_dir
    os.makedirs(out_dir, exist_ok=True)
    # the reference evaluator's key names beside ours, so tooling that reads
    # its evaluation_results.json reads this one unchanged
    artifact = dict(results)
    aliases = {
        "accuracy": results.get("top1_accuracy"),
        "accuracy_top5": results.get("top5_accuracy"),
        "total_samples": results.get("num_samples"),
        "per_class_accuracy": results.get("per_class_accuracy_top"),
    }
    if results.get("error_pairs") is not None:
        # the reference's error entries are {predicted_idx, target_idx, count,
        # predicted=<decoded str>, target=<decoded str>}
        aliases["common_errors"] = [
            {
                "predicted_idx": e["predicted"],
                "target_idx": e["target"],
                "count": e["count"],
                **({"predicted": e["predicted_answer"], "target": e["target_answer"]}
                   if "predicted_answer" in e else {}),
            }
            for e in results["error_pairs"]
        ]
    if results.get("num_samples") and results.get("top1_accuracy") is not None:
        aliases["correct"] = round(results["top1_accuracy"] * results["num_samples"])
    artifact.update({k: v for k, v in aliases.items() if v is not None})
    with open(os.path.join(out_dir, "evaluation_results.json"), "w") as f:
        json.dump(artifact, f, indent=2)
    with open(os.path.join(out_dir, "evaluation_report.txt"), "w") as f:
        f.write(report)
    return results


if __name__ == "__main__":
    main()
