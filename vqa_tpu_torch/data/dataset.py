"""VQA-v2 dataset, demo dataset, and batch loaders.

Counterpart of ``vqa_tpu/data/dataset.py``: datasets yield numpy sample
dicts; ``BatchLoader`` produces fixed-shape numpy batches — the train
loader drops the last short batch, the eval loader pads it by repeating
sample 0 and carries ``valid``/``valid_mask`` — with integer ``type_ids``
(an explicit overflow bucket for unknown types), a (seed, epoch)-pinned
shuffle (``set_epoch``) and an optional decode thread pool
(``num_workers``). The same indices give the same numpy batches as the JAX
package's loaders. ``create_train_val_loaders`` builds the sample list,
vocabulary and tokenizer once and shares them across the two splits.
``shard_for_process`` gives each data-parallel rank its own equal-length
slice of a loader's samples.
"""

from __future__ import annotations

import json
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from vqa_tpu_torch.data.preprocess import augment_image, preprocess_image
from vqa_tpu_torch.data.vocab import AnswerVocabulary
from vqa_tpu_torch.utils.tokenizer import Tokenizer, create_tokenizer_from_questions


class VQADataset:
    """VQA-v2 questions + annotations + COCO images
    (reference: data/dataset.py:41-259).

    Samples are filtered to images that exist on disk (filename
    ``{image_id:012d}.jpg``) and answers inside the answer vocabulary.
    """

    def __init__(
        self,
        questions_path: str,
        annotations_path: str,
        images_dir: str,
        tokenizer: Optional[Tokenizer] = None,
        answer_vocab: Optional[AnswerVocabulary] = None,
        num_answers: int = 1000,
        max_question_length: int = 20,
        vocab_size: int = 10000,
        max_samples: Optional[int] = None,
        is_training: bool = True,
        image_size: int = 224,
        seed: int = 42,
        device_augment: bool = False,
    ):
        self.images_dir = images_dir
        self.is_training = is_training
        self.image_size = image_size
        # device_augment: training samples come back as uint8 host-resized
        # (S+32) crop sources; crop/flip/jitter/normalize run on the card
        # (data.preprocess.device_augment), off the host's cores
        self.device_augment = device_augment
        self._rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()

        with open(questions_path, "r", encoding="utf-8") as f:
            questions = json.load(f)["questions"]
        with open(annotations_path, "r", encoding="utf-8") as f:
            annotations = json.load(f)["annotations"]
        ann_by_qid = {a["question_id"]: a for a in annotations}

        # answer vocabulary (primary answers, reference: data/dataset.py:124-134)
        if answer_vocab is None:
            answer_vocab = AnswerVocabulary(num_answers=num_answers)
            answer_vocab.build_from_qa_pairs(
                [
                    {"answer": ann_by_qid[q["question_id"]]["multiple_choice_answer"]}
                    for q in questions
                    if q["question_id"] in ann_by_qid
                ]
            )
        self.answer_vocab = answer_vocab

        # sample list: image exists + answer in vocab
        # (reference: data/dataset.py:151-202)
        self.samples: List[dict] = []
        for q in questions:
            ann = ann_by_qid.get(q["question_id"])
            if ann is None:
                continue
            image_file = os.path.join(
                images_dir, f"{q['image_id']:012d}.jpg"
            )
            if not os.path.exists(image_file):
                continue
            answer_idx = answer_vocab.encode(ann["multiple_choice_answer"])
            if answer_idx < 0:
                continue
            self.samples.append(
                {
                    "image_path": image_file,
                    "question": q["question"],
                    "question_id": q["question_id"],
                    "answer": answer_idx,
                    "question_type": ann.get("question_type", "unknown"),
                    "annotator_answers": [
                        answer_vocab.encode(a["answer"])
                        for a in ann.get("answers", [])
                    ],
                }
            )
            if max_samples is not None and len(self.samples) >= max_samples:
                break

        # tokenizer from sample questions (reference: data/dataset.py:141-149)
        if tokenizer is None:
            tokenizer = create_tokenizer_from_questions(
                [s["question"] for s in self.samples],
                max_length=max_question_length,
                vocab_size=vocab_size,
            )
        self.tokenizer = tokenizer
        print(f"[VQADataset] {len(self.samples)} usable samples")

    def __len__(self) -> int:
        return len(self.samples)

    def type_vocab(self) -> List[str]:
        """Sorted distinct question types — lets loaders carry integer
        ``type_ids`` so per-type accuracy reduces on the device.
        Metadata-only: no image I/O."""
        return sorted({s["question_type"] for s in self.samples})

    def __getitem__(self, idx: int) -> dict:
        s = self.samples[idx]
        if self.is_training and self.device_augment:
            image = preprocess_image(
                s["image_path"], self.image_size + 32, normalize=False
            )  # uint8 crop source; augmentation happens on-device
        elif self.is_training:
            # spawn a child generator under the lock: numpy Generators are
            # not thread-safe, and BatchLoader(num_workers>0) fetches
            # samples concurrently; the (cheap) spawn is serialized, the
            # decode+augment runs in parallel
            with self._rng_lock:
                rng = self._rng.spawn(1)[0]
            image = augment_image(s["image_path"], rng, self.image_size)
        else:
            image = preprocess_image(s["image_path"], self.image_size)
        ids, mask = self.tokenizer.encode(s["question"])
        # fixed [10] vector of annotator answer indices (-1 = OOV/absent)
        # feeding the official VQA soft accuracy in the Evaluator
        ann = np.full(10, -1, np.int32)
        got = s["annotator_answers"][:10]
        ann[: len(got)] = got
        return {
            "image": image,
            "token_ids": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(mask, np.int32),
            "answer": s["answer"],
            "question_type": s["question_type"],
            "annotator_answers": ann,
        }


class DemoVQADataset:
    """Random tensors with real shapes — lets the whole stack run with zero
    downloaded data (reference: data/dataset.py:384-437)."""

    def __init__(
        self,
        num_samples: int = 256,
        image_size: int = 224,
        max_question_length: int = 20,
        vocab_size: int = 1000,
        num_answers: int = 1000,
        seed: int = 42,
    ):
        self.num_samples = num_samples
        self.image_size = image_size
        self.max_question_length = max_question_length
        self.vocab_size = vocab_size
        self.num_answers = num_answers
        self.seed = seed

    def __len__(self) -> int:
        return self.num_samples

    def type_vocab(self) -> List[str]:
        return ["demo"]

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        L = self.max_question_length
        q_len = int(rng.integers(3, L + 1))
        ids = np.zeros((L,), np.int32)
        ids[0] = 2  # START
        ids[1 : q_len - 1] = rng.integers(4, self.vocab_size, q_len - 2)
        ids[q_len - 1] = 3  # END
        mask = (np.arange(L) < q_len).astype(np.int32)
        return {
            "image": rng.normal(size=(self.image_size, self.image_size, 3)).astype(
                np.float32
            ),
            "token_ids": ids,
            "attention_mask": mask,
            "answer": int(rng.integers(0, self.num_answers)),
            "question_type": "demo",
        }


class BatchLoader:
    """Fixed-shape numpy batch iterator over a dataset.

    ``drop_last=True`` (train) keeps every batch the same shape. For eval, the final short batch is padded by repeating sample 0
    and a ``valid`` count is included so metrics ignore the padding.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = True,
        seed: int = 42,
        indices: Optional[Sequence[int]] = None,
        num_workers: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.indices = (
            np.asarray(indices, np.int64)
            if indices is not None
            else np.arange(len(dataset), dtype=np.int64)
        )
        # num_workers > 0 fetches a batch's samples on a thread pool —
        # JPEG decode + resize release the GIL (PIL C internals / the
        # native resampler), so on multi-core hosts decode parallelizes.
        # The analog of the reference's DataLoader num_workers knob
        # (reference: utils/config.py:163, configured but set to 0); here
        # threads, not processes — no pickling, shared tokenizer/vocab.
        self.num_workers = num_workers
        # integer question-type ids ride in every batch so per-type
        # accuracy can reduce on the device
        tv = getattr(dataset, "type_vocab", None)
        self.type_vocab = list(tv()) if callable(tv) else None
        self._type2id = (
            {t: i for i, t in enumerate(self.type_vocab)}
            if self.type_vocab
            else None
        )
        self._pool = None
        if num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=num_workers,
                thread_name_prefix="vqa-loader",
            )

    def close(self) -> None:
        """Release the decode thread pool (no-op for num_workers=0).

        Explicit-only — no ``__del__``: a shallow copy of a loader shares
        its pool, and a garbage-collected copy must not tear down a pool the
        original still uses. Unclosed idle pools are joined at interpreter
        exit by concurrent.futures anyway."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __len__(self) -> int:
        n = len(self.indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle order for the NEXT iteration to ``epoch``
        (torch DistributedSampler-style). Orders are derived from
        (seed, epoch), so epoch N's batch order is identical whether the
        run reached N uninterrupted or resumed from a checkpoint — the
        Trainer calls this every epoch."""
        self._epoch = epoch

    def __iter__(self):
        order = self.indices.copy()
        if self.shuffle:
            # (seed, epoch)-derived order; auto-advance when nobody calls
            # set_epoch so bare iteration still reshuffles per pass
            epoch = getattr(self, "_epoch", 0)
            np.random.default_rng([self.seed, epoch]).shuffle(order)
            self._epoch = epoch + 1
        for b in range(len(self)):
            idx = order[b * self.batch_size : (b + 1) * self.batch_size]
            valid = len(idx)
            if valid < self.batch_size:  # pad final eval batch
                pad = np.full(self.batch_size - valid, order[0], np.int64)
                idx = np.concatenate([idx, pad])
            if self._pool is not None:
                samples = list(
                    self._pool.map(lambda i: self.dataset[int(i)], idx)
                )
            else:
                samples = [self.dataset[int(i)] for i in idx]
            batch = {
                "image": np.stack([s["image"] for s in samples]),
                "token_ids": np.stack([s["token_ids"] for s in samples]),
                "attention_mask": np.stack(
                    [s["attention_mask"] for s in samples]
                ),
                "answer": np.asarray(
                    [s["answer"] for s in samples], np.int32
                ),
                "valid": valid,
                # per-sample pad mask: lets eval metrics reduce on device
                # (required under multi-host, where a host can't slice the
                # global array) — 1 for real samples, 0 for the pad copies
                "valid_mask": (
                    np.arange(self.batch_size) < valid
                ).astype(np.int32),
                "question_types": [s.get("question_type", "unknown") for s in samples],
            }
            if self._type2id is not None:
                # types not in the construction-time vocab map to the
                # sentinel len(vocab) — an explicit overflow bucket the
                # metric scatter allocates and then drops, instead of
                # silently crediting them to type 0
                batch["type_ids"] = np.asarray(
                    [
                        self._type2id.get(
                            s.get("question_type"), len(self._type2id)
                        )
                        for s in samples
                    ],
                    np.int32,
                )
            if "annotator_answers" in samples[0]:
                batch["annotator_answers"] = np.stack(
                    [s["annotator_answers"] for s in samples]
                )
            yield batch


def shard_for_process(
    loader: "BatchLoader",
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> "BatchLoader":
    """Per-rank sample sharding (counterpart of
    ``vqa_tpu.data.dataset.shard_for_process``): a copy of the loader over
    a disjoint stride-slice of its indices, so the data-parallel ranks step
    over distinct samples (orders still derive from (seed, epoch) via
    ``set_epoch``). The trainer passes the rank's data coordinate and the
    data-parallel degree, so the ranks of one model group read the same
    batches; the defaults are the process index and count. No-op for one
    shard."""
    import copy

    from vqa_tpu_torch.parallel import distributed

    pc = process_count if process_count is not None else distributed.process_count()
    pi = process_index if process_index is not None else distributed.process_index()
    if pc <= 1:
        return loader
    sharded = copy.copy(loader)
    # equal shard length on every rank: collectives run in lockstep, so a
    # rank with one extra batch would stall the others on its last step
    per = len(loader.indices) // pc
    sharded.indices = loader.indices[pi::pc][:per]
    return sharded


def create_train_val_loaders(
    questions_path: str,
    annotations_path: str,
    images_dir: str,
    batch_size: int = 32,
    eval_batch_size: int = 64,
    max_samples: Optional[int] = 25000,
    train_split: float = 0.8,
    max_question_length: int = 20,
    vocab_size: int = 10000,
    num_answers: int = 1000,
    image_size: int = 224,
    seed: int = 42,
    device_augment: bool = False,
    num_workers: int = 0,
) -> Tuple[BatchLoader, BatchLoader, Tokenizer, AnswerVocabulary]:
    """Build train/val loaders with a shared tokenizer + answer vocab
    (reference: data/dataset.py:262-377, minus the triple construction).

    Train indices get augmentation (host-side, or on-device when
    ``device_augment`` — the Trainer detects the uint8 batches); val uses
    the deterministic transform.
    """
    base = VQADataset(
        questions_path,
        annotations_path,
        images_dir,
        num_answers=num_answers,
        max_question_length=max_question_length,
        vocab_size=vocab_size,
        max_samples=max_samples,
        is_training=True,
        image_size=image_size,
        seed=seed,
        device_augment=device_augment,
    )
    # deterministic shuffled 80/20 split (reference: data/dataset.py:315-320)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(base))
    n_train = int(len(base) * train_split)
    train_idx, val_idx = perm[:n_train], perm[n_train:]

    # val view shares samples/tokenizer/vocab but disables augmentation
    import copy

    val_ds = copy.copy(base)
    val_ds.is_training = False

    train_loader = BatchLoader(
        base, batch_size, shuffle=True, drop_last=True, seed=seed,
        indices=train_idx, num_workers=num_workers,
    )
    val_loader = BatchLoader(
        val_ds, eval_batch_size, shuffle=False, drop_last=False,
        indices=val_idx, num_workers=num_workers,
    )
    return train_loader, val_loader, base.tokenizer, base.answer_vocab


def create_demo_loaders(
    batch_size: int = 32,
    eval_batch_size: int = 64,
    num_samples: int = 256,
    image_size: int = 224,
    max_question_length: int = 20,
    vocab_size: int = 1000,
    num_answers: int = 1000,
    seed: int = 42,
    num_workers: int = 0,
) -> Tuple[BatchLoader, BatchLoader]:
    """Demo loaders (reference: data/dataset.py:439-472)."""
    n_train = int(num_samples * 0.8)
    ds = DemoVQADataset(
        num_samples, image_size, max_question_length, vocab_size,
        num_answers, seed,
    )
    train = BatchLoader(
        ds, batch_size, shuffle=True, drop_last=True, seed=seed,
        num_workers=num_workers,
        indices=np.arange(n_train),
    )
    val = BatchLoader(
        ds, eval_batch_size, shuffle=False, drop_last=False,
        indices=np.arange(n_train, num_samples), num_workers=num_workers,
    )
    return train, val


def check_data(
    questions_path: str, annotations_path: str, images_dir: str
) -> int:
    """Data sanity check: question↔image alignment on disk
    (reference: check_data.py:6-66). Returns usable sample count."""
    with open(questions_path, "r", encoding="utf-8") as f:
        questions = json.load(f)["questions"]
    with open(annotations_path, "r", encoding="utf-8") as f:
        annotations = json.load(f)["annotations"]
    qids = {a["question_id"] for a in annotations}
    usable = 0
    for q in questions:
        if q["question_id"] not in qids:
            continue
        if os.path.exists(os.path.join(images_dir, f"{q['image_id']:012d}.jpg")):
            usable += 1
    if usable == 0:
        print("[check_data] WARNING: 0 usable samples — check paths")
    else:
        print(f"[check_data] {usable} usable samples")
    return usable


if __name__ == "__main__":  # python -m vqa_tpu_torch.data.dataset <q> <a> <imgdir>
    import sys

    if len(sys.argv) != 4:
        print("usage: python -m vqa_tpu_torch.data.dataset "
              "<questions.json> <annotations.json> <images_dir>")
        raise SystemExit(2)
    raise SystemExit(0 if check_data(*sys.argv[1:]) > 0 else 1)
