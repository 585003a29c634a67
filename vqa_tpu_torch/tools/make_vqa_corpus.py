"""Write a VQA-v2-schema corpus on disk from the synthetic scene engine.

    python -m vqa_tpu_torch.tools.make_vqa_corpus --out data/vqa_synth --num-images 1000
    python -m vqa_tpu_torch.tools.make_vqa_corpus --out data/spatial --spatial --seed 42

Counterpart of ``scripts/make_vqa_corpus.py:1-179``, built on the port's
``data/synthetic.py``; the same arguments write the same files. The layout
is VQA-v2/COCO's, which the port's ``VQADataset`` (and the train CLI's
``--questions/--annotations/--images-dir``) read unchanged:

    {out}/images/{image_id:012d}.jpg   COCO file names
    {out}/questions.json               {"questions": [{question_id, image_id, question}]}
    {out}/annotations.json             {"annotations": [{question_id, image_id,
                                        question_type, multiple_choice_answer,
                                        answers: [{answer, answer_confidence,
                                        answer_id}] x 10}]}
    {out}/corpus_meta.json             the arguments and counts

Scenes are learnable (coloured shapes), deterministic per seed, with
annotator disagreement among the 10 answers of each question.
``--spatial`` mixes in grid-localized questions ("what color is the shape
in the top left"), the corpus the attention-faithfulness measurement
(``tools/attention_faithfulness.py``) reads. The JPEG bytes depend on
PIL's libjpeg build; the decoded scenes do not.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from vqa_tpu_torch.data.synthetic import (
    ANSWERS,
    SPATIAL_ANSWERS,
    SPATIAL_DRAW,
    _draw_scene,
    _make_qa,
    _make_spatial_qa,
)


def make_corpus(
    out_dir: str,
    num_images: int = 1000,
    questions_per_image: int = 3,
    image_size: int = 320,
    seed: int = 42,
    spatial: bool = False,
    annotator_noise: float = 0.1,
    quality: int = 88,
) -> dict:
    """Write the corpus; returns summary stats."""
    images_dir = os.path.join(out_dir, "images")
    os.makedirs(images_dir, exist_ok=True)
    questions, annotations = [], []
    answer_pool = SPATIAL_ANSWERS if spatial else ANSWERS
    master = np.random.default_rng(np.random.SeedSequence([0xC0FFEE, seed]))

    for i in range(num_images):
        image_id = i + 1
        rng = np.random.default_rng(
            np.random.SeedSequence([0xC0FFEE, seed, image_id])
        )
        # spatial corpora render larger/steadier shapes (SPATIAL_DRAW) so
        # shape identity is resolvable post-downsampling — see synthetic.py
        img, placed = _draw_scene(
            rng, image_size, **(SPATIAL_DRAW if spatial else {})
        )
        img.save(
            os.path.join(images_dir, f"{image_id:012d}.jpg"),
            quality=quality,
        )
        seen = set()
        for j in range(questions_per_image):
            if spatial and int(rng.integers(0, 2)):
                q, a, qtype = _make_spatial_qa(rng, placed)
            else:
                q, a, qtype = _make_qa(rng, placed)
            if q in seen:  # VQA-v2 has distinct questions per image
                continue
            seen.add(q)
            qid = image_id * 1000 + j
            questions.append(
                {"question_id": qid, "image_id": image_id, "question": q}
            )
            # 10 annotators, most agreeing (official VQA answers carry
            # disagreement; soft accuracy min(1, agreement/3) needs it)
            ann_answers = []
            for k in range(10):
                ans = a
                if master.random() < annotator_noise:
                    ans = str(master.choice(answer_pool))
                ann_answers.append(
                    {
                        "answer": ans,
                        "answer_confidence": "yes",
                        "answer_id": k + 1,
                    }
                )
            annotations.append(
                {
                    "question_id": qid,
                    "image_id": image_id,
                    "question_type": qtype,
                    "answer_type": "other",
                    "multiple_choice_answer": a,
                    "answers": ann_answers,
                }
            )

    with open(os.path.join(out_dir, "questions.json"), "w") as f:
        json.dump(
            {
                "info": {"description": "synthetic VQA-v2-schema corpus"},
                "task_type": "Open-Ended",
                "data_type": "synthetic-shapes",
                "questions": questions,
            },
            f,
        )
    with open(os.path.join(out_dir, "annotations.json"), "w") as f:
        json.dump(
            {
                "info": {"description": "synthetic VQA-v2-schema corpus"},
                "data_type": "synthetic-shapes",
                "annotations": annotations,
            },
            f,
        )
    meta = {
        "num_images": num_images,
        "num_questions": len(questions),
        "image_size": image_size,
        "seed": seed,
        "spatial": spatial,
        "annotator_noise": annotator_noise,
    }
    with open(os.path.join(out_dir, "corpus_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--num-images", type=int, default=1000)
    p.add_argument("--questions-per-image", type=int, default=3)
    p.add_argument("--image-size", type=int, default=320)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--spatial", action="store_true")
    p.add_argument("--annotator-noise", type=float, default=0.1)
    p.add_argument("--quality", type=int, default=88)
    args = p.parse_args(argv)
    meta = make_corpus(
        args.out,
        num_images=args.num_images,
        questions_per_image=args.questions_per_image,
        image_size=args.image_size,
        seed=args.seed,
        spatial=args.spatial,
        annotator_noise=args.annotator_noise,
        quality=args.quality,
    )
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
