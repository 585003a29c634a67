"""The port's data path and metrics against the JAX package's, on the CPU.

Loaders, datasets and host preprocessing are numpy in both packages: the
same seeds and indices must give byte-identical batches. The metric math
is held to JAX's exactly (counts, confusion matrix) or to f32 rounding
(1e-6, soft scores and per-class accuracy); ``MetricsLogger`` writes the
same bytes. The augmentation's apply step takes the draws JAX makes from
its own key splits and must give JAX's pixels within 1e-5 (f32 sums of a
3×3 colour matrix taken in another order).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_tpu.data import dataset as jax_dataset
from vqa_tpu.data import preprocess as jax_pre
from vqa_tpu.data import synthetic as jax_syn
from vqa_tpu.utils import metrics as jax_metrics
from vqa_tpu_torch.data import dataset, pipeline, preprocess, synthetic
from vqa_tpu_torch.utils import metrics
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "mini_vqa")


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def _logits(seed=0, b=16, n=9):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, n)).astype(np.float32)
    logits[0, :] = 0.5  # ties: the target counts as top-1 by argmax only
    return logits, rng.integers(0, n, b).astype(np.int32)


def test_metric_math_matches_jax():
    logits, targets = _logits()
    tl, tt = torch.from_numpy(logits), torch.from_numpy(targets)
    for k in (1, 3, 5):
        f1, fk = metrics.topk_flags(tl, tt, k)
        j1, jk = jax_metrics.topk_flags(jnp.asarray(logits), jnp.asarray(targets), k)
        np.testing.assert_array_equal(f1.numpy(), np.asarray(j1))
        np.testing.assert_array_equal(fk.numpy(), np.asarray(jk))
        c1, ck = metrics.topk_correct(tl, tt, k)
        jc1, jck = jax_metrics.topk_correct(jnp.asarray(logits), jnp.asarray(targets), k)
        assert (int(c1), int(ck)) == (int(jc1), int(jck)) and c1.dtype == torch.int32
        assert metrics.compute_accuracy(logits, targets, k) == \
            jax_metrics.compute_accuracy(logits, targets, k)
    rng = np.random.default_rng(1)
    pred = rng.integers(0, 9, 16).astype(np.int32)
    ann = rng.integers(-1, 9, (16, 10)).astype(np.int32)
    np.testing.assert_allclose(metrics.vqa_soft_scores(torch.from_numpy(pred),
                                                       torch.from_numpy(ann)).numpy(),
                               np.asarray(jax_metrics.vqa_soft_scores(pred, ann)), atol=1e-6)
    cm = metrics.confusion_matrix(torch.from_numpy(pred), tt, 9)
    jcm = jax_metrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(targets), 9)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    np.testing.assert_allclose(metrics.per_class_accuracy(cm).numpy(),
                               np.asarray(jax_metrics.per_class_accuracy(jcm)), atol=1e-6)


def test_accumulators_match_jax(tmp_path):
    logits, targets = _logits(2)
    types = ["what color", "how many", "is there", "what color"] * 4
    for mod in (metrics, jax_metrics):
        acc = mod.VQAAccuracy(top_k=5)
        acc.update(logits, targets, types)
        acc.update_counts(3, 5, 8)
        soft = mod.VQAChallengeAccuracy()
        soft.update(targets, np.tile(targets[:, None], (1, 10)))
        meter = mod.AverageMeter("loss")
        for v, n in ((1.5, 2), (0.5, 6)):
            meter.update(v, n)
        logger = mod.MetricsLogger()
        logger.log(0, {"train_loss": 2.0, "val_top1": 0.25})
        logger.log(1, {"train_loss": 1.5, "val_top1": 0.5})
        logger.save(str(tmp_path / mod.__name__ / "history.json"))
        if mod is metrics:
            port = (acc.compute(), soft.compute(), meter.avg, logger.get_best("val_top1"),
                    logger.get_best("train_loss", "min"))
    assert port == (acc.compute(), soft.compute(), meter.avg, logger.get_best("val_top1"),
                    logger.get_best("train_loss", "min"))
    written = [(tmp_path / m.__name__ / "history.json").read_bytes()
               for m in (metrics, jax_metrics)]
    assert written[0] == written[1]
    back = metrics.MetricsLogger.from_dict(json.loads(written[0]))
    assert back.to_dict() == logger.to_dict()


# ---------------------------------------------------------------------------
# Host preprocessing and the device augmentation's apply step
# ---------------------------------------------------------------------------

def test_host_preprocessing_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
    x = rng.random((8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(preprocess.normalize_image(img), jax_pre.normalize_image(img))
    np.testing.assert_array_equal(preprocess.normalize_image(x), jax_pre.normalize_image(x))
    np.testing.assert_array_equal(preprocess.denormalize_image(x),
                                  jax_pre.denormalize_image(x))
    for normalize in (True, False):
        np.testing.assert_array_equal(preprocess.preprocess_image(img, 32, normalize),
                                      jax_pre.preprocess_image(img, 32, normalize))
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    np.testing.assert_array_equal(preprocess.preprocess_image_bytes(buf.getvalue(), 24),
                                  jax_pre.preprocess_image_bytes(buf.getvalue(), 24))
    np.testing.assert_array_equal(
        preprocess.augment_image(img, np.random.default_rng(5), 32),
        jax_pre.augment_image(img, np.random.default_rng(5), 32))
    samples = [{"image": img, "token_ids": np.arange(4), "attention_mask": np.ones(4),
                "answer": i} for i in range(3)]
    _same_batches([preprocess.vqa_collate(samples)], [jax_pre.vqa_collate(samples)])
    assert preprocess.normalize_question(" what  is this") == \
        jax_pre.normalize_question(" what  is this")
    assert preprocess.validate_question("what") == jax_pre.validate_question("what")


def _jax_draws(key, b, max_off, bright=0.2, contrast=0.2, sat=0.2, hue=0.1):
    """The draws ``vqa_tpu``'s device_augment makes from ``key``."""
    k_crop, k_flip, k_b, k_c, k_s, k_h = jax.random.split(key, 6)
    return {
        "offsets": torch.from_numpy(np.array(
            jax.random.randint(k_crop, (b, 2), 0, max_off + 1))),
        "flip": torch.from_numpy(np.array(jax.random.bernoulli(k_flip, 0.5, (b,)))),
        "brightness": torch.from_numpy(np.array(jax.random.uniform(
            k_b, (b, 1, 1, 1), minval=1 - bright, maxval=1 + bright)).reshape(b)),
        "contrast": torch.from_numpy(np.array(jax.random.uniform(
            k_c, (b, 1, 1, 1), minval=1 - contrast, maxval=1 + contrast)).reshape(b)),
        "saturation": torch.from_numpy(np.array(jax.random.uniform(
            k_s, (b, 1, 1, 1), minval=1 - sat, maxval=1 + sat)).reshape(b)),
        "hue": torch.from_numpy(np.array(
            jax.random.uniform(k_h, (b,), minval=-hue, maxval=hue) * (2 * np.pi))),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_augment_matches_jax_with_the_same_draws(seed):
    s, b = 24, 6
    rng = np.random.default_rng(seed)
    pixels = rng.integers(0, 256, (b, s + 32, s + 32, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_pre.device_augment(jnp.asarray(pixels), key, image_size=s))
    draws = _jax_draws(key, b, 32)
    assert draws["flip"].any() and not draws["flip"].all()
    got = preprocess.apply_augment(torch.from_numpy(pixels), draws, s)
    assert got.shape == (b, s, s, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_draw_augment_ranges_and_determinism():
    gen = torch.Generator().manual_seed(7)
    draws = preprocess.draw_augment(64, 56, 24, gen)
    again = preprocess.draw_augment(64, 56, 24, torch.Generator().manual_seed(7))
    for k, v in draws.items():
        assert v.shape[0] == 64 and torch.equal(v, again[k]), k
    assert draws["offsets"].min() >= 0 and draws["offsets"].max() <= 32
    assert draws["offsets"].shape == (64, 2) and 0 < draws["flip"].sum() < 64
    for k in ("brightness", "contrast", "saturation"):
        assert 0.8 <= float(draws[k].min()) and float(draws[k].max()) < 1.2, k
    assert float(draws["hue"].abs().max()) <= 0.1 * 2 * np.pi
    pixels = torch.randint(0, 256, (64, 56, 56, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    out = preprocess.device_augment(pixels, torch.Generator().manual_seed(7), image_size=24)
    assert torch.equal(out, preprocess.apply_augment(pixels, draws, 24))
    lo = float(((0.0 - preprocess.IMAGENET_MEAN) / preprocess.IMAGENET_STD).min()) - 1e-5
    hi = float(((1.0 - preprocess.IMAGENET_MEAN) / preprocess.IMAGENET_STD).max()) + 1e-5
    assert lo <= float(out.min()) and float(out.max()) <= hi


# ---------------------------------------------------------------------------
# Synthetic data, datasets and loaders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spatial", [False, True])
@pytest.mark.parametrize("mode", ["val", "host_aug", "device_aug"])
def test_synthetic_samples_are_byte_identical(spatial, mode):
    kw = dict(num_samples=12, image_size=32, max_question_length=8,
              is_training=mode != "val", device_augment=mode == "device_aug", seed=3,
              spatial=spatial)
    port, ref = synthetic.SyntheticVQADataset(**kw), jax_syn.SyntheticVQADataset(**kw)
    assert port.tokenizer.word2idx == ref.tokenizer.word2idx
    assert port.answer_vocab.answer2idx == ref.answer_vocab.answer2idx
    assert port.type_vocab() == ref.type_vocab()
    for i in range(len(ref)):
        got, want = port[i], ref[i]
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert synthetic.generate_scene(4, 48) == jax_syn.generate_scene(4, 48)


def test_synthetic_loaders_give_identical_batches():
    kw = dict(num_samples=40, batch_size=8, eval_batch_size=6, image_size=32,
              max_question_length=8, seed=5)
    port = synthetic.create_synthetic_loaders(**kw)
    ref = jax_syn.create_synthetic_loaders(**kw)
    for loader, ref_loader in zip(port[:2], ref[:2]):
        _same_batches(loader, ref_loader)
    val = list(port[1])
    assert val[-1]["valid"] == 2 and val[-1]["valid_mask"].tolist() == [1, 1, 0, 0, 0, 0]
    assert port[2].vocab_size == ref[2].vocab_size


def test_demo_loaders_shuffle_pad_and_resume_like_jax():
    kw = dict(batch_size=4, eval_batch_size=3, num_samples=22, image_size=16,
              max_question_length=6, vocab_size=50, num_answers=8, seed=9)
    train, val = dataset.create_demo_loaders(**kw)
    jtrain, jval = jax_dataset.create_demo_loaders(**kw)
    for epoch in range(2):
        train.set_epoch(epoch)
        jtrain.set_epoch(epoch)
        _same_batches(train, jtrain)
    _same_batches(val, jval)
    last = list(val)[-1]
    assert last["valid"] == 2 and last["valid_mask"].tolist() == [1, 1, 0]
    # (seed, epoch)-pinned: epoch 1 of an uninterrupted loader = a fresh one set to 1
    fresh = dataset.create_demo_loaders(**kw)[0]
    uninterrupted = dataset.create_demo_loaders(**kw)[0]
    list(uninterrupted)
    second = list(uninterrupted)
    fresh.set_epoch(1)
    _same_batches(fresh, second)
    assert [b["answer"].tolist() for b in second] != [b["answer"].tolist()
                                                      for b in dataset.create_demo_loaders(**kw)[0]]


def test_num_workers_matches_inline():
    ds = synthetic.SyntheticVQADataset(num_samples=16, image_size=32, max_question_length=6,
                                       is_training=False, seed=3)
    inline = dataset.BatchLoader(ds, 4, shuffle=False, drop_last=False)
    threaded = dataset.BatchLoader(ds, 4, shuffle=False, drop_last=False, num_workers=4)
    try:
        _same_batches(threaded, inline)
    finally:
        threaded.close()
    aug = synthetic.SyntheticVQADataset(num_samples=16, image_size=32, max_question_length=6,
                                        is_training=True, seed=3)
    loader = dataset.BatchLoader(aug, 4, shuffle=True, drop_last=True, num_workers=4)
    try:
        for batch in loader:
            assert batch["image"].shape == (4, 32, 32, 3) and np.isfinite(batch["image"]).all()
    finally:
        loader.close()


def test_vqa_dataset_loaders_and_type_ids_match_jax():
    paths = [os.path.join(FIXTURE, f) for f in ("questions.json", "annotations.json", "images")]
    kw = dict(batch_size=8, eval_batch_size=8, max_samples=60, max_question_length=8,
              vocab_size=100, num_answers=12, image_size=32, seed=4)
    port = dataset.create_train_val_loaders(*paths, **kw)
    ref = jax_dataset.create_train_val_loaders(*paths, **kw)
    assert port[2].word2idx == ref[2].word2idx
    assert port[3].answer2idx == ref[3].answer2idx
    _same_batches(port[1], ref[1])  # val: deterministic transform, padded
    assert port[1].type_vocab == ref[1].type_vocab and port[1].type_vocab
    # host augmentation draws from a generator shared by the samples: the
    # first pass of each package from a fresh dataset is the same
    _same_batches(port[0], ref[0])
    assert dataset.check_data(*paths) == jax_dataset.check_data(*paths) > 0

    # an unknown question type lands in the overflow bucket len(type_vocab)
    val = port[1]
    val.dataset.samples[int(val.indices[0])]["question_type"] = "never seen"
    ids = next(iter(val))["type_ids"]
    assert ids[0] == len(val.type_vocab) and ids.dtype == np.int32


def test_device_augment_dataset_returns_uint8_crop_sources():
    paths = [os.path.join(FIXTURE, f) for f in ("questions.json", "annotations.json", "images")]
    ds = dataset.VQADataset(*paths, num_answers=12, max_question_length=8, vocab_size=100,
                            max_samples=4, image_size=32, device_augment=True)
    ref = jax_dataset.VQADataset(*paths, num_answers=12, max_question_length=8,
                                 vocab_size=100, max_samples=4, image_size=32,
                                 device_augment=True)
    for i in range(len(ref)):
        got, want = ds[i], ref[i]
        assert got["image"].dtype == np.uint8 and got["image"].shape == (64, 64, 3)
        for k in ("image", "token_ids", "attention_mask", "annotator_answers"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# Prefetch
# ---------------------------------------------------------------------------

def test_prefetch_to_device_yields_the_batches_as_tensors():
    kw = dict(batch_size=4, eval_batch_size=3, num_samples=20, image_size=16,
              max_question_length=6, vocab_size=50, num_answers=8)
    _, val = dataset.create_demo_loaders(**kw)
    want = list(val)
    got = list(pipeline.prefetch_to_device(val, "cpu", size=2))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
                np.testing.assert_array_equal(g[k].numpy(), v)
            else:
                assert g[k] == v


def test_prefetch_to_device_defaults_to_the_card():
    """The JAX helper places batches on the default device (the chip); the
    port's takes the card unless the caller passes "cpu"."""
    import inspect

    sig = inspect.signature(pipeline.prefetch_to_device)
    assert sig.parameters["device"].default == "cuda"


def test_prefetch_to_device_raises_the_producers_error():
    def broken():
        yield {"x": np.zeros(2)}
        raise OSError("disk gone")

    it = pipeline.prefetch_to_device(broken(), "cpu")
    assert next(it)["x"].shape == (2,)
    with pytest.raises(OSError, match="disk gone"):
        next(it)
