"""The port's native resampler (``vqa_tpu_torch/native``) against PIL and
against the JAX package's library (``vqa_tpu/native``), and its wiring:
the batch path, the fused normalize, the preprocess routes through it, the
PIL fallback, the kept build error, concurrent builds and the rebuild of a
stale library.

The size cases are those of ``tests/test_native.py:34``. The resize must be
bit-identical (max abs diff 0): switching between the native path and PIL
must never change the pixels the model sees.
"""

import io
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
from PIL import Image

from vqa_tpu import native as jax_native
from vqa_tpu_torch import native
from vqa_tpu_torch.data import preprocess
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(1234)


@pytest.fixture(scope="module")
def built():
    """Both libraries, built here (this host has g++)."""
    assert native.available(), native.build_error()
    assert jax_native.available()


@pytest.mark.parametrize("sh,sw,dh,dw", [
    (480, 640, 224, 224),   # COCO downscale
    (224, 224, 224, 224),   # identity
    (100, 150, 224, 224),   # upscale
    (37, 501, 224, 224),    # extreme aspect ratio
    (300, 300, 7, 13),      # aggressive downscale, non-square target
    (224, 224, 256, 256),   # the train path's S+32
    (1, 1, 224, 224),       # a single pixel
])
def test_resize_is_bit_identical_to_pil_and_the_jax_library(built, sh, sw, dh, dw):
    img = RNG.integers(0, 256, size=(sh, sw, 3), dtype=np.uint8)
    got = native.resize_bilinear(img, dh, dw)
    assert got.shape == (dh, dw, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(Image.fromarray(img).resize((dw, dh),
                                                                             Image.BILINEAR)))
    np.testing.assert_array_equal(got, jax_native.resize_bilinear(img, dh, dw))


def test_batch_equals_single(built):
    imgs = [RNG.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
            for h, w in [(480, 640), (123, 456), (224, 224), (640, 480), (1, 1)]]
    for threads in (0, 1, 3):
        batch = native.resize_bilinear_batch(imgs, 224, 224, num_threads=threads)
        assert batch.shape == (5, 224, 224, 3)
        for i, img in enumerate(imgs):
            np.testing.assert_array_equal(batch[i], native.resize_bilinear(img, 224, 224))
    assert native.resize_bilinear_batch([], 224, 224).shape == (0, 224, 224, 3)
    with pytest.raises(ValueError):
        native.resize_bilinear_batch([imgs[0], imgs[1][..., :2]], 224, 224)


def test_normalize_f32_matches_numpy(built):
    img = RNG.integers(0, 256, size=(64, 48, 3), dtype=np.uint8)
    got = native.normalize_f32(img, preprocess.IMAGENET_MEAN, preprocess.IMAGENET_STD)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, preprocess.normalize_image(img), rtol=0, atol=1e-6)


def _uploads():
    """JPEG and PNG uploads of mixed sizes."""
    out = []
    for i, (h, w) in enumerate([(480, 640), (64, 64), (1024, 768), (224, 224)]):
        buf = io.BytesIO()
        Image.fromarray(RNG.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            buf, ("JPEG", "PNG")[i % 2])
        out.append(buf.getvalue())
    return out


def _counting(monkeypatch, name):
    calls = []
    orig = getattr(native, name)

    def counted(*args, **kwargs):
        calls.append(len(args[0]) if name.endswith("batch") else 1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(native, name, counted)
    return calls


@pytest.mark.parametrize("route", ["resize_batch_to_uint8", "engine", "batcher"])
def test_served_groups_resize_on_the_native_pool(built, monkeypatch, route):
    """``resize_batch_to_uint8``, the engine's ``_preprocess_images`` and
    the micro-batcher's group decode each resize a whole group in one call
    of the native batch resize."""
    uploads = _uploads()
    calls = _counting(monkeypatch, "resize_bilinear_batch")
    if route == "resize_batch_to_uint8":
        out = preprocess.resize_batch_to_uint8(uploads, 224)
    else:
        from vqa_tpu_torch.serving.engine import VQAInference
        from vqa_tpu_torch.utils.config import tiny_model_config

        engine = VQAInference(model_config=tiny_model_config(), device="cpu")
        if route == "engine":
            out = engine._preprocess_images(uploads)
        else:
            from vqa_tpu_torch.serving.batcher import MicroBatcher, _Request

            batcher = MicroBatcher(engine, max_batch_size=8, batch_timeout_ms=1.0)
            try:
                good, pixels = batcher._decode_group(
                    [_Request(u, "what is this", 1) for u in uploads])
            finally:
                batcher.shutdown()
            assert len(good) == len(uploads)
            out = np.stack(pixels)
    size = out.shape[1]
    assert calls == [len(uploads)]
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        np.testing.assert_array_equal(out, preprocess.resize_batch_to_uint8(uploads, size))


def test_without_the_library_pil_gives_the_same_bytes(built, monkeypatch):
    uploads = _uploads()
    native_single = [preprocess.resize_to_uint8(u, 224) for u in uploads]
    native_batch = preprocess.resize_batch_to_uint8(uploads, 224)
    monkeypatch.setattr(native, "available", lambda: False)
    calls = _counting(monkeypatch, "resize_bilinear")
    calls += _counting(monkeypatch, "resize_bilinear_batch")
    for u, want in zip(uploads, native_single):
        np.testing.assert_array_equal(preprocess.resize_to_uint8(u, 224), want)
    np.testing.assert_array_equal(preprocess.resize_batch_to_uint8(uploads, 224), native_batch)
    assert calls == []


def _fresh_state(monkeypatch, tmp_path, source):
    """Point the binding at ``source`` and a build directory under
    ``tmp_path``, not yet tried."""
    build = tmp_path / "build"
    monkeypatch.setattr(native, "SOURCE", str(source))
    monkeypatch.setattr(native, "BUILD_DIR", str(build))
    monkeypatch.setattr(native, "LIBRARY", str(build / "libvqa_preprocess.so"))
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    return build


def test_a_failed_build_is_kept_and_pil_resizes(monkeypatch, tmp_path, caplog):
    broken = tmp_path / "broken.cc"
    broken.write_text("int vqa_native_abi_version( { return 1; }\n")
    _fresh_state(monkeypatch, tmp_path, broken)
    with caplog.at_level("WARNING", logger=native.__name__):
        assert not native.available()
        assert not native.available()  # tried once, logged once
    assert "broken.cc" in native.build_error() and "error" in native.build_error()
    assert sum("unavailable" in r.message for r in caplog.records) == 1
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.resize_bilinear(np.zeros((4, 4, 3), np.uint8), 2, 2)
    img = RNG.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        preprocess.resize_to_uint8(img, 32),
        np.asarray(Image.fromarray(img).resize((32, 32), Image.BILINEAR)))
    assert not any(p.name.startswith(".libvqa") for p in (tmp_path / "build").iterdir())


def test_a_source_newer_than_the_library_is_rebuilt(monkeypatch, tmp_path):
    source = tmp_path / "vqa_preprocess.cc"
    shutil.copy(native.SOURCE, source)
    build = _fresh_state(monkeypatch, tmp_path, source)
    assert native.available() and native.build_error() is None
    lib = build / "libvqa_preprocess.so"
    first = lib.stat().st_mtime_ns
    later = time.time() + 5
    os.utime(source, (later, later))
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    assert native.available()
    assert lib.stat().st_mtime_ns > first


def test_concurrent_builds_each_load_a_whole_library(tmp_path):
    """Four processes build into one directory at once (test workers, a
    server and its worker): each compiles to its own temporary file and
    renames it into place, so every one loads a whole library."""
    code = (
        "import sys\n"
        "from vqa_tpu_torch import native\n"
        "native.BUILD_DIR = sys.argv[1]\n"
        "native.LIBRARY = sys.argv[1] + '/libvqa_preprocess.so'\n"
        "import numpy as np\n"
        "ok = native.available()\n"
        "out = native.resize_bilinear(np.full((9, 7, 3), 200, np.uint8), 4, 4) if ok else None\n"
        "print(ok, None if out is None else int(out.min()), native.build_error())\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    build = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", code, build], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert [o.split() for o, _ in outs] == [["True", "200", "None"]] * 4
    assert os.listdir(build) == ["libvqa_preprocess.so"]
