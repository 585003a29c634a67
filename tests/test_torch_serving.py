"""The port's HTTP serving layer against the JAX package's, on the CPU.

Handler-level parity: the port's ``VQAServer`` and the JAX ``VQAServer``,
on engines carrying the same weights (the JAX engine's variables moved into
the port with ``state_dict_from_jax``), answer the same ``fields`` dicts
with the same status codes and payloads — probabilities and confidences
within 1e-4, everything else equal (an error message's object address
aside). Then the contracts of ``tests/test_serving.py`` run against the
port: micro-batching, decode isolation, shutdown, the multipart parser,
schemas, the request cap, static files, 413, and the endpoints over a real
socket; and the CLI refuses to start without a GPU unless asked for the
CPU.
"""

import io
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

from vqa_tpu.serving.engine import VQAInference as JaxInference
from vqa_tpu.serving.server import VQAServer as JaxServer
from vqa_tpu.utils.config import InferenceConfig as JaxInferenceConfig
from vqa_tpu.utils.config import ModelConfig as JaxModelConfig
from vqa_tpu.utils.config import model_config_dict
from vqa_tpu_torch.compat.jax_weights import state_dict_from_jax
from vqa_tpu_torch.serving.batcher import MicroBatcher, _Request
from vqa_tpu_torch.serving.engine import VQAInference
from vqa_tpu_torch.serving.server import VQAServer, _parse_multipart_email, parse_multipart
from vqa_tpu_torch.utils.config import InferenceConfig, model_config_from_dict
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=50, embed_dim=16, num_answers=8, num_transformer_layers=1,
            num_attention_heads=2, ffn_hidden_dim=32, max_question_length=6,
            image_size=32, base_channels=8, stage_channels=(8, 16, 32, 64),
            feature_spatial_size=1)


def _png_bytes(size=40, color=(200, 30, 30)):
    buf = io.BytesIO()
    Image.new("RGB", (size, size), color).save(buf, "PNG")
    return buf.getvalue()


def _random_image(seed, fmt="PNG"):
    rng = np.random.default_rng(seed)
    h, w = rng.integers(20, 90, 2)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, fmt)
    return buf.getvalue()


@pytest.fixture(scope="module")
def engines():
    jcfg = JaxModelConfig(**TINY)
    jax_engine = JaxInference(model_config=jcfg,
                              config=JaxInferenceConfig(batch_buckets=(1, 4))).load()
    cfg = model_config_from_dict(model_config_dict(jcfg))
    engine = VQAInference(model_config=cfg, config=InferenceConfig(batch_buckets=(1, 4)),
                          device="cpu").load()
    engine.model.load_state_dict(state_dict_from_jax(jax_engine.variables, cfg), strict=True)
    return jax_engine, engine


@pytest.fixture(scope="module")
def servers(engines):
    jax_engine, engine = engines
    jax_server = JaxServer(engine=jax_engine, preload=False,
                           config=JaxInferenceConfig(max_request_batch=4))
    server = VQAServer(engine=engine, preload=False, config=InferenceConfig(max_request_batch=4))
    yield jax_server, server
    jax_server.batcher.shutdown()
    server.batcher.shutdown()


def _without_addresses(x):
    """An exception message names its objects by address (``<_io.BytesIO
    object at 0x7f...>``), which differs between any two calls."""
    if isinstance(x, str):
        return re.sub(r"0x[0-9a-f]+", "0x", x)
    if isinstance(x, dict):
        return {k: _without_addresses(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_without_addresses(v) for v in x]
    return x


def _assert_payloads_match(got, want, path=""):
    """Equal, except floats (probabilities, confidences, attention maps)
    within 1e-4."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (path, got, want)
        for k in want:
            _assert_payloads_match(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_payloads_match(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, float) and abs(got - want) <= 1e-4, (path, got, want)
    else:
        assert got == want, (path, got, want)


def _predict_fields(image=None, question="what color is this", top_k=None, filename="a.png"):
    fields = {}
    if image is not None:
        fields["image"] = [(filename, image)]
    if question is not None:
        fields["question"] = [(None, question.encode())]
    if top_k is not None:
        fields["top_k"] = [(None, str(top_k).encode())]
    return fields


def _batch_fields(images, questions):
    return {"images": [(f"{i}.png", b) for i, b in enumerate(images)],
            "questions": [(None, questions.encode())]}


PREDICT_CASES = {
    "png_top3": lambda: _predict_fields(_random_image(1), top_k=3),
    "jpeg_default_top_k": lambda: _predict_fields(_random_image(2, "JPEG"), "how many dogs",
                                                  filename="b.jpg"),
    "no_filename": lambda: _predict_fields(_random_image(3), "is this a man", filename=None),
    "no_image": lambda: _predict_fields(None),
    "one_word_question": lambda: _predict_fields(_random_image(4), "what"),
    "no_question": lambda: _predict_fields(_random_image(4), None),
    "not_an_image": lambda: _predict_fields(b"plain text", filename="notes.txt"),
    "corrupt_image": lambda: _predict_fields(b"not an image at all", filename="x.png"),
}


@pytest.mark.parametrize("endpoint", ["predict", "attention"])
@pytest.mark.parametrize("case", sorted(PREDICT_CASES))
def test_predict_and_attention_handlers_match_jax(servers, endpoint, case):
    jax_server, server = servers
    fields = PREDICT_CASES[case]()
    handler = f"handle_{endpoint}"
    want_status, want = getattr(jax_server, handler)(fields)
    got_status, got = getattr(server, handler)(fields)
    assert got_status == want_status
    _assert_payloads_match(_without_addresses(got), _without_addresses(want))
    if case in ("png_top3", "jpeg_default_top_k", "no_filename"):
        assert got["success"] is True and len(got["answers"]) == (3 if "top3" in case else 5)


BATCH_CASES = {
    "three": lambda: _batch_fields([_random_image(i) for i in range(3)],
                                   "what is this, how many dogs,is this a man"),
    "empty": lambda: {"questions": [(None, b"")]},
    "mismatch": lambda: _batch_fields([_random_image(5)], "what is this, what color is that"),
    "over_the_cap": lambda: _batch_fields([_png_bytes()] * 5, ",".join(["what is this"] * 5)),
    "corrupt_member": lambda: _batch_fields([_random_image(6), b"garbage"],
                                            "what is this,what is that"),
    "image_field_name": lambda: {"image": [("a.png", _random_image(7))],
                                 "questions": [(None, b"what is this")]},
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_predict_batch_handler_matches_jax(servers, case):
    jax_server, server = servers
    fields = BATCH_CASES[case]()
    want_status, want = jax_server.handle_predict_batch(fields)
    got_status, got = server.handle_predict_batch(fields)
    assert got_status == want_status
    _assert_payloads_match(_without_addresses(got), _without_addresses(want))


@pytest.mark.parametrize("path", ["/", "", "/health", "/model-info", "/nope", "/metrics"])
def test_get_handlers_match_jax(servers, path):
    jax_server, server = servers
    want_status, want = jax_server.handle_get(path)
    got_status, got = server.handle_get(path)
    assert got_status == want_status
    if path == "/metrics":  # the latencies differ; the counters' names do not
        assert got.keys() == want.keys()
    else:
        assert got == want
    if path == "/model-info":
        assert got["device"] == "cpu" and got["total_parameters"] > 0


def test_prometheus_text_matches_jax(servers):
    jax_server, server = servers
    fields = _predict_fields(_random_image(8))
    jax_server.handle_predict(fields)
    server.handle_predict(fields)
    got, want = server.prometheus_metrics(), jax_server.prometheus_metrics()
    assert [line.rsplit(" ", 1)[0] for line in got.splitlines()] == \
        [line.rsplit(" ", 1)[0] for line in want.splitlines()]
    assert 'vqa_request_latency_ms{quantile="0.5"}' in got


def test_model_info_does_not_shadow_the_served_device(engines):
    _, engine = engines
    info = engine.get_model_info()
    assert "device" not in info and info["backend"] == "cpu"


def test_engine_serving_hooks(engines):
    """``_preprocess_images`` and ``dispatch_probs_from_pixels`` as the
    batcher calls them: the padded device tensor and n, fetched later."""
    jax_engine, engine = engines
    images = [_random_image(i) for i in range(3)]
    pixels = engine._preprocess_images(images)
    assert pixels.shape == (3, 32, 32, 3) and pixels.dtype == np.uint8
    np.testing.assert_array_equal(pixels, jax_engine._preprocess_images(images))
    probs, n = engine.dispatch_probs_from_pixels(pixels, ["what is this"] * 3)
    assert n == 3 and tuple(probs.shape) == (4, TINY["num_answers"])
    np.testing.assert_allclose(probs.cpu().numpy()[:n],
                               engine.predict_probs_from_pixels(pixels, ["what is this"] * 3),
                               atol=1e-6)


def test_inference_engine_singleton(monkeypatch):
    from vqa_tpu_torch.serving import engine as engine_mod

    engine_mod.reset_engine()
    try:
        a = engine_mod.get_inference_engine(model_config=model_config_from_dict(TINY),
                                            device="cpu")
        assert a.model is not None and engine_mod.get_inference_engine() is a
    finally:
        engine_mod.reset_engine()
    assert engine_mod._ENGINE is None


def test_question_helpers_and_paths_match_jax():
    from vqa_tpu.data import preprocess as jax_pre
    from vqa_tpu.utils.config import PATHS as JAX_PATHS
    from vqa_tpu_torch.data import preprocess
    from vqa_tpu_torch.utils.config import PATHS

    for q in ["", "  what   is this ", "what is this?", "what", "a b c d"]:
        assert preprocess.normalize_question(q) == jax_pre.normalize_question(q)
        for k in (1, 2, 3):
            assert preprocess.validate_question(q, k) == jax_pre.validate_question(q, k)
    assert PATHS.checkpoint_dir == JAX_PATHS.checkpoint_dir
    assert PATHS.tokenizer_path == JAX_PATHS.tokenizer_path


# ---- the contracts of tests/test_serving.py, against the port ----------


def test_micro_batcher_batches_concurrent_requests(engines):
    _, engine = engines
    batcher = MicroBatcher(engine, max_batch_size=8, batch_timeout_ms=50)
    results = [None] * 6

    def call(i):
        results[i] = batcher.submit(_png_bytes(), "what color is this", 2)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    batcher.shutdown()
    assert all(r is not None for r in results)
    assert batcher.latency_stats()["count"] == 6
    assert batcher.total_batches < 6


def test_batcher_isolates_corrupt_image(engines):
    _, engine = engines
    batcher = MicroBatcher(engine, batch_timeout_ms=50.0)
    results = {}

    def call(name, payload):
        try:
            results[name] = batcher.submit(payload, "what is this", 3)
        except Exception as e:
            results[name] = e

    threads = [threading.Thread(target=call, args=("good", _png_bytes())),
               threading.Thread(target=call, args=("bad", b"not an image at all"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    batcher.shutdown()
    assert isinstance(results["bad"], Exception)
    assert isinstance(results["good"], dict) and results["good"]["answers"]


def test_batcher_shutdown_fails_fast_and_drains(engines):
    _, engine = engines
    b = MicroBatcher(engine, max_batch_size=4, batch_timeout_ms=1.0)
    b.shutdown()
    with pytest.raises(RuntimeError, match="shutting down"):
        b.submit(_png_bytes(), "what is this", timeout=5.0)
    stranded = _Request(image=_png_bytes(), question="q", top_k=5)
    b._q.put(stranded)
    b.shutdown()  # idempotent; drains the queue again
    assert stranded.event.is_set()
    assert isinstance(stranded.error, RuntimeError)


def test_batcher_answers_match_the_jax_batcher(engines):
    """The same 5 concurrent requests through both micro-batchers."""
    from vqa_tpu.serving.batcher import MicroBatcher as JaxBatcher

    jax_engine, engine = engines
    images = [_random_image(20 + i) for i in range(5)]
    out = {}
    for name, batcher in (("jax", JaxBatcher(jax_engine, batch_timeout_ms=30.0)),
                          ("port", MicroBatcher(engine, batch_timeout_ms=30.0))):
        res = [None] * 5

        def call(i, batcher=batcher, res=res):
            res[i] = batcher.submit(images[i], "what color is this", 3)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        batcher.shutdown()
        out[name] = res
    for got, want in zip(out["port"], out["jax"]):
        _assert_payloads_match(got, want)


MULTIPART_BINARY = b"\r\n\r\n--" + bytes(
    np.random.RandomState(0).randint(0, 256, size=5000, dtype=np.uint8)) + b"\r\n"


@pytest.mark.parametrize("ct", ["multipart/form-data; boundary=XbX123",
                                'multipart/form-data; boundary="XbX123"'])
def test_fast_multipart_matches_email_parser(ct):
    boundary = "XbX123"
    body = (
        f'--{boundary}\r\nContent-Disposition: form-data; name="question"'
        f"\r\n\r\nwhat is this\r\n".encode()
        + f'--{boundary}\r\nContent-Disposition: form-data; name="image"; '
        f'filename="a.jpg"\r\nContent-Type: image/jpeg\r\n\r\n'.encode()
        + MULTIPART_BINARY
        + f"\r\n--{boundary}\r\n".encode()
        + f'Content-Disposition: form-data; name="image"; filename="b.png"'
        f"\r\nContent-Type: image/png\r\n\r\n".encode()
        + b"PNGDATA"
        + f"\r\n--{boundary}--\r\n".encode()
    )
    from vqa_tpu.serving.server import parse_multipart as jax_parse

    fast = parse_multipart(ct, body)
    assert fast == _parse_multipart_email(f"multipart/form-data; boundary={boundary}", body)
    assert fast == jax_parse(ct, body)
    assert fast["question"] == [(None, b"what is this")]
    assert fast["image"] == [("a.jpg", MULTIPART_BINARY), ("b.png", b"PNGDATA")]
    assert parse_multipart("text/plain", b"x") == {}


def test_fast_multipart_parser_hardening():
    import base64

    body = (b"--B\r\n"
            b'Content-Disposition: form-data; filename="photo.jpg"; name="image"\r\n'
            b"Content-Type: image/jpeg\r\n\r\nJPEGDATA\r\n--B--\r\n")
    assert parse_multipart("multipart/form-data; boundary=B", body)["image"] == [
        ("photo.jpg", b"JPEGDATA")]
    big = b"X" * 8192
    body = (b"--B\r\n"
            b'Content-Disposition: form-data; name="image"; filename="a.jpg"\r\n'
            b"Content-Type: image/jpeg\r\n\r\n" + big + b"\r\n"
            b"--B\r\n"
            b'Content-Disposition: form-data; name="question"\r\n'
            b"Content-Transfer-Encoding: base64\r\n\r\n"
            + base64.b64encode(b"what is this") + b"\r\n--B--\r\n")
    fields = parse_multipart("multipart/form-data; boundary=B", body)
    assert fields["question"][0][1] == b"what is this"
    assert fields["image"][0] == ("a.jpg", big)


def test_parse_multipart_unquoted_and_case_variant_params():
    body = (b"--BOUND\r\n"
            b"Content-Disposition: form-data; Name=question\r\n\r\n"
            b"what is this\r\n"
            b"--BOUND\r\n"
            b"Content-Disposition: form-data; NAME=image; FileName=x.png\r\n"
            b"Content-Type: image/png\r\n\r\n"
            b"PNGDATA\r\n"
            b"--BOUND--\r\n")
    fields = parse_multipart('multipart/form-data; boundary="BOUND"', body)
    assert fields["question"][0] == (None, b"what is this")
    assert fields["image"][0] == ("x.png", b"PNGDATA")


def test_response_schemas_are_the_jax_schemas():
    from vqa_tpu.serving import schemas as jax_schemas
    from vqa_tpu_torch.serving import schemas

    good = {"question": "what is this",
            "answers": [{"answer": "cat", "probability": 0.9, "index": 3}],
            "top_answer": "cat", "confidence": 0.9, "success": True, "error": None}
    assert schemas.validate_prediction(good) is good
    bad = [{**good, "confidence": "high"}, {**good, "answers": [{"answer": "cat"}]},
           {**good, "answers": []}, {**good, "confidence": True},
           {**good, "answers": [{"answer": "x", "probability": 1.5, "index": 0}]}]
    for payload in bad:
        with pytest.raises(schemas.SchemaError):
            schemas.validate_prediction(payload)
        with pytest.raises(jax_schemas.SchemaError):
            jax_schemas.validate_prediction(payload)
    assert schemas.validate_health({"status": "healthy", "model_loaded": True})
    with pytest.raises(schemas.SchemaError):
        schemas.validate_health({"status": "healthy", "model_loaded": "yes"})
    with pytest.raises(schemas.SchemaError):
        schemas.validate_batch_prediction({"success": True, "predictions": [{}]})
    with pytest.raises(schemas.SchemaError):
        schemas.validate_attention({**good, "attention": {"tokens": ["a"], "spatial_size": 2,
                                                          "maps": [[[0.5]]]}})
    assert [n for n in dir(schemas) if n.startswith("validate")] == \
        [n for n in dir(jax_schemas) if n.startswith("validate")]


def test_predict_batch_request_cap(engines):
    _, engine = engines
    server = VQAServer(engine=engine, preload=False, config=InferenceConfig(max_request_batch=4))
    status, payload = server.handle_predict_batch(
        _batch_fields([_png_bytes()] * 5, ",".join(["what is this"] * 5)))
    server.batcher.shutdown()
    assert status == 400 and "exceeds the maximum" in payload["detail"]


def test_frontend_is_the_jax_frontend_byte_for_byte():
    for name in ("index.html", "script.js", "style.css"):
        with open(os.path.join(REPO, "vqa_tpu", "frontend", name), "rb") as f:
            want = f.read()
        with open(os.path.join(REPO, "vqa_tpu_torch", "frontend", name), "rb") as f:
            assert f.read() == want, name


# ---- over a real socket --------------------------------------------------


@pytest.fixture(scope="module")
def http_server(engines):
    _, engine = engines
    server = VQAServer(engine=engine, preload=True, config=InferenceConfig(batch_timeout_ms=2.0))
    t = threading.Thread(target=server.serve, args=("127.0.0.1", 0), daemon=True)
    t.start()
    for _ in range(200):
        if server._httpd is not None:
            break
        time.sleep(0.05)
    yield f"http://127.0.0.1:{server._httpd.server_address[1]}"
    server.shutdown()


def _post_multipart(url, fields, files):
    boundary = "XBOUNDARYX"
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"'
             f"\r\n\r\n{value}\r\n".encode() for name, value in fields.items()]
    parts += [f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; '
              f'filename="{fname}"\r\nContent-Type: image/png\r\n\r\n'.encode() + data + b"\r\n"
              for name, (fname, data) in files.items()]
    req = urllib.request.Request(
        url, data=b"".join(parts) + f"--{boundary}--\r\n".encode(),
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_http_health_info_index_and_404(http_server):
    with urllib.request.urlopen(http_server + "/health", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "healthy", "model_loaded": False}
    with urllib.request.urlopen(http_server + "/model-info", timeout=30) as r:
        info = json.loads(r.read())
    assert info["num_answers"] == 8 and info["device"] == "cpu"
    with urllib.request.urlopen(http_server + "/", timeout=30) as r:
        assert json.loads(r.read())["name"] == "VQA API"
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(http_server + "/nope", timeout=30)
    assert e.value.code == 404


def test_http_predict_validation_and_batch(http_server):
    status, j = _post_multipart(http_server + "/predict",
                                {"question": "what color is this", "top_k": "3"},
                                {"image": ("test.png", _png_bytes())})
    assert status == 200 and j["success"] is True and len(j["answers"]) == 3
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_multipart(http_server + "/predict", {"question": "what"},
                        {"image": ("t.png", _png_bytes())})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_multipart(http_server + "/predict-batch",
                        {"questions": "what is this, what color is that"},
                        {"images": ("a.png", _png_bytes())})
    assert e.value.code == 400
    status, j = _post_multipart(http_server + "/predict-batch", {"questions": "what is this"},
                                {"images": ("a.png", _png_bytes())})
    assert status == 200 and j["success"] and len(j["predictions"]) == 1


def test_http_predict_batch_empty_is_400(http_server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_multipart(http_server + "/predict-batch", {"questions": ""}, {})
    assert e.value.code == 400


def test_http_frontend_and_static_no_traversal(http_server):
    with urllib.request.urlopen(http_server + "/app", timeout=30) as r:
        assert "Visual Question Answering" in r.read().decode()
    with urllib.request.urlopen(http_server + "/app/script.js", timeout=30) as r:
        assert "predict" in r.read().decode()
    for path in ("/app/../PARITY.md", "/app/..%2fPARITY.md", "/app/../../etc/hostname",
                 "/app/../serving/server.py"):
        try:
            with urllib.request.urlopen(http_server + path, timeout=30) as r:
                assert r.status == 404
        except urllib.error.HTTPError as e:
            assert e.code == 404


def test_http_metrics_prometheus_format(http_server):
    _post_multipart(http_server + "/predict", {"question": "what color is this"},
                    {"image": ("t.png", _png_bytes())})
    with urllib.request.urlopen(http_server + "/metrics?format=prometheus", timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    assert "# TYPE vqa_requests_total counter" in text
    assert 'vqa_request_latency_ms{quantile="0.5"}' in text
    with urllib.request.urlopen(http_server + "/metrics", timeout=30) as r:
        j = json.loads(r.read())
    assert j["count"] >= 1 and "p50_ms" in j


def test_http_attention_endpoint(http_server):
    status, j = _post_multipart(http_server + "/attention", {"question": "what color is this"},
                                {"image": ("t.png", _png_bytes())})
    assert status == 200 and j["success"] is True, j.get("error")
    att = j["attention"]
    assert att["tokens"] and len(att["maps"]) == len(att["tokens"])
    m0 = np.asarray(att["maps"][0])
    assert m0.shape == (att["spatial_size"],) * 2
    np.testing.assert_allclose(m0.sum(), 1.0, atol=1e-3)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_multipart(http_server + "/attention", {"question": "hi"},
                        {"image": ("t.png", _png_bytes())})
    assert e.value.code == 400


def test_http_oversized_body_rejected_413(http_server):
    req = urllib.request.Request(
        http_server + "/predict", data=b"x" * 1024,
        headers={"Content-Type": "multipart/form-data; boundary=B",
                 "Content-Length": str(300 * 1024 * 1024)})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 413


def test_drain_answers_requests_in_flight(engines):
    """drain() closes the listener, lets requests already in flight finish,
    then stops the batcher."""
    _, engine = engines
    server = VQAServer(engine=engine, preload=False, config=InferenceConfig(batch_timeout_ms=2.0))
    t = threading.Thread(target=server.serve, args=("127.0.0.1", 0), daemon=True)
    t.start()
    while server._httpd is None:
        time.sleep(0.01)
    url = f"http://127.0.0.1:{server._httpd.server_address[1]}"
    release = threading.Event()
    decode = engine._preprocess_images
    results = [None] * 3

    def held(images):
        release.wait(30)
        return decode(images)

    def call(i):
        results[i] = _post_multipart(url + "/predict", {"question": "what is this"},
                                     {"image": ("a.png", _png_bytes())})

    engine._preprocess_images = held
    try:
        clients = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for c in clients:
            c.start()
        deadline = time.monotonic() + 30
        while server._inflight < 3 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert server._inflight == 3
        drainer = threading.Thread(target=server.drain, kwargs={"timeout": 30})
        drainer.start()
        time.sleep(0.2)
        release.set()
        drainer.join(timeout=60)
        for c in clients:
            c.join(timeout=60)
    finally:
        del engine._preprocess_images
    assert not drainer.is_alive()
    assert all(r is not None and r[0] == 200 and r[1]["success"] for r in results)
    t.join(timeout=10)
    assert not t.is_alive()


# ---- the CLI -------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_cli_refuses_to_start_without_a_gpu():
    """Without ``--device cpu`` the server wants the card: with none it
    exits non-zero with the no-GPU message before binding its port."""
    port = _free_port()
    proc = subprocess.run(
        [sys.executable, "-m", "vqa_tpu_torch.serving.server", "--tiny", "--host",
         "127.0.0.1", "--port", str(port)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert "[API] serving on" not in proc.stdout
    with socket.socket() as s:  # nothing was left listening on the port
        assert s.connect_ex(("127.0.0.1", port)) != 0


def test_server_cli_stops_on_an_orbax_checkpoint(tmp_path):
    """An Orbax ``best_model`` directory the port cannot load (here: without
    its sidecar) stops the server, naming what is missing; it does not
    serve a random model instead. One with its sidecar loads
    (``tests/test_torch_orbax.py``)."""
    (tmp_path / "best_model").mkdir()
    proc = subprocess.run(
        [sys.executable, "-m", "vqa_tpu_torch.serving.server", "--tiny", "--device", "cpu",
         "--host", "127.0.0.1", "--port", "0", "--checkpoint-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "FileNotFoundError" in proc.stderr and "best_model.meta.json" in proc.stderr
    assert "[API] serving on" not in proc.stdout
    assert "randomly initialized" not in proc.stdout
