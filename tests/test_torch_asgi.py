"""The port's ASGI app driven through the raw ASGI 3.0 protocol, as
``tests/test_asgi.py`` drives the JAX package's: hand-built
``scope``/``receive``/``send`` messages, no test-client library. Each
exchange is also sent to the JAX app on an engine with the same weights:
the status codes, headers and error bodies are the same."""

import asyncio
import io
import json

import pytest
from PIL import Image

from vqa_tpu.serving.engine import VQAInference as JaxInference
from vqa_tpu.serving.fastapi_app import create_asgi_app as jax_create_asgi_app
from vqa_tpu.serving.server import VQAServer as JaxServer
from vqa_tpu.utils.config import InferenceConfig as JaxInferenceConfig
from vqa_tpu.utils.config import ModelConfig as JaxModelConfig
from vqa_tpu.utils.config import model_config_dict
from vqa_tpu_torch.compat.jax_weights import state_dict_from_jax
from vqa_tpu_torch.serving.engine import VQAInference
from vqa_tpu_torch.serving.fastapi_app import HAS_FASTAPI, create_app, create_asgi_app
from vqa_tpu_torch.serving.server import VQAServer
from vqa_tpu_torch.utils.config import InferenceConfig, model_config_from_dict
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(vocab_size=50, embed_dim=16, num_answers=8, num_transformer_layers=1,
            num_attention_heads=2, ffn_hidden_dim=32, max_question_length=6,
            image_size=32, base_channels=8, stage_channels=(8, 16, 32, 64),
            feature_spatial_size=1)
BOUNDARY = "XASGIBOUNDARYX"


def _png_bytes(size=40, color=(30, 180, 30)):
    buf = io.BytesIO()
    Image.new("RGB", (size, size), color).save(buf, "PNG")
    return buf.getvalue()


def _multipart_body(fields, files):
    parts = [f'--{BOUNDARY}\r\nContent-Disposition: form-data; name="{name}"'
             f"\r\n\r\n{value}\r\n".encode() for name, value in fields.items()]
    parts += [f'--{BOUNDARY}\r\nContent-Disposition: form-data; name="{name}";'
              f' filename="{filename}"\r\nContent-Type: image/png\r\n\r\n'.encode()
              + data + b"\r\n" for name, (filename, data) in files.items()]
    parts.append(f"--{BOUNDARY}--\r\n".encode())
    return b"".join(parts)


def _call(app, method, path, headers=(), body_messages=(), query=b""):
    """Drive the app with a raw ASGI http scope → (status, headers, body)."""
    scope = {
        "type": "http", "asgi": {"version": "3.0"}, "http_version": "1.1",
        "method": method, "path": path, "raw_path": path.encode(),
        "query_string": query,
        "headers": [(k.lower().encode(), v.encode()) for k, v in headers],
        "client": ("127.0.0.1", 50000), "server": ("127.0.0.1", 8000),
    }
    incoming = list(body_messages) or [{"type": "http.request", "body": b"", "more_body": False}]
    sent = []

    async def receive():
        return incoming.pop(0)

    async def send(message):
        sent.append(message)

    asyncio.run(app(scope, receive, send))
    start = next(m for m in sent if m["type"] == "http.response.start")
    body = b"".join(m.get("body", b"") for m in sent if m["type"] == "http.response.body")
    return start["status"], {k.decode(): v.decode() for k, v in start["headers"]}, body


def _post(app, path, body, content_type=None, content_length=True, chunk=None):
    headers = [("content-type", content_type or f"multipart/form-data; boundary={BOUNDARY}")]
    if content_length:
        headers.append(("content-length", str(len(body))))
    if chunk:
        msgs = [{"type": "http.request", "body": body[i:i + chunk],
                 "more_body": i + chunk < len(body)} for i in range(0, len(body), chunk)]
    else:
        msgs = [{"type": "http.request", "body": body, "more_body": False}]
    return _call(app, "POST", path, headers=headers, body_messages=msgs)


@pytest.fixture(scope="module")
def apps():
    jcfg = JaxModelConfig(**TINY)
    jax_engine = JaxInference(model_config=jcfg,
                              config=JaxInferenceConfig(batch_buckets=(1, 4))).load()
    cfg = model_config_from_dict(model_config_dict(jcfg))
    engine = VQAInference(model_config=cfg, config=InferenceConfig(batch_buckets=(1, 4)),
                          device="cpu").load()
    engine.model.load_state_dict(state_dict_from_jax(jax_engine.variables, cfg), strict=True)
    server = VQAServer(engine=engine, preload=True, config=InferenceConfig(max_body_mb=1))
    jax_server = JaxServer(engine=jax_engine, preload=False,
                           config=JaxInferenceConfig(max_body_mb=1))
    yield create_asgi_app(server=server), jax_create_asgi_app(server=jax_server)
    server.batcher.shutdown()
    jax_server.batcher.shutdown()


@pytest.fixture(scope="module")
def app(apps):
    return apps[0]


def test_get_health_and_root(app):
    status, hdrs, body = _call(app, "GET", "/health")
    assert status == 200
    assert hdrs["content-type"] == "application/json"
    assert hdrs["access-control-allow-origin"] == "*"
    assert json.loads(body)["status"] == "healthy"
    assert _call(app, "GET", "/")[0] == 200
    info = json.loads(_call(app, "GET", "/model-info")[2])
    assert info["num_answers"] == 8 and info["device"] == "cpu"


def test_predict_roundtrip_through_asgi(apps):
    app, jax_app = apps
    body = _multipart_body({"question": "what color is this", "top_k": "3"},
                           {"image": ("green.png", _png_bytes())})
    status, _, out = _post(app, "/predict", body)
    assert status == 200
    payload = json.loads(out)
    assert payload["success"] is True and len(payload["answers"]) == 3
    assert payload["top_answer"] == payload["answers"][0]["answer"]
    assert payload["confidence"] == payload["answers"][0]["probability"]
    want = json.loads(_post(jax_app, "/predict", body)[2])
    assert [a["index"] for a in payload["answers"]] == [a["index"] for a in want["answers"]]
    assert abs(payload["confidence"] - want["confidence"]) <= 1e-4


def test_predict_body_split_across_messages(app):
    body = _multipart_body({"question": "what is shown", "top_k": "2"},
                           {"image": ("g.png", _png_bytes())})
    status, _, out = _post(app, "/predict", body, chunk=97)
    assert status == 200 and json.loads(out)["success"] is True


def test_predict_batch_through_asgi(app):
    body = _multipart_body({"questions": json.dumps(["what color", "what shape"])},
                           {"images": ("a.png", _png_bytes())})
    status, _, _ = _post(app, "/predict-batch", body)
    assert status in (200, 400)
    body2 = _multipart_body({"questions": json.dumps(["what color"])},
                            {"images": ("a.png", _png_bytes())})
    status2, _, out2 = _post(app, "/predict-batch", body2)
    payload2 = json.loads(out2)
    assert status2 == 200 and payload2["success"] is True
    assert len(payload2["predictions"]) == 1 and payload2["predictions"][0]["answers"]


def test_attention_through_asgi(app):
    body = _multipart_body({"question": "what color is this", "top_k": "2"},
                           {"image": ("g.png", _png_bytes())})
    status, _, out = _post(app, "/attention", body)
    payload = json.loads(out)
    assert status == 200 and payload["success"] is True and "attention" in payload


def test_413_on_declared_content_length(app):
    """Rejected before any body message is consumed."""
    consumed, sent = [], []

    async def receive():
        consumed.append(1)
        return {"type": "http.request", "body": b"x", "more_body": True}

    async def send(message):
        sent.append(message)

    scope = {"type": "http", "method": "POST", "path": "/predict", "query_string": b"",
             "headers": [(b"content-type", f"multipart/form-data; boundary={BOUNDARY}".encode()),
                         (b"content-length", str(2 * 1024 * 1024).encode())]}
    asyncio.run(app(scope, receive, send))
    start = next(m for m in sent if m["type"] == "http.response.start")
    assert start["status"] == 413 and consumed == []
    body = b"".join(m.get("body", b"") for m in sent if m["type"] == "http.response.body")
    assert "exceeds 1 MB" in json.loads(body)["detail"]


def test_413_on_chunked_body_without_content_length(app):
    big = b"x" * (1024 * 1024 + 4096)
    status, _, out = _post(app, "/predict", big, content_length=False, chunk=256 * 1024)
    assert status == 413 and "exceeds 1 MB" in json.loads(out)["detail"]


@pytest.mark.parametrize("case", ["non_multipart", "get_404", "post_404", "delete_405",
                                  "options", "one_word_question", "missing_image"])
def test_status_and_error_bodies_match_jax(apps, case):
    body = _multipart_body({"question": "x"}, {})
    exchanges = {
        "non_multipart": lambda a: _post(a, "/predict", b'{"q": 1}',
                                         content_type="application/json"),
        "get_404": lambda a: _call(a, "GET", "/nope"),
        "post_404": lambda a: _post(a, "/nope", body),
        "delete_405": lambda a: _call(a, "DELETE", "/predict"),
        "options": lambda a: _call(a, "OPTIONS", "/predict"),
        "one_word_question": lambda a: _post(a, "/predict", _multipart_body(
            {"question": "what"}, {"image": ("g.png", _png_bytes())})),
        "missing_image": lambda a: _post(a, "/attention", _multipart_body(
            {"question": "what is this"}, {})),
    }
    app, jax_app = apps
    assert exchanges[case](app) == exchanges[case](jax_app)


def test_metrics_prometheus_format(app):
    status, hdrs, body = _call(app, "GET", "/metrics", query=b"format=prometheus")
    assert status == 200 and hdrs["content-type"].startswith("text/plain")
    assert b"vqa_requests_total" in body
    status, hdrs, _ = _call(app, "GET", "/metrics")
    assert status == 200 and hdrs["content-type"] == "application/json"


def test_lifespan_protocol(app):
    incoming = [{"type": "lifespan.startup"}, {"type": "lifespan.shutdown"}]
    sent = []

    async def receive():
        return incoming.pop(0)

    async def send(message):
        sent.append(message)

    asyncio.run(app({"type": "lifespan"}, receive, send))
    assert sent == [{"type": "lifespan.startup.complete"},
                    {"type": "lifespan.shutdown.complete"}]


def test_create_app_needs_fastapi():
    if HAS_FASTAPI:
        pytest.skip("fastapi is installed; the import gate is not exercised")
    with pytest.raises(ImportError, match="fastapi is not installed"):
        create_app()
