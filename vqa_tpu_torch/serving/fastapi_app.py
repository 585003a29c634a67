"""ASGI serving surface of the port — same contract as serving/server.py.

Counterpart of ``vqa_tpu/serving/fastapi_app.py``. Two layers:

- :func:`create_asgi_app` — a dependency-free ASGI 3.0 application
  implementing the full endpoint surface (routing, CORS, the
  Content-Length / streamed-body 413 cap, multipart parsing) on top of
  ``VQAServer``'s transport-independent handlers. Runs under any ASGI
  server (uvicorn, hypercorn, daphne) with no extra dependencies, and is
  driven through the raw ASGI protocol in tests/test_torch_asgi.py —
  hand-built ``scope``/``receive``/``send``, no test client library.
- :func:`create_app` — the optional FastAPI wrapper (OpenAPI docs,
  form parsing) for deployments that ship fastapi. Import-gated: it
  raises ``ImportError`` where fastapi is not installed.
"""

from __future__ import annotations

import json
from typing import List, Optional
from urllib.parse import parse_qs

try:
    from fastapi import FastAPI, File, Form, Request, UploadFile
    from fastapi.middleware.cors import CORSMiddleware

    HAS_FASTAPI = True
except ImportError:  # pragma: no cover - optional dependency
    HAS_FASTAPI = False

_CORS_HEADERS = [
    (b"access-control-allow-origin", b"*"),
    (b"access-control-allow-methods", b"*"),
    (b"access-control-allow-headers", b"*"),
]


class ASGIApp:
    """Pure-ASGI application over a ``VQAServer``'s shared handlers.

    The routing shim the stdlib server implements with
    ``BaseHTTPRequestHandler`` (serving/server.py do_GET/do_POST),
    re-expressed in the ASGI 3.0 protocol: same endpoints, same status
    codes, same ``{"detail": ...}`` error shapes, same 413 semantics
    (reject on the declared Content-Length BEFORE consuming the body;
    cap streamed/chunked bodies during accumulation as the backstop).
    """

    def __init__(self, server):
        self.server = server

    # -- responses ----------------------------------------------------
    async def _respond(self, send, status: int, payload,
                       content_type: bytes = b"application/json"):
        if isinstance(payload, bytes):
            body = payload
        elif isinstance(payload, str):
            body = payload.encode()
        else:
            body = json.dumps(payload).encode()
        await send({
            "type": "http.response.start",
            "status": status,
            "headers": [
                (b"content-type", content_type),
                (b"content-length", str(len(body)).encode()),
                *_CORS_HEADERS,
            ],
        })
        await send({"type": "http.response.body", "body": body})

    async def _read_body(self, receive, cap: int) -> Optional[bytes]:
        """Accumulate http.request messages; None once the total passes
        ``cap`` (the chunked-transfer backstop — no more reads happen)."""
        chunks = []
        total = 0
        while True:
            msg = await receive()
            if msg["type"] == "http.disconnect":
                return None
            chunk = msg.get("body", b"")
            total += len(chunk)
            if total > cap:
                return None
            chunks.append(chunk)
            if not msg.get("more_body", False):
                return b"".join(chunks)

    # -- protocol entry -----------------------------------------------
    async def __call__(self, scope, receive, send):
        if scope["type"] == "lifespan":
            # acknowledge startup/shutdown so ASGI servers don't hang
            while True:
                msg = await receive()
                if msg["type"] == "lifespan.startup":
                    await send({"type": "lifespan.startup.complete"})
                elif msg["type"] == "lifespan.shutdown":
                    await send({"type": "lifespan.shutdown.complete"})
                    return
        if scope["type"] != "http":
            return

        server = self.server
        method = scope["method"]
        path = scope["path"]
        headers = {
            k.decode("latin-1").lower(): v.decode("latin-1")
            for k, v in scope.get("headers", [])
        }

        if method == "OPTIONS":
            return await self._respond(send, 204, b"", b"text/plain")

        if method == "GET":
            query = parse_qs(scope.get("query_string", b"").decode("latin-1"))
            if path == "/metrics" and query.get("format", [""])[0] == "prometheus":
                return await self._respond(
                    send, 200, server.prometheus_metrics(),
                    b"text/plain; version=0.0.4",
                )
            status, payload = server.handle_get(path)
            return await self._respond(send, status, payload)

        if method != "POST":
            return await self._respond(
                send, 405, {"detail": "Method Not Allowed"})

        cap = server.cfg.max_body_mb * 1024 * 1024
        too_large = {
            "detail": f"request body exceeds {server.cfg.max_body_mb} MB"
        }
        cl = headers.get("content-length")
        if cl is not None:
            try:
                if int(cl) > cap:
                    # body never consumed — the ASGI server drains/resets
                    return await self._respond(send, 413, too_large)
            except ValueError:
                pass  # malformed header; the accumulation cap still applies
        body = await self._read_body(receive, cap)
        if body is None:
            return await self._respond(send, 413, too_large)

        ctype = headers.get("content-type", "")
        if "multipart/form-data" not in ctype:
            return await self._respond(
                send, 400, {"detail": "multipart/form-data required"})

        from vqa_tpu_torch.serving.server import parse_multipart

        fields = parse_multipart(ctype, body)
        if path == "/predict":
            status, payload = server.handle_predict(fields)
        elif path == "/predict-batch":
            status, payload = server.handle_predict_batch(fields)
        elif path == "/attention":
            status, payload = server.handle_attention(fields)
        else:
            status, payload = 404, {"detail": "Not Found"}
        return await self._respond(send, status, payload)


def create_asgi_app(
    checkpoint_dir: Optional[str] = None,
    server=None,
    config=None,
) -> ASGIApp:
    """Dependency-free ASGI app (see :class:`ASGIApp`).

    ``server`` lets callers/tests inject a prebuilt ``VQAServer`` (e.g.
    with a tiny engine); otherwise one is constructed from
    ``checkpoint_dir``/``config`` exactly like the stdlib CLI does.
    """
    if server is None:
        from vqa_tpu_torch.serving.server import VQAServer

        server = VQAServer(checkpoint_dir=checkpoint_dir, config=config)
    return ASGIApp(server)


def create_app(checkpoint_dir: Optional[str] = None):
    """FastAPI wrapper over the same handlers (optional dependency)."""
    if not HAS_FASTAPI:
        raise ImportError(
            "fastapi is not installed; use create_asgi_app() (dependency-"
            "free ASGI) or vqa_tpu_torch.serving.server (stdlib HTTP) — both "
            "expose the same endpoints"
        )
    from fastapi.responses import JSONResponse

    from vqa_tpu_torch.serving.server import VQAServer

    server = VQAServer(checkpoint_dir=checkpoint_dir)

    def respond(status_payload):
        # preserve the handlers' HTTP status (400 validation, 500 failure)
        status, payload = status_payload
        return JSONResponse(payload, status_code=status)
    app = FastAPI(title="VQA API", version="1.0.0")
    app.add_middleware(
        CORSMiddleware,
        allow_origins=["*"],
        allow_credentials=True,
        allow_methods=["*"],
        allow_headers=["*"],
    )

    @app.get("/")
    async def root():
        return server.handle_get("/")[1]

    @app.get("/health")
    async def health():
        return server.handle_get("/health")[1]

    @app.get("/model-info")
    async def model_info():
        return server.handle_get("/model-info")[1]

    @app.get("/metrics")
    async def metrics():
        return server.handle_get("/metrics")[1]

    def _too_large():
        from fastapi import HTTPException

        raise HTTPException(
            status_code=413,
            detail=f"request body exceeds {server.cfg.max_body_mb} MB",
        )

    def _cap_bytes() -> int:
        return server.cfg.max_body_mb * 1024 * 1024

    @app.middleware("http")
    async def _content_length_cap(request: "Request", call_next):
        # reject on the declared Content-Length BEFORE the body is consumed,
        # like the stdlib server — FastAPI resolves File()/Form() deps by
        # parsing the ENTIRE multipart body before an endpoint function
        # runs, so this check must live in middleware (which runs first),
        # not in the endpoint. The cap is a memory backstop; firing it
        # after buffering would defeat it.
        cl = request.headers.get("content-length")
        if cl is not None:
            try:
                if int(cl) > _cap_bytes():
                    # same 413 shape as _too_large() and the stdlib
                    # server (serving/server.py do_POST): {"detail": ...}
                    return JSONResponse(
                        {
                            "detail": "request body exceeds "
                                      f"{server.cfg.max_body_mb} MB",
                        },
                        status_code=413,
                    )
            except ValueError:
                pass  # malformed header; post-read _cap still applies
        return await call_next(request)

    def _cap(data: bytes, already: int = 0):
        # post-read backstop for chunked bodies (no Content-Length);
        # `already` makes the cap cover the SUM across a multi-file request
        if already + len(data) > _cap_bytes():
            _too_large()
        return data

    @app.post("/predict")
    async def predict(
        image: UploadFile = File(...),
        question: str = Form(...),
        top_k: int = Form(5),
    ):
        data = _cap(await image.read())
        fields = {
            "image": [(image.filename, data)],
            "question": [(None, question.encode())],
            "top_k": [(None, str(top_k).encode())],
        }
        return respond(server.handle_predict(fields))

    @app.post("/attention")
    async def attention(
        image: UploadFile = File(...),
        question: str = Form(...),
        top_k: int = Form(5),
    ):
        data = _cap(await image.read())
        fields = {
            "image": [(image.filename, data)],
            "question": [(None, question.encode())],
            "top_k": [(None, str(top_k).encode())],
        }
        return respond(server.handle_attention(fields))

    @app.post("/predict-batch")
    async def predict_batch(
        images: List[UploadFile] = File(...),
        questions: str = Form(...),
    ):
        blobs = []
        total = 0
        for im in images:
            data = _cap(await im.read(), already=total)
            total += len(data)
            blobs.append((im.filename, data))
        fields = {
            "images": blobs,
            "questions": [(None, questions.encode())],
        }
        return respond(server.handle_predict_batch(fields))

    return app
