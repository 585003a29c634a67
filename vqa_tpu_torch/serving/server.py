"""HTTP serving layer of the port — the JAX server's contract, on the card.

Counterpart of ``vqa_tpu/serving/server.py``, with the same endpoints,
status codes, payloads and ``{"detail": ...}`` error shapes:

    GET  /              index JSON
    GET  /health        {"status", "model_loaded"}
    GET  /model-info    {"device", "vocab_size", "num_answers", "total_parameters", ...}
    GET  /metrics       serving latency counters (?format=prometheus for text)
    POST /predict       multipart image+question+top_k → PredictionResponse
    POST /predict-batch N images + comma-separated questions
    POST /attention     prediction + cross-attention heatmaps
    GET  /app           the web frontend (``vqa_tpu_torch/frontend/``)

Exceptions become ``success:false`` payloads, not 500s; CORS is permissive.
Built on the stdlib ``ThreadingHTTPServer``; ``vqa_tpu_torch.serving.
fastapi_app`` serves the same handlers over ASGI. Concurrent ``/predict``
requests funnel through the ``MicroBatcher``, so the card sees one
bucket-padded forward per group; ``/attention`` and ``/predict-batch`` call
the engine from their handler threads.

    python -m vqa_tpu_torch.serving.server --port 8000             # on the card
    python -m vqa_tpu_torch.serving.server --tiny --device cpu     # on the CPU
"""

from __future__ import annotations

import json
import mimetypes
import os
import re
import threading
import time
from email.parser import BytesParser
from email.policy import HTTP
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs

from vqa_tpu_torch.data.preprocess import validate_question
from vqa_tpu_torch.serving import schemas
from vqa_tpu_torch.serving.batcher import MicroBatcher
from vqa_tpu_torch.serving.engine import VQAInference
from vqa_tpu_torch.utils.config import InferenceConfig

# the frontend ships inside the package, so installed copies serve /app too
_FRONTEND_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "frontend",
)

INDEX_PAYLOAD = {
    "name": "VQA API",
    "version": "1.0.0",
    "description": "TPU-native Visual Question Answering System",
    "endpoints": {
        "predict": "POST /predict - Submit image and question",
        "predict-batch": "POST /predict-batch - Batched submission",
        "health": "GET /health - Health check",
        "model-info": "GET /model-info - Model information",
        "metrics": "GET /metrics - Serving latency stats",
        "attention": "POST /attention - Prediction + cross-attention heatmaps",
        "app": "GET /app - Web frontend",
    },
}


_BOUNDARY_RE = re.compile(r'boundary="?([^";]+)"?', re.I)
# anchored so name= inside filename="..." can never match first; accepts
# quoted strings and bare RFC 2045 tokens, case-insensitive (clients may
# send `name=question` or `Name="question"` — the stdlib fallback parser
# accepts both, so the fast path must too)
_NAME_RE = re.compile(rb'(?:^|[;\s])name=(?:"([^"]*)"|([^";\s]+))', re.I)
_FILENAME_RE = re.compile(rb'(?:^|[;\s])filename=(?:"([^"]*)"|([^";\s]+))', re.I)
_CTE_RE = re.compile(rb"content-transfer-encoding", re.I)


def _param(m) -> bytes:
    """Quoted or bare value from a _NAME_RE/_FILENAME_RE match."""
    return m.group(1) if m.group(1) is not None else m.group(2)


def _parse_multipart_email(content_type: str, body: bytes):
    """Reference implementation via the stdlib email parser: correct but
    slow; the fallback for encodings the fast path does not handle."""
    msg = BytesParser(policy=HTTP).parsebytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body
    )
    fields: Dict[str, List[Tuple[Optional[str], bytes]]] = {}
    if not msg.is_multipart():
        return fields
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name is None:
            continue
        filename = part.get_filename()
        payload = part.get_payload(decode=True) or b""
        fields.setdefault(name, []).append((filename, payload))
    return fields


def parse_multipart(content_type: str, body: bytes) -> Dict[str, List[Tuple[Optional[str], bytes]]]:
    """Parse multipart/form-data → {field: [(filename|None, value_bytes)]}.

    Fast path: a direct boundary split (it runs per request on the serving
    host). Falls back to the email parser for content-transfer-encoded
    parts (browsers never send those for multipart/form-data) or any
    structural surprise."""
    m = _BOUNDARY_RE.search(content_type or "")
    if not m:
        return {}
    if _CTE_RE.search(body):  # encoded parts → the decoding email parser
        return _parse_multipart_email(content_type, body)
    try:
        delim = b"--" + m.group(1).encode()
        fields: Dict[str, List[Tuple[Optional[str], bytes]]] = {}
        for part in body.split(delim)[1:]:
            if part.startswith(b"--"):  # closing delimiter
                break
            if part.startswith(b"\r\n"):
                part = part[2:]
            head, sep, payload = part.partition(b"\r\n\r\n")
            if not sep:
                continue
            if payload.endswith(b"\r\n"):
                payload = payload[:-2]
            name = _NAME_RE.search(head)
            if name is None:
                continue
            filename = _FILENAME_RE.search(head)
            fields.setdefault(_param(name).decode("utf-8", "replace"), []).append(
                (
                    _param(filename).decode("utf-8", "replace")
                    if filename
                    else None,
                    payload,
                )
            )
        return fields
    except Exception:
        return _parse_multipart_email(content_type, body)


class VQAServer:
    """Owns the engine + micro-batcher and the HTTP server instance."""

    def __init__(
        self,
        checkpoint_dir: Optional[str] = None,
        config: Optional[InferenceConfig] = None,
        engine: Optional[VQAInference] = None,
        preload: bool = True,
    ):
        self.cfg = config or InferenceConfig()
        self.engine = engine or VQAInference(
            checkpoint_dir=checkpoint_dir, config=self.cfg
        )
        if preload:  # load and run every bucket once before serving
            self.engine.warmup()
        self.batcher = MicroBatcher(
            self.engine,
            max_batch_size=self.cfg.max_batch_size,
            batch_timeout_ms=self.cfg.batch_timeout_ms,
        )
        self._httpd: Optional[ThreadingHTTPServer] = None
        # in-flight request accounting for graceful drain (worker recycle
        # under vqa_tpu_torch.serving.supervisor)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._draining = False

    # ------------------------------------------------------------------
    # request handling (transport-independent, reused by the ASGI adapter)
    # ------------------------------------------------------------------
    def handle_get(self, path: str) -> Tuple[int, Any]:
        if path == "/" or path == "":
            return 200, schemas.validate_index(INDEX_PAYLOAD)
        if path == "/health":
            return 200, schemas.validate_health({
                "status": "healthy",
                "model_loaded": self.engine.model_loaded_from_checkpoint,
            })
        if path == "/model-info":
            info = self.engine.get_model_info()
            return 200, schemas.validate_model_info({
                "device": info["backend"],
                "vocab_size": info["vocab_size"],
                "num_answers": info["num_answers"],
                "total_parameters": info["parameters"]["total"],
                **info,
            })
        if path == "/metrics":
            return 200, self.batcher.latency_stats()
        return 404, {"detail": "Not Found"}

    def prometheus_metrics(self) -> str:
        """The same serving counters in Prometheus text exposition format
        (``GET /metrics?format=prometheus``)."""
        s = self.batcher.latency_stats()
        lines = [
            "# HELP vqa_requests_total Requests served through the batcher.",
            "# TYPE vqa_requests_total counter",
            f"vqa_requests_total {s.get('total_requests', 0)}",
            "# HELP vqa_batches_total Device forwards dispatched.",
            "# TYPE vqa_batches_total counter",
            f"vqa_batches_total {s.get('batches', 0)}",
        ]
        if s.get("count", 0):
            # quantiles come from the batcher's sliding window (standard for
            # summaries); _sum/_count are monotonic cumulative totals
            lines += [
                "# HELP vqa_request_latency_ms End-to-end request latency.",
                "# TYPE vqa_request_latency_ms summary",
                f'vqa_request_latency_ms{{quantile="0.5"}} {s["p50_ms"]:.3f}',
                f'vqa_request_latency_ms{{quantile="0.99"}} {s["p99_ms"]:.3f}',
                f"vqa_request_latency_ms_sum {s['total_latency_ms']:.3f}",
                f"vqa_request_latency_ms_count {s['total_requests']}",
            ]
        return "\n".join(lines) + "\n"

    @staticmethod
    def _parse_predict_fields(fields):
        """Shared /predict + /attention field validation → either
        ``(None, (image_bytes, question, top_k))`` or ``((status, payload),
        None)`` for a 400."""
        images = fields.get("image", [])
        if not images:
            return (400, {"detail": "image file is required"}), None
        filename, image_bytes = images[0]
        qs = fields.get("question", [])
        question = qs[0][1].decode("utf-8", "replace").strip() if qs else ""
        ok, err = validate_question(question, min_words=2)
        if not ok:
            return (400, {"detail": err}), None
        if filename and not _looks_like_image(filename, image_bytes):
            return (400, {"detail": "File must be an image"}), None
        top_k = int(fields.get("top_k", [(None, b"5")])[0][1] or 5)
        return None, (image_bytes, question, top_k)

    def handle_attention(self, fields) -> Tuple[int, Any]:
        """POST /attention — prediction + cross-attention heatmaps. A
        diagnostics path: runs on the engine directly, not the batcher."""
        question = ""
        try:
            error, parsed = self._parse_predict_fields(fields)
            if error is not None:
                return error
            image_bytes, question, top_k = parsed

            result = self.engine.attention_map(image_bytes, question, top_k)
            return 200, schemas.validate_attention(
                {**result, "success": True, "error": None}
            )
        except Exception as e:  # success:false payload, not a 500
            return 200, {
                "question": question,
                "top_answer": "",
                "confidence": 0.0,
                "answers": [],
                "attention": {"tokens": [], "spatial_size": 0, "maps": []},
                "success": False,
                "error": str(e),
            }

    def handle_predict(self, fields) -> Tuple[int, Any]:
        """POST /predict, through the micro-batcher."""
        question = ""
        try:
            error, parsed = self._parse_predict_fields(fields)
            if error is not None:
                return error
            image_bytes, question, top_k = parsed

            result = self.batcher.submit(image_bytes, question, top_k)
            return 200, schemas.validate_prediction(
                {**result, "success": True, "error": None}
            )
        except Exception as e:  # success:false payload, not a 500
            return 200, {
                "question": question,
                "top_answer": "",
                "confidence": 0.0,
                "answers": [],
                "success": False,
                "error": str(e),
            }

    def handle_predict_batch(self, fields) -> Tuple[int, Any]:
        """POST /predict-batch, on the engine (chunked into buckets)."""
        try:
            images = fields.get("images", []) or fields.get("image", [])
            qs_raw = fields.get("questions", [])
            questions = (
                [q.strip() for q in qs_raw[0][1].decode("utf-8", "replace").split(",")]
                if qs_raw
                else []
            )
            if not images:
                return 400, {"detail": "At least one image is required"}
            if len(images) > self.cfg.max_request_batch:
                # bound per-request work; the engine chunks anything that
                # does get through into buckets
                return 400, {
                    "detail": f"Batch of {len(images)} exceeds the maximum "
                    f"of {self.cfg.max_request_batch} images per request"
                }
            if len(images) != len(questions):
                return 400, {
                    "detail": f"Number of images ({len(images)}) must match "
                    f"number of questions ({len(questions)})"
                }
            results = self.engine.predict_batch(
                [b for _, b in images], questions
            )
            return 200, schemas.validate_batch_prediction(
                {"success": True, "predictions": results}
            )
        except Exception as e:
            return 500, {"detail": str(e)}

    # ------------------------------------------------------------------
    def serve(self, host: str = "0.0.0.0", port: int = 8000,
              reuse_port: bool = False):
        """Run the threaded HTTP server until ``shutdown``/``drain``.

        ``reuse_port`` sets ``SO_REUSEPORT`` so a replacement worker can
        bind the same port during a zero-downtime recycle (the kernel
        load-balances new connections across the reuseport group)."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _send(self, status: int, payload: Any, content_type="application/json"):
                body = (
                    json.dumps(payload).encode()
                    if content_type == "application/json"
                    else payload
                )
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Access-Control-Allow-Methods", "*")
                self.send_header("Access-Control-Allow-Headers", "*")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                pass  # quiet

            def do_OPTIONS(self):
                self._send(204, b"", content_type="text/plain")

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/app" or path.startswith("/app/"):
                    return self._serve_static(path)
                fmt = parse_qs(query).get("format", [""])[0]
                if path == "/metrics" and fmt == "prometheus":
                    return self._send(
                        200,
                        server.prometheus_metrics().encode(),
                        content_type="text/plain; version=0.0.4",
                    )
                status, payload = server.handle_get(path)
                self._send(status, payload)

            def _serve_static(self, path: str):
                rel = path[len("/app") :].lstrip("/") or "index.html"
                full = os.path.normpath(os.path.join(_FRONTEND_DIR, rel))
                # bare-prefix startswith would also admit sibling dirs like
                # frontend.bak/ — require containment under the dir itself
                inside = full == _FRONTEND_DIR or full.startswith(
                    _FRONTEND_DIR + os.sep
                )
                if not inside or not os.path.isfile(full):
                    return self._send(404, {"detail": "Not Found"})
                ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
                with open(full, "rb") as f:
                    self._send(200, f.read(), content_type=ctype)

            def do_POST(self):
                path = self.path.split("?")[0]
                length = int(self.headers.get("Content-Length", 0))
                if length > server.cfg.max_body_mb * 1024 * 1024:
                    # the body is NOT read — close the connection so the
                    # unread bytes can't be parsed as the next keep-alive
                    # request on this socket
                    self.close_connection = True
                    return self._send(
                        413,
                        {"detail": f"request body exceeds "
                                   f"{server.cfg.max_body_mb} MB"},
                    )
                body = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                if "multipart/form-data" not in ctype:
                    return self._send(400, {"detail": "multipart/form-data required"})
                fields = parse_multipart(ctype, body)
                if path == "/predict":
                    status, payload = server.handle_predict(fields)
                elif path == "/predict-batch":
                    status, payload = server.handle_predict_batch(fields)
                elif path == "/attention":
                    status, payload = server.handle_attention(fields)
                else:
                    status, payload = 404, {"detail": "Not Found"}
                self._send(status, payload)

        def _tracked(fn):
            # parsed-request dispatch only — an idle keep-alive connection
            # (blocked reading its next request line) is NOT in-flight and
            # may be severed by drain()
            def inner(h):
                with server._inflight_lock:
                    server._inflight += 1
                if server._draining:
                    h.close_connection = True
                try:
                    fn(h)
                finally:
                    with server._inflight_lock:
                        server._inflight -= 1

            return inner

        Handler.do_GET = _tracked(Handler.do_GET)
        Handler.do_POST = _tracked(Handler.do_POST)
        Handler.do_OPTIONS = _tracked(Handler.do_OPTIONS)

        server_cls = ThreadingHTTPServer
        if reuse_port:
            import socket

            class _ReuseportHTTPServer(ThreadingHTTPServer):
                def server_bind(self):
                    self.socket.setsockopt(
                        socket.SOL_SOCKET, socket.SO_REUSEPORT, 1
                    )
                    super().server_bind()

            server_cls = _ReuseportHTTPServer

        self._httpd = server_cls((host, port), Handler)
        # the supervisor parses this line from worker stdout as the
        # readiness signal: the socket binds only AFTER engine warmup, so
        # a bound port means a warm worker. The port printed is the one
        # bound, which port 0 picks.
        print(f"[API] serving on http://{host}:{self._httpd.server_address[1]} "
              "(frontend at /app)", flush=True)
        try:
            self._httpd.serve_forever()
        finally:
            self._httpd.server_close()

    def drain(self, timeout: float = 10.0) -> None:
        """Graceful stop: close the listening socket, finish in-flight
        requests (bounded by ``timeout``), then release the batcher.

        Idle keep-alive connections are deliberately severed — HTTP/1.1
        servers may close between requests; clients reconnect. Used by the
        recycle supervisor's SIGTERM path."""
        self._draining = True
        httpd = self._httpd
        if httpd is not None:
            # shutdown() blocks until serve_forever()'s loop exits, so it
            # must not run on the thread serve_forever occupies (nor in a
            # signal handler above it) — hand it to a helper thread
            threading.Thread(target=httpd.shutdown, daemon=True).start()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._inflight_lock:
                n = self._inflight
            if n == 0:
                # grace re-check: a request may have just been parsed on a
                # still-open keep-alive connection
                time.sleep(0.2)
                with self._inflight_lock:
                    if self._inflight == 0:
                        break
            else:
                # don't busy-spin the host core out from under the
                # in-flight requests we're waiting on
                time.sleep(0.05)
        self.batcher.shutdown()

    def shutdown(self):
        if self._httpd is not None:
            self._httpd.shutdown()
        self.batcher.shutdown()


def _looks_like_image(filename: str, data: bytes) -> bool:
    if re.search(r"\.(jpe?g|png|gif|bmp|webp)$", filename, re.I):
        return True
    return data[:2] in (b"\xff\xd8", b"\x89P") or data[:4] == b"GIF8"


def main(argv=None):
    import argparse
    import signal

    from vqa_tpu_torch.utils.config import PATHS, tiny_model_config

    p = argparse.ArgumentParser(description="VQA serving (PyTorch/CUDA port)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--tiny", action="store_true",
                   help="tiny random model (smoke/demo)")
    p.add_argument("--reuse-port", action="store_true",
                   help="bind with SO_REUSEPORT (worker-recycle overlap, "
                        "see vqa_tpu_torch.serving.supervisor)")
    p.add_argument("--drain-s", type=float, default=10.0,
                   help="max seconds to finish in-flight requests on "
                        "SIGTERM before exiting")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on; the CPU only when asked "
                        "(--device cpu)")
    args = p.parse_args(argv)

    model_config = tiny_model_config() if args.tiny else None
    engine = VQAInference(
        checkpoint_dir=args.checkpoint_dir or PATHS.checkpoint_dir,
        model_config=model_config,
        device=args.device,
    )
    server = VQAServer(engine=engine)

    # graceful SIGTERM: drain in-flight requests, then exit. The handler
    # runs on the main thread (which is blocked inside serve_forever), so
    # the drain — whose httpd.shutdown() needs serve_forever to resume and
    # exit — must run on a helper thread; the handler itself just returns.
    def _drain_and_exit():
        print("[API] SIGTERM — draining", flush=True)
        server.drain(timeout=args.drain_s)
        print("[API] drained; exiting", flush=True)
        os._exit(0)

    def _on_sigterm(signum, frame):
        threading.Thread(target=_drain_and_exit, daemon=True).start()

    signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        server.serve(args.host, args.port, reuse_port=args.reuse_port)
    except KeyboardInterrupt:
        print("[API] shutting down")
    finally:
        if server._draining:
            # the drain thread owns process exit (os._exit after in-flight
            # requests finish) — returning here would tear the interpreter
            # down under them
            threading.Event().wait()
        server.batcher.shutdown()


if __name__ == "__main__":
    main()
