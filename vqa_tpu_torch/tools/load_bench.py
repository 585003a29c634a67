"""Serving latency under concurrent load (BASELINE config #5: p50 and p99).

    python -m vqa_tpu_torch.tools.load_bench                 # on the card
    python -m vqa_tpu_torch.tools.load_bench --tiny --device cpu
    python -m vqa_tpu_torch.tools.load_bench --out load.json

Counterpart of ``scripts/load_bench.py``. Starts the port's HTTP stack in
process (stdlib ``ThreadingHTTPServer`` → ``MicroBatcher`` → bucket-padded
forward on the device), drives it with N concurrent clients, each posting
M multipart ``/predict`` requests with a random 224 px JPEG, and prints
one JSON line: client-side p50/p90/p99/mean ms, requests/s over the
clients' wall time, the server's ``/metrics`` counters and the device's
name. Defaults: 8 clients x 25 requests, a 5 ms collection window, the
full-width model, on ``cuda``. Writes a file only with ``--out``.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
import time
import urllib.request

import numpy as np
from PIL import Image

QUESTIONS = ["what color is the object", "how many shapes are there",
             "is there a circle", "what is in the image"]


def jpeg_bytes(seed: int, size: int = 224) -> bytes:
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(buf, "JPEG")
    return buf.getvalue()


def post_predict(url: str, image: bytes, question: str) -> dict:
    boundary = "XLOADBENCHX"
    body = (
        f'--{boundary}\r\nContent-Disposition: form-data; name="question"'
        f"\r\n\r\n{question}\r\n".encode()
        + f'--{boundary}\r\nContent-Disposition: form-data; name="image"; '
        f'filename="img.jpg"\r\nContent-Type: image/jpeg\r\n\r\n'.encode()
        + image
        + f"\r\n--{boundary}--\r\n".encode()
    )
    req = urllib.request.Request(
        url + "/predict", data=body,
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def bench(server, clients: int = 8, requests: int = 25) -> dict:
    """Serve ``server`` (a ``VQAServer``) on 127.0.0.1, run the load, shut
    the server down and return the result."""
    t = threading.Thread(target=server.serve, args=("127.0.0.1", 0), daemon=True)
    t.start()
    while server._httpd is None:
        time.sleep(0.05)
    url = f"http://127.0.0.1:{server._httpd.server_address[1]}"
    images = [jpeg_bytes(i) for i in range(clients)]
    # two sequential requests first (the server warmed every bucket at start)
    for img in images[:2]:
        post_predict(url, img, QUESTIONS[0])

    latencies, errors = [], []
    lock = threading.Lock()

    def client(cid: int):
        for i in range(requests):
            t0 = time.perf_counter()
            try:
                ok = post_predict(url, images[cid], QUESTIONS[(cid + i) % len(QUESTIONS)]
                                  ).get("success", False)
                err = None if ok else "success: false"
            except Exception as e:  # a failed request is counted, not fatal
                ok, err = False, f"{type(e).__name__}: {e}"
            dt = (time.perf_counter() - t0) * 1000
            with lock:
                if ok:
                    latencies.append(dt)
                else:
                    errors.append(err)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    server_metrics = server.batcher.latency_stats()
    server.shutdown()
    t.join(timeout=10)

    result = {"metric": "serving_latency_under_load", "clients": clients,
              "requests_per_client": requests, "requests_ok": len(latencies),
              "errors": len(errors), "error_samples": errors[:5]}
    if latencies:
        arr = np.asarray(latencies)
        result.update(
            p50_ms=float(np.percentile(arr, 50)), p90_ms=float(np.percentile(arr, 90)),
            p99_ms=float(np.percentile(arr, 99)), mean_ms=float(arr.mean()),
            throughput_rps=arr.size / wall, wall_s=wall)
    result["server_metrics"] = server_metrics
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--requests", type=int, default=25, help="requests per client")
    p.add_argument("--tiny", action="store_true", help="the tiny model, not full width")
    p.add_argument("--timeout-ms", type=float, default=5.0,
                   help="micro-batcher collection window")
    p.add_argument("--device", default="cuda", help="cpu only when asked")
    p.add_argument("--out", default=None, help="also write the JSON result here")
    args = p.parse_args(argv)

    import torch

    from vqa_tpu_torch.serving.engine import VQAInference
    from vqa_tpu_torch.serving.server import VQAServer
    from vqa_tpu_torch.utils.config import InferenceConfig, ModelConfig, tiny_model_config

    engine = VQAInference(model_config=tiny_model_config() if args.tiny else ModelConfig(),
                          device=args.device)
    server = VQAServer(engine=engine, config=InferenceConfig(batch_timeout_ms=args.timeout_ms))
    result = bench(server, args.clients, args.requests)
    result["model"] = "tiny" if args.tiny else "full width"
    result["backend"] = engine.get_model_info()["backend"]
    result["device"] = (torch.cuda.get_device_name(engine.device)
                        if engine.device.type == "cuda" else "cpu")
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0 if result["requests_ok"] and not result["errors"] else 1


if __name__ == "__main__":
    sys.exit(main())
