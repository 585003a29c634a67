"""Serving soak test: thousands of mixed requests against the port's server.

    python -m vqa_tpu_torch.tools.soak_test                     # on the card
    python -m vqa_tpu_torch.tools.soak_test --tiny --device cpu --requests 96 --clients 4
    python -m vqa_tpu_torch.tools.soak_test --supervisor-recycle-mb 4096 --out soak.json

Counterpart of ``scripts/soak_test.py:1-569``. Serves through the port's
``VQAServer`` in this process (stdlib ``ThreadingHTTPServer`` →
``MicroBatcher`` → bucket-padded forward on the device), or, with
``--supervisor-recycle-mb N``, out of process under the port's recycle
supervisor (``python -m vqa_tpu_torch.serving.supervisor``) with an RSS
bound of N MB. Each client holds one keep-alive connection and sends a
hostile mix:

- valid JPEG/PNG uploads from 64 to 1024 px     → 200, ``success: true``
- corrupt image bytes                           → ``success: false`` (200)
- an oversized ``Content-Length``               → 413, body not read
- a one-word question                           → 400
- ``/predict-batch`` with 3 images               → 3 predictions
- ``/metrics`` and ``/health`` probes

It reports ``requests_total`` against ``expected_total``,
``contract_violations`` (every answer outside that contract, by class),
``stuck_waiters`` (requests left in the batcher's queue), p50/p99 latency
of ``/predict`` per window, RSS sampled about once a second and its mean
and max per window, and ``rss_growth_last_third_pct``: smoothed RSS growth
over the last third of the run. Warmup growth is expected; a leak keeps
growing, so ``rss_plateaued`` needs that growth under 5%. Under the
supervisor the RSS is the whole process tree's, a sawtooth once a recycle
has begun, and the plateau is judged as the JAX script judges it: the tree
stays under 2x the bound + 1 GB, and the troughs after each recycle stay
within 10%. ``passed`` needs every request answered, none stuck, no
violation and the plateau; the exit code is 1 when it is false.

The full-width model is served (seeded random weights unless
``--checkpoint-dir`` names a checkpoint) in the engine's default dtype, bf16
on the card; ``--tiny`` serves the tiny model. The device is the card
unless ``--device cpu``. The JSON result is printed, and written to a file
only with ``--out``.
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
from PIL import Image

from vqa_tpu_torch.serving.supervisor import rss_mb

QUESTIONS = ["what color is the object", "how many shapes are there",
             "is there a circle", "what shape is in the top left"]
UPLOAD_SIZES = (64, 128, 224, 512, 1024)
PLATEAU_GROWTH = 0.05  # the largest smoothed RSS growth over the last third


def tree_rss_mb(root_pid: int) -> float:
    """Summed VmRSS (MB) of a process tree: the serving side's RSS when the
    server runs under the recycle supervisor. During a recycle it counts
    the old and the new worker together. The tree is found from each
    process's parent in ``/proc/<pid>/stat``."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue  # the process ended while the tree was read
        children.setdefault(ppid, []).append(int(entry))
    total, stack, seen = 0.0, [root_pid], set()
    while stack:
        pid = stack.pop()
        if pid not in seen:
            seen.add(pid)
            total += rss_mb(pid)
            stack.extend(children.get(pid, ()))
    return total


def image_bytes(seed: int, size: int, fmt: str = "JPEG") -> bytes:
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(buf, fmt)
    return buf.getvalue()


def upload_mix():
    """The uploads: a random JPEG at each of 64..1024 px and a 224 px PNG."""
    return ([image_bytes(i, s) for i, s in enumerate(UPLOAD_SIZES)]
            + [image_bytes(99, 224, "PNG")])


def multipart(fields) -> tuple:
    """(name, filename or None, bytes) parts → (body, content type)."""
    boundary = "XSOAKX"
    parts = []
    for name, filename, data in fields:
        head = f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"'
        if filename:
            head += f'; filename="{filename}"\r\nContent-Type: image/jpeg'
        parts.append(head.encode() + b"\r\n\r\n" + data + b"\r\n")
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


class Client(threading.Thread):
    """One keep-alive connection sending a deterministic mixed workload."""

    def __init__(self, cid, port, n, images, results, lock):
        super().__init__()
        self.cid, self.port, self.n = cid, port, n
        self.images, self.results, self.lock = images, results, lock
        self.conn = None

    def _request(self, method, path, body=None, headers=None):
        # a server may close a keep-alive connection between requests, and
        # during a recycle a retry can meet the draining worker's teardown:
        # reconnect up to twice (every endpoint here is idempotent)
        last = 2
        for attempt in range(last + 1):
            try:
                if self.conn is None:
                    self.conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
                self.conn.request(method, path, body=body, headers=headers or {})
                r = self.conn.getresponse()
                data = r.read()  # drained, so the connection can be reused
                if r.will_close:
                    self.conn.close()
                    self.conn = None
                return r.status, data
            except (OSError, http.client.HTTPException):
                if self.conn is not None:
                    self.conn.close()
                self.conn = None
                if attempt == last:
                    raise
                time.sleep(0.05 * (attempt + 1))
        raise AssertionError("unreachable")

    def _post(self, path, fields):
        body, ct = multipart(fields)
        return self._request("POST", path, body, {"Content-Type": ct})

    def _one(self, rng, i):
        """One request of the mix: (class, "ok" or what went wrong)."""
        kind = rng.random()
        if kind < 0.70:  # a valid upload
            img = self.images[int(rng.integers(len(self.images)))]
            s, data = self._post("/predict", [("question", None, QUESTIONS[i % 4].encode()),
                                              ("image", "x.jpg", img)])
            ok = s == 200 and json.loads(data).get("success")
            return "predict", "ok" if ok else f"bad:{s}"
        if kind < 0.78:  # corrupt bytes: a success-false payload, not a 5xx
            junk = bytes(rng.integers(0, 256, size=512, dtype=np.uint8))
            s, data = self._post("/predict", [("question", None, b"what is this"),
                                              ("image", "x.jpg", junk)])
            ok = not json.loads(data).get("success", True)
            return "corrupt", "ok" if ok else f"bad:{s}"
        if kind < 0.84:  # a body too large: 413 before it is read
            s, _ = self._request("POST", "/predict", b"x" * 1024, {
                "Content-Type": "multipart/form-data; boundary=B",
                "Content-Length": str(300 * 1024 * 1024)})
            return "oversize", "ok" if s == 413 else f"bad:{s}"
        if kind < 0.90:  # a question too short: 400
            s, _ = self._post("/predict", [("question", None, b"x"),
                                           ("image", "x.jpg", self.images[0])])
            return "badq", "ok" if s == 400 else f"bad:{s}"
        if kind < 0.96:  # /predict-batch with 3 images
            imgs = [self.images[int(rng.integers(len(self.images)))] for _ in range(3)]
            s, data = self._post(
                "/predict-batch", [("questions", None, ",".join(QUESTIONS[:3]).encode())]
                + [("images", "x.jpg", img) for img in imgs])
            resp = json.loads(data)
            ok = s == 200 and resp.get("success") and len(resp.get("predictions", [])) == 3
            return "batch", "ok" if ok else f"bad:{s}"
        s, _ = self._request("GET", "/metrics" if i % 2 else "/health")
        return "probe", "ok" if s == 200 else f"bad:{s}"

    def run(self):
        rng = np.random.default_rng(1000 + self.cid)
        for i in range(self.n):
            t0 = time.perf_counter()
            try:
                cls, outcome = self._one(rng, i)
            except (OSError, http.client.HTTPException, ValueError) as e:
                cls, outcome = "predict", f"exc:{type(e).__name__}"
            dt = (time.perf_counter() - t0) * 1000
            with self.lock:
                self.results["count"][cls] = self.results["count"].get(cls, 0) + 1
                if outcome != "ok":
                    key = f"{cls}:{outcome}"
                    self.results["bad"][key] = self.results["bad"].get(key, 0) + 1
                if cls == "predict" and outcome == "ok":
                    self.results["lat"].append((time.perf_counter(), dt))
        if self.conn is not None:
            self.conn.close()


class SupervisedServer:
    """The serving side as ``python -m vqa_tpu_torch.serving.supervisor``,
    its JSON event lines followed."""

    def __init__(self, args):
        cmd = [sys.executable, "-m", "vqa_tpu_torch.serving.supervisor",
               "--host", "127.0.0.1", "--port", "0",
               "--recycle-rss-mb", str(args.supervisor_recycle_mb),
               "--ready-timeout", "600", "--device", args.device]
        if args.tiny:
            cmd.append("--tiny")
        if args.checkpoint_dir:
            cmd += ["--checkpoint-dir", args.checkpoint_dir]
        # the supervisor and its workers import this package from where it lies
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env)
        self.events = []
        self.port = None
        self._ready = threading.Event()
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.proc.stdout:
            sys.stdout.write("[sup] " + line)
            sys.stdout.flush()
            if not line.startswith("{"):
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            if "supervisor" in ev:
                self.events.append(ev)
                if ev["supervisor"] == "ready" and self.port is None:
                    self.port = ev["port"]
                    self._ready.set()

    def wait_port(self, timeout: float) -> int:
        """The port once the first worker is ready; raises at once if the
        supervisor exits first."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._ready.wait(min(1.0, max(0.0, deadline - time.monotonic()))):
                return self.port
            rc = self.proc.poll()
            if rc is not None:
                if self._ready.wait(1.0):  # a last event still being read
                    return self.port
                raise RuntimeError(f"supervisor exited rc={rc} before its worker became "
                                   f"ready (last events: {self.events[-3:]})")
        self.stop()
        raise RuntimeError("supervisor worker never became ready")

    def recycle_events(self):
        return [e for e in self.events
                if e["supervisor"].startswith(("recycle", "worker_died"))]

    def stop(self):
        if self.proc.poll() is not None:
            return
        try:
            self.proc.send_signal(signal.SIGTERM)
        except ProcessLookupError:
            return
        try:
            self.proc.wait(timeout=90)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def _http_json(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def _latency_windows(lat, k: int = 5):
    """p50/p99 of /predict latency in k windows by completion time."""
    windows = []
    per = max(len(lat) // k, 1)
    for w in range(0, len(lat), per):
        chunk = np.asarray([d for _, d in lat[w:w + per]])
        windows.append({"n": int(chunk.size),
                        "p50_ms": round(float(np.percentile(chunk, 50)), 2),
                        "p99_ms": round(float(np.percentile(chunk, 99)), 2)})
    return windows


def _rss_analysis(series, wall: float, rss0: float, rss1: float) -> dict:
    """RSS per tenth of the run and the smoothed growth over its last third:
    the mean of the last fifth of the samples against the first fifth."""
    windows = []
    for w in range(10):
        lo, hi = wall * w / 10, wall * (w + 1) / 10
        vals = [r for t, r in series if lo <= t <= hi]
        if vals:
            windows.append({"t_s": round(hi, 1), "mean_mb": round(float(np.mean(vals)), 1),
                            "max_mb": round(float(np.max(vals)), 1)})
    last_third = [r for t, r in series if t >= wall * 2 / 3]
    if len(last_third) >= 10:
        k = max(len(last_third) // 5, 1)
        head, tail = float(np.mean(last_third[:k])), float(np.mean(last_third[-k:]))
    elif last_third:
        head, tail = last_third[0], last_third[-1]
    else:  # a run shorter than a second
        head, tail = rss0, rss1
    growth = tail / head - 1.0 if head else 0.0
    return {"rss_windows": windows,
            "rss_growth_last_third_pct": round(growth * 100, 2),
            "rss_plateaued": bool(growth < PLATEAU_GROWTH)}


def _sawtooth_plateau(out: dict, series, wall0: float, bound_mb: float, rss_max: float):
    """Under the supervisor, once a second worker has entered the tree the
    tree's RSS is a sawtooth: the plateau is a bounded maximum (2x the bound
    + 1 GB: the old worker may overshoot while the replacement warms) and
    stationary troughs after each recycle (within 10%)."""
    limit = 2 * bound_mb + 1024
    troughs = []
    for e in out["recycles"]:
        if e["supervisor"] != "recycle_done" or "wall" not in e:
            continue
        t_ev = e["wall"] - wall0
        cand = [r for t, r in series if t >= t_ev + 3.0]
        if cand:
            troughs.append(round(cand[0], 1))
    growth = (troughs[-1] / troughs[0] - 1.0) * 100.0 if len(troughs) >= 2 else None
    out.update(rss_bound_mb=limit, rss_bounded=bool(rss_max < limit), trough_rss_mb=troughs,
               trough_growth_pct=round(growth, 2) if growth is not None else None,
               plateau_definition="sawtooth: bounded max + stationary post-recycle troughs "
                                  "(the last-third statistic is reported but not scored)")
    out["rss_plateaued"] = bool(rss_max < limit and (growth is None or growth < 10.0))


def run(args) -> dict:
    """Serve, run the clients to the end, stop serving: the result."""
    server = sup = None
    if args.supervisor_recycle_mb:
        sup = SupervisedServer(args)
        try:
            port = sup.wait_port(timeout=1500)
        except BaseException:
            sup.stop()
            raise
        rss_fn = lambda: tree_rss_mb(sup.proc.pid)  # noqa: E731
    else:
        from vqa_tpu_torch.serving.engine import VQAInference
        from vqa_tpu_torch.serving.server import VQAServer
        from vqa_tpu_torch.utils.config import InferenceConfig, ModelConfig, tiny_model_config

        engine = VQAInference(checkpoint_dir=args.checkpoint_dir,
                              model_config=tiny_model_config() if args.tiny else ModelConfig(),
                              device=args.device)
        server = VQAServer(engine=engine, preload=True, config=InferenceConfig())
        threading.Thread(target=server.serve, args=("127.0.0.1", 0), daemon=True).start()
        while server._httpd is None:
            time.sleep(0.05)
        port = server._httpd.server_address[1]
        rss_fn = lambda: rss_mb(os.getpid())  # noqa: E731
    try:
        out = _drive(args, port, rss_fn, server, sup)
    finally:
        if sup is not None:
            sup.stop()
        else:
            server.shutdown()
    return out


def _drive(args, port, rss_fn, server, sup) -> dict:
    images = upload_mix()
    results = {"count": {}, "bad": {}, "lat": []}
    lock = threading.Lock()
    per_client = args.requests // args.clients
    rss0 = rss_fn()
    clients = [Client(c, port, per_client, images, results, lock) for c in range(args.clients)]
    t0 = time.perf_counter()
    wall0 = time.time()  # aligns the supervisor's "wall" stamps with t0
    for c in clients:
        c.start()
    rss_max, series = rss0, [(0.0, rss0)]
    while any(c.is_alive() for c in clients):
        time.sleep(1)
        r = rss_fn()
        rss_max = max(rss_max, r)
        series.append((time.perf_counter() - t0, r))
    for c in clients:
        c.join()
    wall = time.perf_counter() - t0
    rss1 = rss_fn()
    series.append((wall, rss1))

    total = sum(results["count"].values())
    stuck = server.batcher._q.qsize() if server else 0
    lat = sorted(results["lat"])  # by completion time
    arr = np.asarray([d for _, d in lat]) if lat else np.zeros(1)
    out = {
        "metric": "serving_soak",
        "requests_total": total,
        "expected_total": per_client * args.clients,
        "wall_s": round(wall, 1),
        "throughput_rps": round(total / wall, 1),
        "mix_counts": results["count"],
        "contract_violations": results["bad"],
        "predict_p50_ms": round(float(np.percentile(arr, 50)), 2),
        "predict_p99_ms": round(float(np.percentile(arr, 99)), 2),
        "latency_drift_windows": _latency_windows(lat) if lat else [],
        "stuck_waiters": stuck,
        "rss_start_mb": round(rss0, 1),
        "rss_end_mb": round(rss1, 1),
        "rss_max_mb": round(rss_max, 1),
        **_rss_analysis(series, wall, rss0, rss1),
        "model": "tiny" if args.tiny else "full width",
    }
    if sup is not None:
        # separate fetches: a worker recycling between them must not cost
        # the one already in hand
        try:
            out["server_metrics"] = _http_json(port, "/metrics")
        except (OSError, http.client.HTTPException, ValueError) as e:
            out["server_metrics"] = {"error": type(e).__name__}
        try:
            out["backend"] = _http_json(port, "/model-info").get("device")
        except (OSError, http.client.HTTPException, ValueError) as e:
            out["backend"] = f"error:{type(e).__name__}"
        out["rss_scope"] = "supervisor process tree"
        out["supervisor_recycle_mb"] = args.supervisor_recycle_mb
        out["recycles"] = sup.recycle_events()
        out["recycles_done"] = sum(1 for e in out["recycles"]
                                   if e["supervisor"] == "recycle_done")
        if out["recycles"]:
            _sawtooth_plateau(out, series, wall0, args.supervisor_recycle_mb, rss_max)
    else:
        out["server_metrics"] = server.batcher.latency_stats()
        out["backend"] = server.engine.get_model_info()["backend"]
    out["passed"] = bool(total == per_client * args.clients and stuck == 0
                         and not results["bad"] and out["rss_plateaued"])
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--requests", type=int, default=10000)
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--tiny", action="store_true", help="the tiny model, not full width")
    p.add_argument("--checkpoint-dir", default=None,
                   help="serve this checkpoint (default: seeded random weights)")
    p.add_argument("--supervisor-recycle-mb", type=float, default=0.0,
                   help="serve out of process under the recycle supervisor with this RSS "
                        "bound (0 = in this process, no recycling)")
    p.add_argument("--device", default="cuda", help="cpu only when asked")
    p.add_argument("--out", default=None, help="also write the JSON result here")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    out = run(args)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0 if out["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
