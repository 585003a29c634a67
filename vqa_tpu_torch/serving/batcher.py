"""Cross-request micro-batching queue with a two-stage device pipeline.

Counterpart of ``vqa_tpu/serving/batcher.py``, with the same collection
window, adaptive grouping, per-request decode isolation, pipeline depth,
shutdown order and latency counters. Concurrent requests are collected for
up to ``batch_timeout_ms`` (or until ``max_batch_size``), run as ONE
bucket-padded forward, and their results fanned back out.

Two pipelined stages: a *dispatch* thread decodes the group and launches
the forward without waiting on the card (the engine stages its inputs
through pinned memory, so the launch queues behind the previous forward
instead of blocking on it), and a *completion* thread copies the
probabilities to the host and wakes the waiters. While group N runs on the
card, group N+1 is already being decoded and launched.

Thread-based (works under any HTTP server, stdlib or ASGI): callers block
on a per-request event. ``torch.inference_mode`` is thread-local; the
engine's ``dispatch_probs_from_pixels`` enters it on the dispatch thread.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np


@dataclass
class _Request:
    image: Any
    question: str
    top_k: int
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[dict] = None
    error: Optional[Exception] = None


class MicroBatcher:
    """Collect → batch → dispatch forward → (pipelined) fetch → fan out."""

    def __init__(
        self,
        engine,
        max_batch_size: int = 32,
        batch_timeout_ms: float = 5.0,
        pipeline_depth: int = 2,
    ):
        self.engine = engine
        # groups must fit a bucket: the dispatch path does not chunk
        # (predict_batch_raw does, for the non-batched entry points)
        max_bucket = max(engine.cfg.batch_buckets)
        self.max_batch_size = min(max_batch_size, max_bucket)
        self.timeout_s = batch_timeout_ms / 1000.0
        self._q: "queue.Queue[_Request]" = queue.Queue()
        # (group, good, device_probs, n) flowing dispatch → completion;
        # bounded so dispatch can't run unboundedly ahead of the device
        self._inflight: "queue.Queue" = queue.Queue(maxsize=pipeline_depth)
        self._stop = threading.Event()
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._completer = threading.Thread(target=self._complete_loop,
                                           daemon=True)
        self._dispatcher.start()
        self._completer.start()
        # observability: serving latency counters. total_* are monotonic
        # (Prometheus counter semantics); _latencies_ms is a sliding window
        # for the quantiles only.
        self.total_requests = 0
        self.total_batches = 0
        self.total_latency_ms = 0.0
        self._latencies_ms: List[float] = []
        self._lat_lock = threading.Lock()

    # ------------------------------------------------------------------
    def submit(self, image, question: str, top_k: int = 5, timeout: float = 30.0) -> dict:
        """Blocking submit — returns the prediction dict."""
        if self._stop.is_set():
            raise RuntimeError("server shutting down")
        t0 = time.perf_counter()
        req = _Request(image=image, question=question, top_k=top_k)
        self._q.put(req)
        # close the submit/shutdown race: a put that slipped in after
        # shutdown()'s drain pass would otherwise sit in a dead queue until
        # the caller's full timeout — re-check and drain (failing fast any
        # stranded request, possibly including this one)
        if self._stop.is_set():
            self._drain_pending()
        if not req.event.wait(timeout):
            raise TimeoutError("prediction timed out")
        if req.error is not None:
            raise req.error
        with self._lat_lock:
            lat_ms = (time.perf_counter() - t0) * 1000
            self.total_requests += 1
            self.total_latency_ms += lat_ms
            self._latencies_ms.append(lat_ms)
            if len(self._latencies_ms) > 10000:
                self._latencies_ms = self._latencies_ms[-5000:]
        return req.result

    def latency_stats(self) -> dict:
        with self._lat_lock:
            lat = list(self._latencies_ms)
            totals = {
                "total_requests": self.total_requests,
                "total_latency_ms": self.total_latency_ms,
                "batches": self.total_batches,
            }
        if not lat:
            return {"count": 0, **totals}
        arr = np.asarray(lat)
        return {
            # count/quantiles describe the sliding window; total_* are
            # monotonic since server start
            "count": int(arr.size),
            "p50_ms": float(np.percentile(arr, 50)),
            "p99_ms": float(np.percentile(arr, 99)),
            "mean_ms": float(arr.mean()),
            **totals,
        }

    def shutdown(self) -> None:
        # order matters: the dispatcher must fully stop (it may be about to
        # put a dispatched group into _inflight) before the completer is
        # allowed to decide the pipeline is drained — otherwise a group can
        # be stranded with its waiters' events never set
        self._stop.set()
        self._dispatcher.join(timeout=2.0)
        self._completer.join(timeout=2.0)
        # fail requests still waiting in the collect queue (the dispatcher
        # exits without draining it) instead of leaving their submit()
        # callers to hang until timeout; late submits fail fast the same way
        self._drain_pending()

    def _drain_pending(self) -> None:
        """Fail-fast every request still in the collect queue. Safe to call
        from multiple threads: each queued request is claimed by exactly one
        get_nowait."""
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            req.error = RuntimeError("server shutting down")
            req.event.set()

    # ------------------------------------------------------------------
    def _collect(self) -> List[_Request]:
        """Adaptive grouping: collect for ``batch_timeout_ms`` as a floor,
        but while the device pipeline is FULL keep collecting — that wait
        is free (the group couldn't dispatch anyway), so a saturated server
        forms large buckets while an idle one stays at the low-latency
        window."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        group = [first]
        deadline = time.perf_counter() + self.timeout_s
        while len(group) < self.max_batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                if not self._inflight.full():
                    break  # window over and the pipeline has room: go
                remaining = 0.002  # device busy — grouping costs nothing
            try:
                group.append(self._q.get(timeout=remaining))
            except queue.Empty:
                if time.perf_counter() >= deadline and not self._inflight.full():
                    break
        return group

    def _decode_group(self, group: List[_Request]):
        """Decode/resize the whole group in one call; only if that fails,
        decode per request, so one corrupt upload fails only its own
        request, not every concurrent caller batched with it."""
        good: List[_Request] = []
        pixels: List[Any] = []
        try:
            batch_pixels = self.engine._preprocess_images(
                [r.image for r in group]
            )
            good = list(group)
            pixels = list(batch_pixels)
        except Exception:
            for r in group:
                try:
                    pixels.append(
                        self.engine._preprocess_images([r.image])[0]
                    )
                    good.append(r)
                except Exception as e:
                    r.error = e
        return good, pixels

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            group = self._collect()
            if not group:
                continue
            good, pixels = self._decode_group(group)
            probs = n = None
            if good:
                try:
                    probs, n = self.engine.dispatch_probs_from_pixels(
                        np.stack(pixels), [r.question for r in good]
                    )
                except Exception as e:  # dispatch-time failure
                    for r in good:
                        r.error = e
                    good = []
            self._inflight.put((group, good, probs, n))

    def _complete_loop(self) -> None:
        # drain until: stop requested AND the dispatcher can no longer add
        # work AND nothing is in flight (see shutdown() ordering)
        while not (
            self._stop.is_set()
            and not self._dispatcher.is_alive()
            and self._inflight.empty()
        ):
            try:
                group, good, probs, n = self._inflight.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                if good:
                    # device → host copy; waits for this group's forward
                    host = probs.cpu().numpy()[:n]
                    for r, p in zip(good, host):
                        r.result = self.engine._format_result(
                            r.question, p, r.top_k
                        )
            except Exception as e:  # fetch/device failure affects the batch
                for r in good:
                    r.error = e
            finally:
                self.total_batches += 1
                for r in group:
                    r.event.set()
