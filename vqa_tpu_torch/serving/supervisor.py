"""RSS-bounded worker recycling for the port's serving layer.

A copy of ``vqa_tpu/serving/supervisor.py`` for the port's worker. It runs
the HTTP worker (``python -m vqa_tpu_torch.serving.server --reuse-port``)
as a child process, samples the child's RSS, and when it crosses
``--recycle-rss-mb`` performs a zero-downtime recycle, the standard
mitigation for long-lived native workers whose memory grows (cf. gunicorn
``max_requests``, uWSGI ``reload-on-rss``):

1. spawn a replacement worker on the SAME port (``SO_REUSEPORT`` — the
   kernel load-balances new connections across the reuseport group);
2. wait until the replacement is warm: the worker binds only after
   engine warmup and then prints its readiness line, which the
   supervisor watches for on the worker's stdout;
3. SIGTERM the old worker, which drains — stops accepting, finishes
   in-flight requests (bounded by ``--drain-s``), severs idle
   keep-alive connections (ordinary HTTP/1.1: clients reconnect) and
   exits.

Also respawns a worker that dies unexpectedly (crash-loop guarded by
``--max-restarts``). Emits one JSON line per lifecycle event on stdout
(``{"supervisor": "ready"|"recycle_start"|"recycle_done"|...}``).

This module imports no torch: it is a monitoring process, and its own RSS
is the point. Workers are separate processes started with ``subprocess``
(never a fork of a process that has initialised CUDA). Failed replacement
warmups spend the same ``--max-restarts`` budget as worker deaths, as in
the JAX package.

The default bound, ``DEFAULT_RECYCLE_RSS_MB`` (8192 MB), is not the JAX
package's 2048: a full-width bf16 port worker on the H100 is ready at
~6.1-6.2 GB of RSS, where the JAX worker starts at ~0.5 GB. Most of it is
not the worker's own: ``import torch`` maps CUDA libraries worth ~4.6 GB
of RSS before any CUDA call, and cuDNN's image and the libraries' first
use add ~1.3 GB. Below that figure every worker would be recycled at its
first check, forever.

Usage:
    python -m vqa_tpu_torch.serving.supervisor --port 8000 \
        --recycle-rss-mb 8192 [--tiny] [--checkpoint-dir D] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

READY_MARKER = "[API] serving on "
# above a full-width worker's ready RSS on the card, with room for growth
DEFAULT_RECYCLE_RSS_MB = 8192.0
# how long Worker.stop waits for the pump to echo an exited child's last lines
PUMP_JOIN_S = 5.0


def rss_mb(pid: int) -> float:
    """VmRSS of ``pid`` in MB (0.0 once the process is gone)."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


class Worker:
    """One serving child process + a stdout pump that spots readiness."""

    def __init__(self, cmd, env=None):
        self.proc = subprocess.Popen(
            cmd,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        self.ready = threading.Event()
        self._pump_thread = threading.Thread(target=self._pump, daemon=True)
        self._pump_thread.start()

    def _pump(self):
        assert self.proc.stdout is not None
        for line in self.proc.stdout:
            # Echo, then mark readiness: whoever waits on ``ready`` (the
            # supervisor's "ready" event) comes after the worker's own line
            # in our output. If our own stdout is a pipe whose reader died
            # (observed: harness killed mid-recycle), the echo raises
            # BrokenPipeError — that must not stop us from marking the
            # worker ready, or the recycle wedges on a worker that is in
            # fact serving.
            try:
                sys.stdout.write(f"[worker {self.proc.pid}] {line}")
                sys.stdout.flush()
            except OSError:
                pass  # keep draining the child's pipe so it never blocks
            if READY_MARKER in line:
                self.ready.set()

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.poll() is None

    def stop(self, drain_grace: float):
        """SIGTERM (worker drains in-flight requests), escalate to kill;
        then wait, at most ``PUMP_JOIN_S``, until the pump has echoed the
        child's last lines (the server's "drained; exiting" arrives just
        before the child exits, and the supervisor may exit right after)."""
        if self.alive():
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=drain_grace)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._pump_thread.join(timeout=PUMP_JOIN_S)
        return self.proc.returncode


def _event(kind: str, t0: float, **kw):
    # "wall" lets out-of-process harnesses align events with their own
    # sample clocks
    line = {"supervisor": kind, "t_s": round(time.monotonic() - t0, 1),
            "wall": round(time.time(), 2)}
    line.update(kw)
    print(json.dumps(line), flush=True)


def _pick_port(host: str) -> int:
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="VQA serving worker supervisor")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000,
                   help="0 picks a free port (printed in the ready event)")
    p.add_argument("--recycle-rss-mb", type=float, default=DEFAULT_RECYCLE_RSS_MB,
                   help="recycle the worker when its RSS crosses this")
    p.add_argument("--check-interval", type=float, default=1.0)
    p.add_argument("--ready-timeout", type=float, default=900.0,
                   help="max seconds for a worker to warm up and bind")
    p.add_argument("--drain-s", type=float, default=10.0,
                   help="worker's in-flight drain budget on SIGTERM")
    p.add_argument("--max-restarts", type=int, default=3,
                   help="give up after this many unexpected worker deaths")
    # passthrough to vqa_tpu_torch.serving.server
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--device", default=None)
    # test hook: replace the worker command entirely (shlex-split string);
    # lets the suite exercise spawn/retry/recycle logic without a model
    p.add_argument("--worker-cmd", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    host = args.host
    port = args.port if args.port else _pick_port(host)

    if args.worker_cmd:
        import shlex
        worker_cmd = shlex.split(args.worker_cmd)
    else:
        worker_cmd = [
            sys.executable, "-m", "vqa_tpu_torch.serving.server",
            "--host", host, "--port", str(port), "--reuse-port",
            "--drain-s", str(args.drain_s),
        ]
        if args.tiny:
            worker_cmd.append("--tiny")
        if args.checkpoint_dir:
            worker_cmd += ["--checkpoint-dir", args.checkpoint_dir]
        if args.device:
            worker_cmd += ["--device", args.device]

    t0 = time.monotonic()
    stop = threading.Event()

    def _on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    # Every child we ever spawned and haven't reaped: teardown must cover
    # a recycle caught mid-overlap (old worker + warming replacement), not
    # just the current serving worker. A supervisor SIGKILLed while blocked
    # in a multi-minute warmup wait orphaned the old worker once — hence
    # the stop-interruptible waits below and the finally-block sweep.
    live: set = set()

    def spawn() -> Worker:
        w = Worker(worker_cmd)
        live.add(w)
        _event("spawn", t0, pid=w.pid)
        return w

    def reap(w: Worker, drain_grace: float):
        w.stop(drain_grace=drain_grace)
        live.discard(w)

    def wait_ready(w: Worker, timeout: float) -> bool:
        """ready.wait() in 1 s slices so a stop signal interrupts a warmup
        wait (a warmup may run minutes; the parent's kill-grace is shorter)
        and a candidate that DIES mid-warmup fails fast instead of eating
        the whole timeout (a crash-looping worker would otherwise turn
        each retry into --ready-timeout of dead air).
        Returns False on timeout, death, or stop."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not stop.is_set():
            if w.ready.wait(min(1.0, max(0.0, deadline - time.monotonic()))):
                return True
            if not w.alive():
                # the pump may still be draining a final marker line
                return w.ready.wait(1.0) and not stop.is_set()
        return w.ready.is_set() and not stop.is_set()

    restarts = 0

    def spawn_until_ready():
        """Spawn a worker and wait for readiness; a warmup that never
        completes (a worker wedged in its device runtime) is treated like
        a dead worker — kill it and retry, against the shared
        ``--max-restarts`` budget.
        Returns the ready Worker, or None on budget exhaustion or stop."""
        nonlocal restarts
        while not stop.is_set():
            cand = spawn()
            if wait_ready(cand, args.ready_timeout):
                return cand
            if stop.is_set():
                reap(cand, drain_grace=5.0)
                return None
            restarts += 1
            _event("ready_timeout", t0, pid=cand.pid, restarts=restarts)
            reap(cand, drain_grace=5.0)
            if restarts > args.max_restarts:
                _event("giving_up", t0, restarts=restarts)
                return None
        return None

    recycles = 0
    recycling_enabled = True
    rc = 0
    try:
        worker = spawn_until_ready()
        if worker is None:
            return 1
        _event("ready", t0, pid=worker.pid, port=port,
               recycle_rss_mb=args.recycle_rss_mb)
        served_since = time.monotonic()

        while not stop.wait(args.check_interval):
            if not worker.alive():
                restarts += 1
                _event("worker_died", t0, pid=worker.pid,
                       returncode=worker.proc.poll(), restarts=restarts)
                live.discard(worker)
                if restarts > args.max_restarts:
                    _event("giving_up", t0, restarts=restarts)
                    rc = 1
                    break
                worker = spawn_until_ready()
                if worker is None:
                    rc = 1
                    break
                _event("ready", t0, pid=worker.pid, port=port)
                served_since = time.monotonic()
                continue

            r = rss_mb(worker.pid)
            if recycling_enabled and r > args.recycle_rss_mb:
                recycles += 1
                serve_s = time.monotonic() - served_since
                _event("recycle_start", t0, n=recycles, old_pid=worker.pid,
                       rss_mb=round(r, 1))
                warmup_t0 = time.monotonic()
                replacement = spawn()
                if not wait_ready(replacement, args.ready_timeout):
                    # keep serving on the (leaky but live) old worker
                    # rather than flap — a failed warmup must not take
                    # the port down; on stop, the finally sweep reaps both
                    if stop.is_set():
                        break
                    # a failed replacement warmup spends the same budget as
                    # a crash (--max-restarts): without this, a persistently
                    # wedged warmup (the mode documented above) respawns
                    # forever — one fresh device context per attempt
                    # alongside the live worker — with no terminal event.
                    # Exhausting the budget must NOT take the port down
                    # (the old worker still serves), so instead of exiting
                    # we stop attempting recycles and tell the operator.
                    restarts += 1
                    _event("recycle_ready_timeout", t0, pid=replacement.pid,
                           restarts=restarts)
                    reap(replacement, drain_grace=5.0)
                    recycles -= 1
                    if restarts > args.max_restarts:
                        recycling_enabled = False
                        _event("recycle_disabled", t0, restarts=restarts,
                               hint="replacement warmups exhausted "
                                    "--max-restarts; serving continues on "
                                    "the live worker with recycling OFF — "
                                    "RSS is now unbounded")
                    continue
                warmup_s = time.monotonic() - warmup_t0
                old = worker
                worker = replacement
                served_since = time.monotonic()
                drain_t0 = time.monotonic()
                reap(old, drain_grace=args.drain_s + 20.0)
                _event("recycle_done", t0, n=recycles, old_pid=old.pid,
                       new_pid=worker.pid,
                       drain_s=round(time.monotonic() - drain_t0, 1),
                       serve_s=round(serve_s, 1),
                       warmup_s=round(warmup_s, 1),
                       new_rss_mb=round(rss_mb(worker.pid), 1))
                if warmup_s > serve_s:
                    # the worker leaks past the threshold faster than a
                    # replacement can warm: the recycle loop can't keep the
                    # sawtooth under the configured bound — the operator
                    # should raise --recycle-rss-mb above
                    # warmup_rate × leak_rate
                    _event("recycle_period_warning", t0, n=recycles,
                           serve_s=round(serve_s, 1),
                           warmup_s=round(warmup_s, 1),
                           hint="replacement warmup exceeds the serve "
                                "period at this --recycle-rss-mb; RSS will "
                                "overshoot the bound — raise the threshold")
    finally:
        _event("stopping", t0, recycles=recycles, restarts=restarts,
               live_children=[w.pid for w in live])
        for w in list(live):
            reap(w, drain_grace=args.drain_s + 20.0)
        _event("stopped", t0)
    return rc


if __name__ == "__main__":
    sys.exit(main())
