"""The port's worker-recycle supervisor (``vqa_tpu_torch.serving.supervisor``).

The fake-worker cases of ``tests/test_supervisor.py`` run against the
port's copy: RSS sampling, port picking, the stdout readiness handshake,
retry of a wedged warmup, stop mid-recycle, the recycle-period warning,
the restart budget (failed replacement warmups spend it, as in the JAX
package), crash-loop give-up, and SIGTERM escalation; the order of the
echo (a worker's ready line is echoed before it counts as ready, and its
last line before ``Worker.stop`` returns). Then one real
worker (``--tiny --device cpu``) serves a request and drains on SIGTERM,
and the supervisor module is shown to import no torch.
"""

from __future__ import annotations

import io
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from vqa_tpu_torch.serving.supervisor import (
    DEFAULT_RECYCLE_RSS_MB,
    READY_MARKER,
    Worker,
    _pick_port,
    rss_mb,
)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUPERVISOR = [sys.executable, "-m", "vqa_tpu_torch.serving.supervisor"]


def _start(args):
    return subprocess.Popen(SUPERVISOR + args, cwd=REPO, stdout=subprocess.PIPE, text=True)


def test_ready_marker_is_the_servers_line():
    from vqa_tpu.serving.supervisor import READY_MARKER as JAX_MARKER

    assert READY_MARKER == JAX_MARKER == "[API] serving on "


def test_rss_mb_reads_self_and_gone_process():
    assert rss_mb(os.getpid()) > 1.0
    assert rss_mb(2**22 + 12345) == 0.0  # beyond pid_max


def test_pick_port_is_bindable():
    port = _pick_port("127.0.0.1")
    assert 1024 <= port <= 65535
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", port))
    s.close()


def test_worker_readiness_handshake():
    w = Worker([sys.executable, "-u", "-c",
                f"import time; print('{READY_MARKER}http://x:1 (frontend)'); time.sleep(60)"])
    try:
        assert w.ready.wait(timeout=20)
        assert w.alive()
    finally:
        w.stop(drain_grace=5.0)
    assert not w.alive()


def test_worker_not_ready_without_marker():
    w = Worker([sys.executable, "-u", "-c", "import time; print('warming'); time.sleep(60)"])
    try:
        assert not w.ready.wait(timeout=2)
    finally:
        w.stop(drain_grace=5.0)


def test_initial_spawn_retries_on_wedged_warmup(tmp_path):
    """A first worker whose warmup never completes is killed at
    --ready-timeout and respawned; the fake worker is ready only on its
    second spawn."""
    flag = tmp_path / "second_spawn"
    fake = ("import os, sys, time; f = sys.argv[1]\n"
            "if os.path.exists(f):\n"
            f"    print({READY_MARKER + 'http://x:1'!r}, flush=True)\n"
            "else:\n"
            "    open(f, 'w').close(); print('warming', flush=True)\n"
            "time.sleep(120)\n")
    proc = _start(["--port", "0", "--ready-timeout", "10", "--check-interval", "0.2",
                   "--max-restarts", "3", "--worker-cmd", f"{sys.executable} -u -c \"{fake}\" {flag}"])
    events = []
    deadline = time.monotonic() + 90
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if line.startswith("{"):
            events.append(json.loads(line)["supervisor"])
            if events[-1] == "ready":
                break
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=30)
    kinds = [k for k in events if k != "spawn"]
    assert kinds and kinds[-1] == "ready", events
    assert "ready_timeout" in kinds, events
    assert rc == 0


def test_stop_mid_recycle_reaps_both_children(tmp_path):
    flag = tmp_path / "first_spawn_done"
    fake = ("import os, sys, time; f = sys.argv[1]\n"
            "if not os.path.exists(f):\n"
            "    open(f, 'w').close()\n"
            f"    print({READY_MARKER + 'http://x:1'!r}, flush=True)\n"
            "else:\n"
            "    print('warming forever', flush=True)\n"
            "time.sleep(300)\n")
    proc = _start(["--port", "0", "--ready-timeout", "240", "--check-interval", "0.2",
                   "--recycle-rss-mb", "1",
                   "--worker-cmd", f"{sys.executable} -u -c \"{fake}\" {flag}"])
    child_pids, saw_recycle_start = [], False
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line.startswith("{"):
            continue
        ev = json.loads(line)
        if ev["supervisor"] == "spawn":
            child_pids.append(ev["pid"])
        saw_recycle_start |= ev["supervisor"] == "recycle_start"
        if saw_recycle_start and len(child_pids) >= 2:
            break
    assert saw_recycle_start and len(child_pids) >= 2, child_pids
    t0 = time.monotonic()
    proc.send_signal(signal.SIGTERM)
    proc.wait(timeout=45)
    assert time.monotonic() - t0 < 45
    time.sleep(1.0)
    for pid in child_pids:
        assert rss_mb(pid) == 0.0, f"orphaned child {pid}"


def test_recycle_period_warning_when_warmup_outpaces_serving():
    fake = ("import time; time.sleep(2.0)\n"
            f"print({READY_MARKER + 'http://x:1'!r}, flush=True)\n"
            "time.sleep(300)\n")
    proc = _start(["--port", "0", "--ready-timeout", "60", "--check-interval", "0.2",
                   "--recycle-rss-mb", "1", "--worker-cmd", f"{sys.executable} -u -c \"{fake}\""])
    kinds = []
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line.startswith("{"):
            continue
        ev = json.loads(line)
        kinds.append(ev["supervisor"])
        if ev["supervisor"] == "recycle_period_warning":
            assert ev["warmup_s"] > ev["serve_s"], ev
            break
    proc.send_signal(signal.SIGTERM)
    proc.wait(timeout=45)
    assert "recycle_period_warning" in kinds, kinds


def test_persistently_wedged_recycle_disables_recycling(tmp_path):
    """Failed replacement warmups spend the --max-restarts budget (the JAX
    package's behaviour, kept); on exhaustion recycling turns off and the
    live worker keeps serving."""
    flag = tmp_path / "first_spawn_done"
    fake = ("import os, sys, time; f = sys.argv[1]\n"
            "if not os.path.exists(f):\n"
            "    open(f, 'w').close()\n"
            f"    print({READY_MARKER + 'http://x:1'!r}, flush=True)\n"
            "else:\n"
            "    print('warming forever', flush=True)\n"
            "time.sleep(300)\n")
    proc = _start(["--port", "0", "--ready-timeout", "3", "--check-interval", "0.2",
                   "--recycle-rss-mb", "1", "--max-restarts", "1",
                   "--worker-cmd", f"{sys.executable} -u -c \"{fake}\" {flag}"])
    events = []
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line.startswith("{"):
            continue
        events.append(json.loads(line))
        if events[-1]["supervisor"] == "recycle_disabled":
            break
    kinds = [e["supervisor"] for e in events]
    assert "recycle_disabled" in kinds, kinds
    assert kinds.count("recycle_ready_timeout") == 2, kinds
    time.sleep(1.5)
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=45)
    events += [json.loads(line) for line in proc.stdout.read().splitlines()
               if line.startswith("{")]
    kinds = [e["supervisor"] for e in events]
    assert rc == 0, kinds
    assert "giving_up" not in kinds, kinds
    assert "recycle_start" not in kinds[kinds.index("recycle_disabled"):], kinds
    time.sleep(1.0)
    for e in events:
        if e["supervisor"] == "spawn":
            assert rss_mb(e["pid"]) == 0.0, f"orphaned child {e['pid']}"


def test_crash_looping_worker_fails_fast():
    t0 = time.monotonic()
    proc = _start(["--port", "0", "--ready-timeout", "300", "--check-interval", "0.2",
                   "--max-restarts", "2",
                   "--worker-cmd", f"{sys.executable} -c \"import sys; sys.exit(3)\""])
    rc = proc.wait(timeout=60)
    assert rc == 1
    assert time.monotonic() - t0 < 60
    kinds = [json.loads(line)["supervisor"] for line in proc.stdout if line.startswith("{")]
    assert "giving_up" in kinds, kinds


def test_worker_stop_escalates_to_kill():
    w = Worker([sys.executable, "-u", "-c",
                "import signal, time; signal.signal(signal.SIGTERM, signal.SIG_IGN); "
                "print('x'); time.sleep(120)"])
    try:
        time.sleep(1.0)  # let the child install its handler
        w.stop(drain_grace=2.0)
    finally:
        assert not w.alive()


def test_worker_is_ready_only_after_its_ready_line_is_echoed(monkeypatch):
    """The supervisor prints its "ready" event once ``Worker.ready`` is set;
    the worker's own ready line must already be in the output by then. The
    echo is slowed to 0.3 s a line, so a pump that marked readiness before
    echoing would be caught between the two."""
    seen_at_ready = []

    class SlowOut:
        def __init__(self):
            self.lines = []

        def write(self, s):
            time.sleep(0.3)
            self.lines.append(s)

        def flush(self):
            pass

    out = SlowOut()
    monkeypatch.setattr(sys, "stdout", out)
    w = Worker([sys.executable, "-u", "-c",
                f"import time; print('warming'); print({READY_MARKER + 'x'!r}); "
                "time.sleep(60)"])
    try:
        assert w.ready.wait(30)
        seen_at_ready.extend(out.lines)
    finally:
        w.stop(drain_grace=5.0)
    assert any(READY_MARKER in ln for ln in seen_at_ready), seen_at_ready


def test_worker_stop_echoes_the_childs_last_line(monkeypatch):
    """``Worker.stop`` returns only once the pump has echoed what the child
    wrote before it exited: the supervisor exits right after stopping its
    workers, and a daemon pump still echoing would lose the worker's last
    line (the server's "drained; exiting"). The echo is slowed to 2 ms a
    line, so 300 lines written at SIGTERM take ~0.6 s to echo after the
    child has exited."""

    class SlowOut:
        def __init__(self):
            self.lines = []

        def write(self, s):
            time.sleep(0.002)
            self.lines.append(s)

        def flush(self):
            pass

    out = SlowOut()
    monkeypatch.setattr(sys, "stdout", out)
    w = Worker([sys.executable, "-c",
                "import os, signal, sys, time\n"
                "def bye(*_):\n"
                "    for i in range(300):\n"
                "        print(f'draining {i}')\n"
                "    print('[API] drained; exiting')\n"
                "    sys.stdout.flush()\n"
                "    os._exit(0)\n"
                "signal.signal(signal.SIGTERM, bye)\n"
                "print('up', flush=True)\n"
                "time.sleep(60)\n"])
    deadline = time.monotonic() + 30
    while not out.lines and time.monotonic() < deadline:
        time.sleep(0.05)
    assert out.lines, "the fake worker never started"
    assert w.stop(drain_grace=10.0) == 0
    assert out.lines[-1].endswith("[API] drained; exiting\n"), out.lines[-3:]
    assert len(out.lines) == 302


def test_real_worker_serves_and_drains_on_sigterm():
    """``--tiny --device cpu --port 0``: the supervisor's worker is the
    port's server, warms, answers /predict, and on SIGTERM drains and
    exits 0 with the supervisor."""
    from PIL import Image

    proc = _start(["--host", "127.0.0.1", "--port", "0", "--tiny", "--device", "cpu",
                   "--check-interval", "0.5", "--recycle-rss-mb", "100000",
                   "--drain-s", "5", "--ready-timeout", "120"])
    lines, ready, pids = [], None, []
    deadline = time.monotonic() + 150
    while time.monotonic() < deadline and ready is None:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if line.startswith("{"):
            ev = json.loads(line)
            if ev["supervisor"] == "spawn":
                pids.append(ev["pid"])
            if ev["supervisor"] == "ready":
                ready = ev
    try:
        assert ready is not None, "".join(lines)
        assert any(READY_MARKER in ln for ln in lines)  # the worker's own line, echoed
        buf = io.BytesIO()
        Image.new("RGB", (50, 40), (10, 200, 90)).save(buf, "PNG")
        body = (b'--B\r\nContent-Disposition: form-data; name="question"\r\n\r\n'
                b"what color is this\r\n--B\r\nContent-Disposition: form-data; "
                b'name="image"; filename="a.png"\r\n\r\n' + buf.getvalue() + b"\r\n--B--\r\n")
        req = urllib.request.Request(f"http://127.0.0.1:{ready['port']}/predict", data=body,
                                     headers={"Content-Type": "multipart/form-data; boundary=B"})
        with urllib.request.urlopen(req, timeout=60) as r:
            payload = json.loads(r.read())
        assert payload["success"] is True and payload["answers"]
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    rest = proc.stdout.read()
    assert rc == 0, rest
    assert "[API] drained; exiting" in rest, rest
    time.sleep(0.5)
    for pid in pids:
        assert rss_mb(pid) == 0.0, f"orphaned worker {pid}"


def test_importing_the_supervisor_pulls_in_no_torch():
    code = ("import sys\n"
            "import vqa_tpu_torch.serving.supervisor\n"
            "import vqa_tpu_torch.serving\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('torch', 'numpy', 'jax'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


# The most a full-width bf16 worker on the H100 read at ready and idle, its
# graphs captured (chip_smoke.py phase 15 (g): 6,148.7-6,167.8 MB), and the
# growth of the 2,000-request soak on the card (phase 14 (d): +460.2 MB).
WORKER_READY_RSS_MB = 6167.8
SOAK_GROWTH_MB = 460.2


@pytest.mark.parametrize("rss,recycles", [
    (WORKER_READY_RSS_MB, False),
    (WORKER_READY_RSS_MB + SOAK_GROWTH_MB, False),
    (DEFAULT_RECYCLE_RSS_MB + 1.0, True),
], ids=["ready", "ready+soak_growth", "over_the_bound"])
def test_default_bound_leaves_a_full_width_worker_alone(rss, recycles):
    """A supervisor with the default bound over a fake worker whose RSS
    reads ``rss`` (the supervisor's RSS reader replaced in its process):
    idle through 20 checks, it begins no recycle at the ready figure or
    after the soak's growth, and begins one just over the bound."""
    fake = f"print({READY_MARKER + 'http://x:1'!r}, flush=True); import time; time.sleep(300)"
    code = ("import sys\n"
            "import vqa_tpu_torch.serving.supervisor as s\n"
            f"s.rss_mb = lambda pid: {rss!r}\n"
            "sys.exit(s.main(sys.argv[1:]))\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "--port", "0", "--check-interval", "0.1",
         "--ready-timeout", "60", "--worker-cmd", f"{sys.executable} -u -c \"{fake}\""],
        cwd=REPO, stdout=subprocess.PIPE, text=True)
    events = []
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not any(
                e["supervisor"] == "ready" for e in events):
            line = proc.stdout.readline()
            if line.startswith("{"):
                events.append(json.loads(line))
        time.sleep(2.0)
    finally:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    events += [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    kinds = [e["supervisor"] for e in events]
    ready = [e for e in events if e["supervisor"] == "ready"]
    assert ready and ready[0]["recycle_rss_mb"] == DEFAULT_RECYCLE_RSS_MB, kinds
    assert ("recycle_start" in kinds) is recycles, kinds
    assert proc.returncode == 0


def test_default_bound_is_the_documented_figure():
    """The default, the usage line and the README give one figure, above a
    full-width worker's ready RSS plus the soak's growth."""
    import vqa_tpu_torch.serving.supervisor as sup

    figure = f"--recycle-rss-mb {DEFAULT_RECYCLE_RSS_MB:.0f}"
    assert figure in sup.__doc__
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        readme = f.read()
    assert readme.count("--recycle-rss-mb") == readme.count(figure) >= 1
    assert DEFAULT_RECYCLE_RSS_MB > WORKER_READY_RSS_MB + SOAK_GROWTH_MB
