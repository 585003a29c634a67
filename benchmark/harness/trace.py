"""A traced sub-window: device activity from `torch.profiler`, reduced.

`Traced` runs a block under `torch.profiler.profile`, with device activity
only (`cpu=False`: the profiler then adds less host work of its own to the
dispatch) or host activity too, inside a user annotation
`bench.trace_window`, synchronising the device before the annotation
closes. `summary` then reads the profiler's raw events once:

- device operations (kernels, copies, sets), each an interval, clipped to
  the window: the annotation's where the profiler recorded it, else the
  host clock's length from the first device operation on (on the H100 a
  device-only profiler records host annotations in some processes and
  none in others); `busy_s` is the length of their union, `window_s` the
  window's;
- the time of each device operation summed by name (`by_name`, seconds,
  and `launches`, counts);
- the idle gaps between device operations, each named by the innermost
  `bench.*` host annotation open at the gap's middle (`idle: <name>`, or
  `idle: other host work`), summed by that name.

`breakdown` gives the contract's `{"device_ops": [...], "idle_gaps": [...]}`,
ten entries at most each.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "bench.trace_window"


class Traced:
    """`window()` around a block, or `start()` and `stop()`, from the thread
    that set the profiler up."""

    def __init__(self, cpu: bool = False):
        self.cpu = cpu
        self.prof = None
        self._annotation = None
        self._t0 = 0.0
        self.host_s = 0.0
        self.reason = ""  # why `summary` read nothing

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if self.cpu else [])
        self.prof = profile(activities=activities)
        self.prof.start()
        self._t0 = time.perf_counter()
        self._annotation = record_function(WINDOW)
        self._annotation.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._annotation.__exit__(None, None, None)
        self.host_s = time.perf_counter() - self._t0
        self.prof.stop()

    @contextlib.contextmanager
    def window(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def summary(self) -> Optional[dict]:
        """None when the profiler saw no device operation."""
        events = self.prof.profiler.kineto_results.events()
        cpu = torch.autograd.DeviceType.CPU
        win = [e for e in events if e.name() == WINDOW and e.device_type() == cpu]
        if win:
            w0, w1 = win[0].start_ns(), win[0].end_ns()
        else:  # every device event lies in the window, of the host's length
            seen = [e for e in events if e.device_type() != cpu]
            w0 = min((e.start_ns() for e in seen), default=0)
            w1 = w0 + int(self.host_s * 1e9)
        device: List[Tuple[int, int, str]] = []
        host: List[Tuple[int, int, str]] = []
        for e in events:
            if e.device_type() == cpu:
                if e.name().startswith("bench.") and e.name() != WINDOW:
                    host.append((e.start_ns(), e.end_ns(), e.name()))
                continue
            if e.name().startswith("bench.") or _annotation(e):
                continue  # a host annotation mirrored on the device's timeline
            a, b = max(e.start_ns(), w0), min(e.end_ns(), w1)
            if b > a:
                device.append((a, b, e.name()))
        if not device:
            seen = [e for e in events if e.device_type() != cpu]
            self.reason = (f"{len(seen)} device events recorded, none inside the window "
                           f"[{w0}, {w1}] ns" + (f" (theirs span [{min(e.start_ns() for e in seen)}"
                                                 f", {max(e.end_ns() for e in seen)}])"
                                                 if seen else ""))
            return None
        device.sort()
        by_name: Dict[str, float] = {}
        launches: Dict[str, int] = {}
        for a, b, name in device:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
            launches[name] = launches.get(name, 0) + 1
        busy_ns, gaps = 0, []
        cur_a, cur_b = device[0][0], device[0][1]
        if cur_a > w0:
            gaps.append((w0, cur_a))
        for a, b, _ in device[1:]:
            if a > cur_b:
                busy_ns += cur_b - cur_a
                gaps.append((cur_b, a))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        busy_ns += cur_b - cur_a
        if w1 > cur_b:
            gaps.append((cur_b, w1))
        starts, names = _innermost(host)
        idle: Dict[str, float] = {}
        for a, b in gaps:
            i = bisect.bisect_right(starts, (a + b) // 2) - 1
            name = "idle: " + (names[i] if i >= 0 and names[i] else "other host work")
            idle[name] = idle.get(name, 0.0) + (b - a) / 1e9
        return dict(busy_s=busy_ns / 1e9, window_s=(w1 - w0) / 1e9, by_name=by_name,
                    launches=launches, idle=idle)


def profiled(block, cpu: bool = False, tries: int = 3):
    """(summary, reason, what `block()` returned) of `block` run under a
    `Traced` window; a window in which the profiler saw no device operation
    (seen now and then on the H100) is run again, up to `tries` windows."""
    for _ in range(tries):
        t = Traced(cpu=cpu)
        with t.window():
            out = block()
        summary = t.summary()
        if summary is not None:
            break
    return summary, t.reason, out


def _annotation(event) -> bool:
    flag = getattr(event, "is_user_annotation", None)
    return bool(flag and flag())


def _innermost(spans: List[Tuple[int, int, str]]) -> Tuple[List[int], List[str]]:
    """The timeline of the shortest open span: segment starts and the name
    open from each ("" where none is)."""
    marks = sorted([(a, 1, i) for i, (a, _, _) in enumerate(spans)]
                   + [(b, 0, i) for i, (_, b, _) in enumerate(spans)])
    open_, starts, names = set(), [], []
    for t, is_start, i in marks:
        (open_.add if is_start else open_.discard)(i)
        inner = min(open_, key=lambda j: spans[j][1] - spans[j][0]) if open_ else None
        starts.append(t)
        names.append(spans[inner][2] if inner is not None else "")
    return starts, names


def named(summary: dict) -> bool:
    """Whether some idle gap of the summary lies under a host annotation."""
    return any(k != "idle: other host work" for k in summary["idle"])


def breakdown(summary: dict, idle: Optional[dict] = None) -> dict:
    """The ten costliest device operations of `summary`, and its ten
    longest idle gaps by name, or those of `idle` where given."""
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:10]
    ops = [(n if len(n) <= 120 else n[:117] + "...", t) for n, t in ops]
    gaps = sorted((idle or summary["idle"]).items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def kernel_base(name: str) -> str:
    """The function's own identifier in a device operation's name: `se_bf16`
    of `void (anonymous namespace)::se_bf16((anonymous namespace)::Params)`,
    `cross_attention_bf16` of `void ...::cross_attention_bf16<32, 1>(...)`,
    `elementwise_kernel` of `void at::native::elementwise_kernel<128, 4,
    ...(...)>(...)`; the name itself where it has no such identifier."""
    text = name.replace("(anonymous namespace)", "").replace("->", "  ")
    depth, head = 0, text
    for i, ch in enumerate(text):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            head = text[:i]
            break
    if head.endswith(">"):  # the function's template arguments
        depth = 0
        for i in range(len(head) - 1, -1, -1):
            depth += {">": 1, "<": -1}.get(head[i], 0)
            if depth == 0:
                head = head[:i]
                break
    m = re.search(r"([A-Za-z_]\w*)$", head)
    return m.group(1) if m else name


def kernel_time(summary: dict, names) -> Tuple[float, int]:
    """(seconds, launches) of the device operations whose function is one
    of `names`, compared whole (`kernel_base`)."""
    s = n = 0
    for name, t in summary["by_name"].items():
        if kernel_base(name) in names:
            s += t
            n += summary["launches"][name]
    return s, n
