"""Stage timing and profiler traces.

Port of orb_slam_tpu/utils/timing.py: `StageTimer` (:28-63) and
`trace_to` (:92-98). The reference has none (SURVEY.md §5). Where JAX
forces a value back to the host to wait for the device (`force_value`),
the port synchronizes each CUDA device that holds a tensor of the stage's
result. `trace_to` runs torch.profiler with the CPU and, where a card is
visible, the CUDA activity, and writes the chrome trace into `logdir`.
`dispatch_fused` (a one-step `lax.scan` against per-op dispatch cost on a
remote TPU runtime) is JAX-only and not ported.

Beyond the JAX timer, `StageTimer` is the program's tracer: `span()`
times a block without ever synchronizing, every stage and span nests
under the innermost one open on its thread (for self times, and for the
span records `keep_spans` keeps), and `count()` keeps counters.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import torch


def synchronize_result(result):
    """Wait for the devices that hold the tensors of `result` (a tensor,
    or a list, tuple, dict or dataclass of them)."""
    devices = set()

    def walk(x):
        if torch.is_tensor(x):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "__dataclass_fields__"):
            for name in x.__dataclass_fields__:
                walk(getattr(x, name))

    walk(result)
    for d in devices:
        torch.cuda.synchronize(d)


def synchronize_card():
    """Wait for the current CUDA device, where there is one."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class _Open:
    """A stage or span open on one thread: its record's index, its frame
    id and the seconds its children took so far."""

    __slots__ = ("index", "frame", "child_s")

    def __init__(self, index, frame):
        self.index, self.frame, self.child_s = index, frame, 0.0


class StageTimer:
    """Accumulates per-stage wall times (with optional device sync).

    With `sync`, a stage given its `result` waits for the devices that
    hold it; a stage given none waits for the current card at both ends,
    so its time covers the device work it launched (SLAMSystem's stage
    hook, `timer(name)`, times stages that way). A span (`span(name)`)
    never waits for a device, whatever `sync` is. Each stage's and span's
    seconds are appended to `times[name]`, summed into `totals[name]` and
    counted in `counts[name]`; its self time, the seconds its children on
    the same thread did not cover, is summed into `self_totals[name]`.
    With `keep_spans`, `spans` keeps one record per stage or span, in the
    order they began: (name, parent index or None, frame id, thread id,
    start, end), the clock `time.perf_counter()`; a stage or span given
    no frame id takes its parent's. `count(name, value)` appends a value
    to `counters[name]`, a list that `times[name]` holds too (a counter
    never shares a stage's or span's name), so a caller that hands the
    timer its `times` reads the counters there beside the seconds. Safe
    to share between threads."""

    def __init__(self, sync: bool = True, times: dict = None,
                 keep_spans: bool = False):
        self.sync = sync
        self.totals = defaultdict(float)
        self.self_totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.times = {} if times is None else times
        self.counters = {}
        self.stage_names = set()
        self.spans = [] if keep_spans else None
        self._open = threading.local()
        self._lock = threading.Lock()

    def __call__(self, name: str):
        return self.stage(name)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        self.stage_names.add(name)
        if self.sync and result is None:
            synchronize_card()
        with self._timed(name, None):
            yield
            if self.sync:
                if result is None:
                    synchronize_card()
                else:
                    synchronize_result(result)

    def span(self, name: str, frame=None):
        """Time the block under `name` for `frame` (by default the frame
        of the span it nests in); never synchronizes."""
        return self._timed(name, frame)

    @contextlib.contextmanager
    def _timed(self, name, frame):
        stack = self._open.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        if frame is None and parent is not None:
            frame = parent.frame
        index = None
        if self.spans is not None:
            with self._lock:
                index = len(self.spans)
                self.spans.append(None)
        node = _Open(index, frame)
        stack.append(node)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            stack.pop()
            if parent is not None:
                parent.child_s += t1 - t0
            self.record(name, t1 - t0, t1 - t0 - node.child_s)
            if index is not None:
                self.spans[index] = (name, None if parent is None else parent.index,
                                     frame, threading.get_ident(), t0, t1)

    def record(self, name: str, seconds: float, self_s: float = None):
        with self._lock:
            self.totals[name] += seconds
            self.self_totals[name] += seconds if self_s is None else self_s
            self.counts[name] += 1
            self.times.setdefault(name, []).append(seconds)

    def count(self, name: str, value=1):
        """Append `value` (one event's count) to `counters[name]`, which
        is `times[name]`."""
        with self._lock:
            if name not in self.counters:
                self.counters[name] = self.times.setdefault(name, [])
            self.counters[name].append(value)

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "self_s": round(self.self_totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1000 * self.totals[name] / max(self.counts[name], 1), 3),
            }
            for name in sorted(self.totals)
        }

    def __str__(self):
        return "\n".join(
            f"{k:30s} {v['mean_ms']:9.3f} ms x{v['count']}"
            for k, v in self.summary().items()
        )


@contextlib.contextmanager
def trace_to(logdir: str):
    """torch.profiler trace of the block, written to
    `logdir/trace.json` (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
