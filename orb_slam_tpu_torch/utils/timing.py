"""Stage timing and profiler traces.

Port of orb_slam_tpu/utils/timing.py: `StageTimer` (:28-63) and
`trace_to` (:92-98). The reference has none (SURVEY.md §5). Where JAX
forces a value back to the host to wait for the device (`force_value`),
the port synchronizes each CUDA device that holds a tensor of the stage's
result. `trace_to` runs torch.profiler with the CPU and, where a card is
visible, the CUDA activity, and writes the chrome trace into `logdir`.
`dispatch_fused` (a one-step `lax.scan` against per-op dispatch cost on a
remote TPU runtime) is JAX-only and not ported.
"""

from __future__ import annotations

import contextlib
import os
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


class StageTimer:
    """Accumulates per-stage wall times (with optional device sync).

    With `sync`, a stage given its `result` waits for the devices that
    hold it; a stage given none waits for the current card at both ends,
    so its time covers the device work it launched (SLAMSystem's stage
    hook, `timer(name)`, times stages that way). Each stage's seconds are
    also appended to `times[name]`."""

    def __init__(self, sync: bool = True, times: dict = None):
        self.sync = sync
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.times = {} if times is None else times

    def __call__(self, name: str):
        return self.stage(name)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        if self.sync and result is None:
            synchronize_card()
        t0 = time.perf_counter()
        yield
        if self.sync:
            if result is None:
                synchronize_card()
            else:
                synchronize_result(result)
        self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        self.totals[name] += seconds
        self.counts[name] += 1
        self.times.setdefault(name, []).append(seconds)

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
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
