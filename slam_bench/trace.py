"""The profiler's trace, reduced to what the per-layer metrics read.

`Trace` holds the device's work items (kernels, copies, fills) and the
harness's host labels (host-clock ranges around the calls into the
program) as plain tuples in seconds on one clock, and the span the trace
covers. `device_events` reads the work items from a finished
`torch.profiler.profile` that recorded the card's activity alone, and
`from_events` puts the host labels on the trace's clock by the marker
kernel that opens the span; the tests build a Trace by hand.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

from slam_bench import stats

# device work in the profiler's activity types
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# the harness's host labels
LABELS = ("restore", "chunk", "extract", "track", "integrate")
# the kernel of torch.cuda._sleep, the marker that opens the span
MARKER = "spin_kernel"
BREAKDOWN_ENTRIES = 10


@dataclass
class Trace:
    device: list = field(default_factory=list)   # (name, kind, start, end)
    labels: list = field(default_factory=list)   # (name, start, end)
    span: tuple = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return self.span[1] - self.span[0]

    def busy_s(self) -> float:
        """Seconds of the span in which some work item ran on the device."""
        return stats.union_seconds(((a, b) for _, _, a, b in self.device),
                                   *self.span)

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def work_items(self) -> int:
        return sum(1 for _, _, a, _ in self.device
                   if self.span[0] <= a < self.span[1])

    def kernel_launches(self, name_part: str):
        """Device seconds of each launch of the kernels whose name holds
        `name_part`."""
        return [b - a for n, k, a, b in self.device
                if k == "kernel" and name_part in n]

    def breakdown(self) -> dict:
        """The device operations that took most time, and the device's
        idle time inside each host label (the innermost label open at the
        middle of each gap; "other" outside every label), largest first."""
        by_op = defaultdict(float)
        for n, _, a, b in self.device:
            by_op[n] += b - a
        labels = sorted(self.labels, key=lambda l: l[1])
        idle = defaultdict(float)
        j, open_ = 0, []          # labels begun before the gap's middle
        for a, b in stats.gaps([(a, b) for _, _, a, b in self.device],
                               *self.span):
            mid = 0.5 * (a + b)
            while j < len(labels) and labels[j][1] <= mid:
                open_.append(labels[j])
                j += 1
            open_ = [l for l in open_ if l[2] > mid]
            idle[open_[-1][0] if open_ else "other"] += b - a
        top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                   key=lambda kv: -kv[1])
                         ][:BREAKDOWN_ENTRIES]
        return {"device_ops": top(by_op), "idle_gaps": top(idle)}


def _kind(name: str) -> str:
    """The profiler's activity type of a device event, from its name."""
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    return "gpu_memset" if name.startswith("Memset") else "kernel"


def device_events(prof):
    """[(name, kind, start, end in seconds)] of the card's work items in
    a finished torch.profiler.profile, in start order."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        a = e.start_ns() * 1e-9
        out.append((e.name(), _kind(e.name()), a, a + e.duration_ns() * 1e-9))
    return sorted(out, key=lambda d: d[2])


def from_events(device, labels, host_span, t_mark) -> Trace:
    """A Trace from the device's work items (trace clock) and the host
    labels and span (host clock), the marker kernel launched at host time
    `t_mark` on an idle card giving the offset between the two clocks (its
    launch latency, microseconds, is the error)."""
    if not device:
        raise RuntimeError("the trace holds no device work")
    mark = next((d for d in device if MARKER in d[0]), device[0])
    off = mark[2] - t_mark
    device = [d for d in device if d is not mark]
    return Trace(device, [(n, a + off, b + off) for n, a, b in labels],
                 (host_span[0] + off, host_span[1] + off))
