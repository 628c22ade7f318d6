"""The traced run's device timeline, from `torch.profiler` (CUPTI).

The traced run measures its window untraced, then runs a segment of
`wait` + 2 + `active` iterations of the same loop under the profiler, which
records the device's activity only (recording the host's operations too
slowed the host so much that the device idled half of the time). It traces
without keeping the first `wait` + 2 iterations (its first trace of a
ctypes-launched kernel may miss launches) and records the last `active`.
The traced window runs from the first recorded device operation's start to
the last one's end."""
from __future__ import annotations

WARMUP = 2


def tracer(wait: int, active: int):
    """-> (profiler, holder): holder["events"] is filled when the recorded
    iterations end."""
    from torch.profiler import ProfilerActivity, profile, schedule

    holder = {}

    def ready(p):
        holder["events"] = list(p.events())

    prof = profile(activities=[ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=wait + WARMUP, active=active, repeat=1),
                   on_trace_ready=ready)
    return prof, holder


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Timeline:
    """The device operations of `iterations` traced iterations; times in
    microseconds on the profiler's clock."""

    def __init__(self, events, iterations: int):
        from torch.autograd import DeviceType

        # the profiler may mirror host annotations onto the device's
        # timeline; they are no device work
        self.device = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                             if e.device_type == DeviceType.CUDA
                             and not getattr(e, "is_user_annotation", False))
        if not self.device:
            raise RuntimeError("the trace holds no device operation")
        self.iterations = iterations
        self.t0 = self.device[0][0]
        self.t1 = max(t for _, t, _ in self.device)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self):
        return _merge([(s, t) for s, t, _ in self.device])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernels(self, predicate=lambda name: True):
        return [d for d in self.device if predicate(d[2])]

    def time_s(self, predicate) -> float:
        return sum(t - s for s, t, _ in self.kernels(predicate)) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, and the device's
        idle time summed by the operation the host launched to end it: the
        host was getting to that launch while the device waited."""
        by_name, gaps = {}, {}
        for s, t, n in self.device:
            by_name[n] = by_name.get(n, 0.0) + (t - s) / 1e6
        starts = [d[0] for d in self.device]
        names = [d[2] for d in self.device]
        busy = self.busy_intervals()
        for (_, end), (nxt, _) in zip(busy, busy[1:]):
            label = "before " + names[starts.index(nxt)][:150]
            gaps[label] = gaps.get(label, 0.0) + (nxt - end) / 1e6
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": [[n[:160], v] for n, v in order(by_name)],
                "idle_gaps": [[n, v] for n, v in order(gaps)]}
