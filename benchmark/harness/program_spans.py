"""The spans, counters and kernel launch stamps that the system records inside
itself (`metro_pose3d_tpu_torch/utils/profiling.py`), put on the traced
segment's device timeline.

This is the second module of the benchmark that touches the system, after
`harness/program.py`, and it touches the system's recorder only. It imports
nothing of the system: it reads the recorder module that the system has
loaded (`sys.modules`), so that a system without a recorder reads as None
and the metrics that need it are left out of the line.

Alignment. The recorder stamps the host's Unix clock (`time.time_ns()`);
the timeline holds device times in microseconds from the profiler's start,
on a clock whose offset and rate against the host's differ from session to
session. At a session's first record, and again where the profiler stops,
the recorder drains the card and launches a marker kernel between two host
stamps. Host times are put on the timeline by the line through the two
markers: each marker's device start is taken as the stamp after its launch,
so the launch latency that the start carries is partly covered by the time
the launch call took to return.

Causality. After alignment no port kernel may start on the device before its
host launch stamp. The n-th stamp of a kernel entry point is paired with the
n-th run of that kernel on the device after the marker: one stream runs
launches in their order, and a run the profiler missed only pairs later runs
with earlier stamps. A kernel that starts before its stamp fails the read.

The split. Each device idle interval of the traced window (a gap between the
merged busy intervals that `Timeline.busy_s` counts) is shared among the
host's spans by time overlap, each instant going to the innermost span open
then; what falls in no span goes to CLIENT, the harness's own loop (`fetch`,
`collect`). The parts sum to the window's idle time."""
from __future__ import annotations

import sys
import weakref

RECORDER = "metro_pose3d_tpu_torch.utils.profiling"
CLIENT = "client"
# a port kernel's C entry point -> a part of its kernel's name in the trace
KERNELS = {"metro_maxpool3x3s2": "maxpool3x3s2_kernel",
           "metro_maxpool3x3s2_bwd": "maxpool3x3s2_bwd_kernel",
           "metro_warp_crop": "warp_crop_kernel",
           "metro_occluder_paste": "occluder_paste_kernel",
           "metro_int8_conv": "int8_conv_",
           "metro_int8_elementwise": "int8_elementwise_kernel"}

_SESSIONS = weakref.WeakKeyDictionary()  # timeline -> Session


def system_record():
    """The system's record of its last profiler session, or None where the
    system has no recorder."""
    mod = sys.modules.get(RECORDER)
    if mod is None or not hasattr(mod, "recorded"):
        return None
    return mod.recorded()


def self_pieces(spans: list) -> list:
    """[(start, end, name)], sorted: each span's interval less its
    children's, the host's innermost span at each instant. `spans` are dicts
    with `start`, `end`, `name`, `parent` (an index into `spans` or None),
    nested as one thread opens and closes them."""
    children = {}
    for i, s in enumerate(spans):
        children.setdefault(s["parent"], []).append(i)
    out = []
    for i, s in enumerate(spans):
        t = s["start"]
        for c in sorted(children.get(i, []), key=lambda c: spans[c]["start"]):
            if spans[c]["start"] > t:
                out.append((t, spans[c]["start"], s["name"]))
            t = max(t, spans[c]["end"])
        if s["end"] > t:
            out.append((t, s["end"], s["name"]))
    return sorted(out)


def idle_intervals(timeline) -> list:
    busy = timeline.busy_intervals()
    return [(end, nxt) for (_, end), (nxt, _) in zip(busy, busy[1:])]


def split_idle(idle: list, pieces: list) -> dict:
    """{name: idle time} of sorted disjoint idle intervals over sorted
    disjoint host pieces; time in no piece goes to CLIENT."""
    out = {CLIENT: 0.0}
    j = 0
    for a, b in idle:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        covered, k = 0.0, j
        while k < len(pieces) and pieces[k][0] < b:
            part = min(b, pieces[k][1]) - max(a, pieces[k][0])
            if part > 0:
                out[pieces[k][2]] = out.get(pieces[k][2], 0.0) + part
                covered += part
            k += 1
        out[CLIENT] += (b - a) - covered
    return out


def launch_margins(launches: list, device: list, after: float) -> dict:
    """{entry point: smallest device start less its aligned launch stamp},
    each stamp paired in order with its kernel's runs that start at or
    after `after` (the marker)."""
    out = {}
    for entry, name in KERNELS.items():
        stamps = sorted(t for k, t in launches if k == entry)
        runs = [s for s, _, n in device if name in n and s >= after]
        margins = [run - stamp for stamp, run in zip(stamps, runs)]
        if margins:
            out[entry] = min(margins)
    return out


class Session:
    """The record on the timeline's clock, in microseconds."""

    def __init__(self, record: dict, timeline):
        if any(s["end_ns"] is None for s in record["spans"]):
            raise RuntimeError("a span of the traced session never closed")
        if not record["spans"]:
            raise RuntimeError("the system recorded no span in the traced segment")
        anchors = record["anchors"]
        if not anchors:
            raise RuntimeError("the system's record has no clock anchor")
        marks = [s for s, _, n in timeline.device if record["marker"] in n]
        if len(marks) != len(anchors):
            raise RuntimeError(f"{len(marks)} clock markers ({record['marker']}) in the trace "
                               f"for {len(anchors)} anchors")
        self.marker = marks[0]
        self.anchor_call_us = max(a["after_ns"] - a["before_ns"] for a in anchors) / 1e3
        host0 = anchors[0]["after_ns"]
        # device us a host us: 1 with one anchor (a session still recording)
        self.rate = 1.0 if len(anchors) == 1 else \
            (marks[-1] - marks[0]) / ((anchors[-1]["after_ns"] - host0) / 1e3)

        def us(t_ns):
            return (t_ns - host0) / 1e3 * self.rate + self.marker

        self.spans = [dict(s, start=us(s["start_ns"]), end=us(s["end_ns"]))
                      for s in record["spans"]]
        self.roots = sum(s["parent"] is None for s in self.spans)
        self.iterations = timeline.iterations
        if self.roots != self.iterations:
            raise RuntimeError(f"{self.roots} root spans in a trace of {self.iterations} "
                               "iterations")
        self.counts = record["counts"]
        self.launches = [(x["kernel"], us(x["t_ns"])) for x in record["launches"]]
        self.margins = launch_margins(self.launches, timeline.device, self.marker)
        late = {k: m for k, m in self.margins.items() if m < 0}
        if late:
            raise RuntimeError(f"port kernels start on the device before their launch "
                               f"stamps (us): {late}")
        self.idle = split_idle(idle_intervals(timeline), self_pieces(self.spans))

    def names(self) -> set:
        return {s["name"] for s in self.spans}

    def need(self, name: str) -> None:
        if name not in self.names():
            raise RuntimeError(f"the system recorded no span {name!r} in the traced segment")

    def host_ms(self, name: str) -> float:
        """Host ms an iteration inside spans named `name`."""
        self.need(name)
        return sum(s["end_ns"] - s["start_ns"] for s in self.spans if s["name"] == name) \
            / 1e6 / self.iterations

    def idle_ms(self, name: str) -> float:
        """Device idle ms an iteration with the host innermost in `name`."""
        if name != CLIENT:
            self.need(name)
        return self.idle.get(name, 0.0) / 1e3 / self.iterations

    def count(self, name: str) -> float:
        """The counter `name` an iteration."""
        got = [c["n"] for c in self.counts if c["name"] == name]
        if not got:
            raise RuntimeError(f"the system counted no {name!r} in the traced segment")
        return sum(got) / self.iterations

    def launches_per_iteration(self) -> float:
        if not self.launches:
            raise RuntimeError("the system stamped no port kernel launch in the traced segment")
        return len(self.launches) / self.iterations


def session(rec):
    """The traced run's Session, or None where the system has no recorder
    (or the run was not traced)."""
    if rec.timeline is None:
        return None
    if rec.timeline not in _SESSIONS:
        record = system_record()
        if record is None:
            return None
        _SESSIONS[rec.timeline] = Session(record, rec.timeline)
    return _SESSIONS[rec.timeline]
