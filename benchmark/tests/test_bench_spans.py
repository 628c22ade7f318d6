"""The system's spans on the device timeline (`harness/program_spans.py`), on
the CPU: a synthetic trace and a synthetic record, aligned through the
marker; the idle split by the innermost span; the launch-stamp causality
check; and a system without a recorder, which reads as None."""
import sys
import types

import pytest

from harness import program_spans, spec, trace

T0_NS = 1_800_000_000_000_000_000  # the host stamp after the first marker's launch
MARKER_US = 100.0  # the first marker's device start
END_US = 400.0  # the second marker's, where the profiler stopped


class _E:
    def __init__(self, name, s, t):
        from torch.autograd import DeviceType

        self.name, self.device_type = name, DeviceType.CUDA
        self.time_range = type("R", (), {"start": s, "end": t})()


def ns(us):
    """A host stamp that the marker puts at `us` on the timeline."""
    return T0_NS + round((us - MARKER_US) * 1e3)


def timeline(marker_at=MARKER_US, pool_at=200.0, markers=(MARKER_US, END_US)):
    ev = [_E("void at::cuda::(anonymous namespace)::spin_kernel(long)", m + marker_at - MARKER_US,
             m + marker_at - MARKER_US + 1) for m in markers]
    ev += [_E("void warp_crop_kernel<1, float, 4>()", 130, 150),
           _E("elementwise_kernel", 150, 160),
           _E("void maxpool3x3s2_kernel<bf16, 8>()", pool_at, pool_at + 20),
           _E("Memcpy DtoH (Device -> Pinned)", 260, 270), _E("elementwise_kernel", 300, 310)]
    return trace.Timeline(ev, 1)


def record(pool_stamp=195.0):
    def sp(name, parent, a, b):
        return {"name": name, "parent": parent, "seq": 0, "start_ns": ns(a), "end_ns": ns(b)}

    return {"spans": [sp("serve.predict", None, 105, 250), sp("serve.to_device", 0, 106, 180),
                      sp("serve.forward", 0, 180, 240), sp("int8.weights", 2, 190, 195)],
            "counts": [{"name": "int8.weight_bytes", "n": 3_000_000, "seq": 0}],
            "launches": [{"kernel": "metro_warp_crop", "t_ns": ns(120), "seq": 0},
                         {"kernel": "metro_maxpool3x3s2", "t_ns": ns(pool_stamp), "seq": 0}],
            "marker": "spin_kernel",
            "anchors": [{"before_ns": T0_NS - 4000, "after_ns": T0_NS},
                        {"before_ns": ns(END_US) - 2000, "after_ns": ns(END_US)}]}


def test_nested_spans_keep_their_self_time():
    spans = [{"name": "a", "parent": None, "start": 0, "end": 10},
             {"name": "b", "parent": 0, "start": 2, "end": 5},
             {"name": "c", "parent": 1, "start": 3, "end": 4},
             {"name": "d", "parent": 0, "start": 5, "end": 9}]
    assert program_spans.self_pieces(spans) == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"),
                                                (4, 5, "b"), (5, 9, "d"), (9, 10, "a")]


def test_idle_split_by_the_innermost_span():
    s = program_spans.Session(record(), timeline())
    idle_us = s.idle
    # [101, 130]: client 4, serve.predict 1, serve.to_device 24
    # [160, 200] straddles to_device (20) and forward (10 + 5), int8.weights 5 inside it
    # [220, 260]: forward 20, serve.predict's own 10, client 10; [270, 300] and [310, 400]
    # (before the second marker) in no span
    assert idle_us == pytest.approx({"client": 134, "serve.predict": 11, "serve.to_device": 44,
                                     "serve.forward": 35, "int8.weights": 5})
    tl = timeline()
    assert sum(s.idle.values()) == pytest.approx(tl.window_s * 1e6 - tl.busy_s * 1e6)
    assert s.idle_ms("serve.forward") == pytest.approx(0.035)
    assert s.idle_ms(program_spans.CLIENT) == pytest.approx(0.134)
    assert s.host_ms("serve.to_device") == pytest.approx(0.074)
    assert s.host_ms("int8.weights") == pytest.approx(0.005)
    assert s.count("int8.weight_bytes") == 3_000_000
    assert s.launches_per_iteration() == 2
    with pytest.raises(RuntimeError, match="no span 'train.augment'"):
        s.idle_ms("train.augment")
    with pytest.raises(RuntimeError, match="counted no"):
        s.count("other")


def test_the_markers_anchor_the_host_clock():
    # the same record against a trace whose markers ran 7 us later: every host
    # time moves with them, and the stamps keep their margins to the kernels
    s = program_spans.Session(record(), timeline())
    later = program_spans.Session(record(pool_stamp=188.0), timeline(marker_at=MARKER_US + 7))
    assert later.spans[0]["start"] == pytest.approx(s.spans[0]["start"] + 7)
    assert s.margins == pytest.approx({"metro_warp_crop": 10.0, "metro_maxpool3x3s2": 5.0})
    assert later.margins["metro_maxpool3x3s2"] == pytest.approx(5.0)
    assert s.rate == pytest.approx(1.0) and s.anchor_call_us == pytest.approx(4.0)
    for markers in ((), (MARKER_US,), (MARKER_US, 300.0, END_US)):
        with pytest.raises(RuntimeError, match=f"{len(markers)} clock markers"):
            program_spans.Session(record(), timeline(markers=markers))
    with pytest.raises(RuntimeError, match="no clock anchor"):
        program_spans.Session(dict(record(), anchors=[]), timeline())


def test_the_second_marker_corrects_the_rate():
    # the trace's clock runs 1% slow against the host's: the second marker sits
    # at 397 us, not 400; a stamp at host 300 us lies at 298 on the trace
    s = program_spans.Session(record(), timeline(markers=(MARKER_US, 397.0)))
    assert s.rate == pytest.approx(0.99)
    assert s.launches[1][1] == pytest.approx(MARKER_US + 95 * 0.99)
    assert s.margins["metro_maxpool3x3s2"] == pytest.approx(200 - (MARKER_US + 95 * 0.99))
    # a session read while it still records has one anchor: offset alone
    one = dict(record(), anchors=record()["anchors"][:1])
    assert program_spans.Session(one, timeline(markers=(MARKER_US,))).rate == 1.0


def test_a_launch_stamp_after_its_kernels_start_fails():
    with pytest.raises(RuntimeError, match="before their launch stamps"):
        program_spans.Session(record(pool_stamp=205.0), timeline())


def test_root_spans_must_be_the_traced_iterations():
    r = record()
    r["spans"].append(dict(r["spans"][0], seq=1, start_ns=ns(280), end_ns=ns(290)))
    with pytest.raises(RuntimeError, match="2 root spans in a trace of 1"):
        program_spans.Session(r, timeline())
    with pytest.raises(RuntimeError, match="no span"):
        program_spans.Session(dict(record(), spans=[]), timeline())


SPAN_METRICS = [m["name"] for m in spec.benchmark()["per_layer"]
                if hasattr(spec.module("metrics", m["name"]), "program_spans")]


def _rec(name):
    return types.SimpleNamespace(kind="serve" if name.endswith(".serve") else "train",
                                 timeline=timeline())


def test_thirteen_metrics_read_the_spans():
    assert len(SPAN_METRICS) == 13


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_system_without_a_recorder_reads_none(monkeypatch, name):
    monkeypatch.setitem(sys.modules, program_spans.RECORDER, types.ModuleType("no_recorder"))
    assert spec.module("metrics", name).read(_rec(name)) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_recorder_that_recorded_nothing_fails_the_read(monkeypatch, name):
    fake = types.ModuleType("recorder")
    fake.recorded = lambda: dict(record(), spans=[])
    monkeypatch.setitem(sys.modules, program_spans.RECORDER, fake)
    with pytest.raises(RuntimeError, match="no span"):
        spec.module("metrics", name).read(_rec(name))
