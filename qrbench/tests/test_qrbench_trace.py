"""Reading a profiler trace: device operations joined to the host spans
that launched them, the busy union, the idle gaps by host activity."""

import pytest

from qrbench import spans, tracing


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


EVENTS = [
    _ev("user_annotation", tracing.WINDOW, 0, 100),
    _ev("user_annotation", spans.label("m.f", 0), 10, 20),
    _ev("user_annotation", spans.label("m.f", 1), 50, 10),
    _ev("cpu_op", "aten::mm", 12, 5),
    _ev("cuda_runtime", "cudaLaunchKernel", 13, 1, correlation=7),
    _ev("cuda_runtime", "cudaLaunchKernel", 52, 1, correlation=8),
    _ev("cuda_runtime", "cudaLaunchKernel", 80, 1, correlation=9),
    _ev("kernel", "k1", 20, 10, tid=7, correlation=7),
    _ev("kernel", "k2", 55, 15, tid=7, correlation=8),
    _ev("gpu_memcpy", "copy", 82, 4, tid=7, correlation=9),
    _ev("cpu_op", "aten::add", 40, 8),
]


def test_ops_are_joined_to_the_spans_that_launched_them():
    tr = tracing.read(EVENTS)
    assert tr.window == (0, 100) and tr.window_s == pytest.approx(1e-4)
    assert {o.name: o.launch for o in tr.ops} == {"k1": 13, "k2": 52,
                                                  "copy": 80}
    got = tr.ops_in([0, 1])
    assert [o.name for o in got[0]] == ["k1"]
    assert [o.name for o in got[1]] == ["k2"]
    assert tr.busy_s() == pytest.approx(29e-6)
    assert tr.busy_s(got[1]) == pytest.approx(15e-6)


def test_breakdown():
    tr = tracing.read(EVENTS)
    assert tr.top_ops(2) == [["k2", pytest.approx(15e-6)],
                             ["k1", pytest.approx(10e-6)]]
    gaps = dict(tr.idle_gaps())
    # [0, 20) mid 10: the span m.f; [30, 55) mid 42.5: aten::add;
    # [70, 82) mid 76 and [86, 100) mid 93: nothing
    assert gaps == {"m.f": pytest.approx(20e-6),
                    "aten::add": pytest.approx(25e-6),
                    "python": pytest.approx(26e-6)}


def test_span_labels_round_trip():
    assert spans.parse_label(spans.label("a.b.c", 12)) == ("a.b.c", 12)
    assert spans.parse_label("aten::mm") is None


def test_a_trace_of_cuda_activity_alone_spans_its_runtime_calls():
    """Without CPU activity the trace holds no annotation: the window runs
    from the first runtime call to the last event."""
    bare = [e for e in EVENTS if e["cat"] not in ("user_annotation",
                                                  "cpu_op")]
    bare.append(_ev("cuda_runtime", "cudaDeviceSynchronize", 86, 3))
    tr = tracing.read(bare)
    assert tr.window == (13, 89)
    assert tr.busy_s() == pytest.approx(29e-6)
    assert tr.host == []


def test_idle_share_is_the_device_time_a_call_against_the_untraced_call():
    """1.5 ms of device time a traced call against 2 ms a call untraced."""
    from qrbench import cell

    tr = tracing.read(EVENTS)     # 29 us busy over 2 traced calls
    view = type("V", (), {"trace": tr, "calls": 2,
                          "untraced": (10, 10 * 29e-6)})()
    for name in ("device.idle_share", "device.idle_share.wide"):
        mod = cell.load_metric(name)
        assert mod.HOST_OPS is False
        assert mod.read(view) == pytest.approx(50.0)
