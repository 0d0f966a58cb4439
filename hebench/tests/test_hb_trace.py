"""The reduction of a profiler trace: busy and idle time in the segment,
device time by the span that launched it, idle gaps named by the host."""

import pytest

from harness import trace as TR


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def events():
    return [
        ev("user_annotation", "hb.segment", 0, 1000),
        ev("user_annotation", "hb.step", 10, 400),
        ev("user_annotation", "hb.ntt", 20, 50),
        ev("user_annotation", "hb.keyswitch", 100, 200),
        ev("user_annotation", "hb.ntt", 150, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 25, 2, 1),
        ev("cuda_runtime", "cudaLaunchKernel", 155, 2, 2),
        ev("cuda_runtime", "cudaLaunchKernel", 200, 2, 3),
        ev("cuda_runtime", "cudaLaunchKernel", 500, 2, 4),
        ev("kernel", "k_ntt", 100, 100, 1),
        ev("kernel", "k_ntt", 300, 100, 2),
        ev("kernel", "k_dot", 400, 100, 3),
        ev("kernel", "k_other", 700, 100, 4),
    ]


def test_reduce():
    s = TR.reduce(events(), batches=2, ntt_bound_s=50e-6)
    assert s.kernels == 4
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx(400e-6)
    assert s.span_device_s["ntt"] == pytest.approx(200e-6)
    assert s.span_device_s["keyswitch"] == pytest.approx(200e-6)
    assert s.span_device_s["step"] == pytest.approx(300e-6)
    gaps = dict((round(g * 1e6), name) for name, g in s.idle_gaps)
    assert gaps[200] == "harness" and gaps[100] in ("harness", "step")
    assert s.device_ops[0][0] == "k_ntt" and s.device_ops[0][1] == pytest.approx(200e-6)


def test_a_trace_without_its_segment_fails():
    with pytest.raises(RuntimeError):
        TR.reduce([e for e in events() if e["name"] != "hb.segment"], 1, 0.0)


def test_a_silent_span_fails():
    spans = TR.Spans()

    class Obj:
        def multiply(self, x):
            return x

    o = Obj()
    spans.patch(o, "multiply", "multiply")
    spans.uninstall()
    with pytest.raises(RuntimeError):
        spans.check()
    o.multiply(1)
    assert "multiply" not in o.__dict__
