"""The program's own spans in the trace: ranges named hb.troy.<span>, which
the reduction keys troy.<span> beside the harness's spans, and the seven
readers of their device time."""

import pytest

from harness import bench, trace as TR

from test_hb_trace import ev, events

READERS = {"lift.device_ms": "troy.lift", "floor.device_ms": "troy.floor",
           "sk.device_ms": "troy.sk", "bconv.device_ms": "troy.bconv",
           "ks_digits.device_ms": "troy.ks_digits", "ks_inner.device_ms": "troy.ks_inner",
           "rescale.device_ms": "troy.rescale"}


def with_program_spans():
    """The fixture of test_hb_trace with the program's ranges nested in the
    harness's: a keyswitch inside hb.keyswitch holding its key dot product
    (launch 3, and the start of the 200-300 gap) and a transform inside
    hb.ntt (launch 2); a multiply that launched nothing."""
    return events() + [
        ev("user_annotation", "hb.troy.keyswitch", 105, 190),
        ev("user_annotation", "hb.troy.ks_inner", 190, 50),
        ev("user_annotation", "hb.troy.ntt", 152, 16),
        ev("user_annotation", "hb.troy.multiply", 600, 50),
    ]


def test_program_spans_add_keys_and_change_none():
    old = TR.reduce(events(), batches=2, ntt_bound_s=50e-6)
    new = TR.reduce(with_program_spans(), batches=2, ntt_bound_s=50e-6)
    for k, v in old.span_device_s.items():
        assert new.span_device_s[k] == v
    for attr in ("batches", "kernels", "port_kernels", "window_s", "busy_s", "ntt_bound_s",
                 "device_ops"):
        assert getattr(new, attr) == getattr(old, attr), attr
    assert new.span_device_s["troy.keyswitch"] == pytest.approx(200e-6)
    assert new.span_device_s["troy.ks_inner"] == pytest.approx(100e-6)
    assert new.span_device_s["troy.ntt"] == pytest.approx(100e-6)
    assert new.span_device_s["troy.multiply"] == 0.0
    # the same gaps, the one that starts inside the key dot product named by it
    assert sorted(g for _, g in new.idle_gaps) == sorted(g for _, g in old.idle_gaps)
    named = {round(g * 1e6): name for name, g in new.idle_gaps if name.startswith("troy.")}
    assert named == {100: "troy.ks_inner"}


def test_program_span_readers():
    r = bench.Record()
    s = TR.Summary()
    s.batches = 4
    s.span_device_s = {"keyswitch": 0.004, "troy.multiply": 0.0}
    s.span_device_s.update({span: 0.001 * (i + 1) for i, span in enumerate(READERS.values())})
    r.summary = s
    for i, name in enumerate(READERS):
        assert bench.reader(name)(r) == pytest.approx(0.25 * (i + 1)), name
    # a program without the spans (or a span that launched nothing) reads nothing
    s.span_device_s = {"keyswitch": 0.004, "troy.lift": 0.0}
    assert all(bench.reader(name)(r) is None for name in READERS)
    r.summary = None
    assert all(bench.reader(name)(r) is None for name in READERS)
