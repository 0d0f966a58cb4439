"""The metric arithmetic: a rate is all work over all window time, a tail
is over every batch, and each per-layer reader reads its span."""

import statistics

import pytest

from harness import bench, stats, trace as TR


def rec_with(lat, cts, window, setup=1.5):
    r = bench.Record()
    r.latencies_ms, r.completed_cts, r.window_s, r.setup_s = lat, cts, window, setup
    return r


def test_rate_is_all_work_over_all_time():
    r = rec_with([10.0] * 30, 30 * 64, 0.5)
    assert bench.reader("ct_per_s")(r) == pytest.approx(30 * 64 / 0.5)


def test_p95_over_every_batch():
    lat = [float(i) for i in range(1, 101)]
    r = rec_with(lat, 6400, 5.0)
    expected = statistics.quantiles(lat, n=100, method="inclusive")[94]
    assert bench.reader("batch_ms_p95")(r) == expected
    assert bench.reader("wide_batch_ms_p95")(r) == expected
    # one slow batch among many moves the tail only as its rank says
    lat2 = lat[:-1] + [1e6]
    assert bench.reader("batch_ms_p95")(rec_with(lat2, 6400, 5.0)) == expected


def test_p95_needs_twenty_batches():
    assert stats.p95([1.0] * 19) is None
    assert stats.p95([1.0] * 20) == 1.0


def test_setup_and_dispatch():
    r = rec_with([1.0] * 20, 20, 1.0, setup=12.5)
    r.dispatch_ms = [2.0, 4.0]
    assert bench.reader("setup_s")(r) == 12.5
    assert bench.reader("dispatch_ms")(r) == 3.0


def test_per_layer_readers():
    r = rec_with([1.0] * 20, 20, 1.0)
    s = TR.Summary()
    s.batches, s.kernels, s.window_s, s.busy_s = 4, 700, 0.02, 0.015
    s.span_device_s = {"multiply": 0.008, "keyswitch": 0.004, "ntt": 0.002}
    s.ntt_bound_s = 0.001
    r.summary = s
    r.intervals_ms = [8.0, 12.0]              # 10 ms a batch, steady
    assert bench.reader("launches_per_batch")(r) == 175
    assert bench.reader("multiply.device_ms")(r) == pytest.approx(2.0)
    assert bench.reader("keyswitch.device_ms")(r) == pytest.approx(1.0)
    assert bench.reader("ntt.device_ms")(r) == pytest.approx(0.5)
    assert bench.reader("ntt_roofline")(r) == pytest.approx(50.0)
    # busy 3.75 ms a batch in the trace against 10 ms a batch steady
    assert bench.reader("device_idle_pct")(r) == pytest.approx(62.5)


def test_idle_needs_the_untraced_batches():
    r = rec_with([1.0] * 20, 20, 1.0)
    s = TR.Summary()
    s.batches, s.kernels, s.window_s, s.busy_s = 4, 700, 0.02, 0.015
    r.summary = s
    assert bench.reader("device_idle_pct")(r) is None


def test_steady_intervals_leave_out_the_segment():
    """Intervals between completions count only where both batches ran
    outside the traced segment."""
    rec = bench.Record()
    traffic = {"in_flight": 2, "profile_batches": 3, "batch": 1}
    seen = []

    def segment(body):
        seen.append((len(rec.latencies_ms), len(rec.intervals_ms)))
        body()

    bench.window(lambda x: x, [(1,)], 0.05, traffic, set(), bench.Clock(bench.torch.device("cpu")),
                 rec, segment)
    n = len(rec.latencies_ms)
    before, intervals = seen[0]
    assert n == before + 3 and intervals == before - 1      # the segment comes last
    assert len(rec.intervals_ms) == before - 1              # none of it counts
    assert len(rec.dispatch_ms) == before


def test_readers_find_nothing_without_a_trace():
    r = rec_with([1.0] * 20, 20, 1.0)
    for name in ("launches_per_batch", "multiply.device_ms", "ntt_roofline",
                 "device_idle_pct", "dispatch_ms"):
        assert bench.reader(name)(r) is None
