"""Statistics the metric readers share."""

from __future__ import annotations

import statistics


def p95(values: list[float]) -> float | None:
    """The 95th percentile over every value (statistics.quantiles,
    inclusive); None under 20 values, where no value lies beyond it."""
    if len(values) < 20:
        return None
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def per_batch_ms(rec, span: str) -> float | None:
    """Device ms a batch under a span of the traced segment."""
    s = rec.summary
    if s is None or not s.span_device_s.get(span):
        return None
    return s.span_device_s[span] * 1e3 / s.batches


def batch_p95(rec) -> float | None:
    """95th percentile of a batch's time from dispatch to observed
    completion, over every batch of the window."""
    return p95(rec.latencies_ms)
