"""95th percentile of a batch's time from dispatch to observed completion,
over every batch of the window (cells on the fast 30-bit path)."""

from harness.stats import batch_p95 as read  # noqa: F401
