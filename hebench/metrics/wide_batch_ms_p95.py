"""The same tail as batch_ms_p95, for cells on the wide (40-60-bit) path,
whose batches are 19 times longer: a bound of its own."""

from harness.stats import batch_p95 as read  # noqa: F401
