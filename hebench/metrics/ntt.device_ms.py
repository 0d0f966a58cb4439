"""Device ms a batch of the operations launched inside the 'ntt' span."""

from harness.stats import per_batch_ms


def read(rec):
    return per_batch_ms(rec, "ntt")
