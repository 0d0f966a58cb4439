"""Kernel launches a batch, from the profiler's kernels in the segment."""


def read(rec):
    s = rec.summary
    return s.kernels / s.batches if s is not None and s.kernels else None
