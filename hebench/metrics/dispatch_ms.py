"""Host ms in the step call a batch (no synchronise), over the traced run's
batches outside the profiled segment."""


def read(rec):
    d = rec.dispatch_ms
    return sum(d) / len(d) if d else None
