"""The transforms' summed least time (harness/roofline.py) over their
summed device time, in percent."""


def read(rec):
    s = rec.summary
    t = s.span_device_s.get("ntt") if s is not None else None
    return 100.0 * s.ntt_bound_s / t if t else None
