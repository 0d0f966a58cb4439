"""Share of the steady window with no operation on the card: 1 less the
device's busy time a batch, from the traced segment, over the steady time
between completions, from the same run's batches outside the segment.

The traced segment's own idle share (`device.busy_s` / `window_s`) carries
the profiler's host cost and the drained edges of the segment; this one
holds the card's work to the pace of the untraced window.  Where the card
sets the pace it reads near 0 and may read a little below it: two
measurements of one time."""


def read(rec):
    s, iv = rec.summary, rec.intervals_ms
    if s is None or s.busy_s <= 0 or not iv:
        return None
    return 100.0 * (1.0 - s.busy_s * 1e3 / s.batches / (sum(iv) / len(iv)))
