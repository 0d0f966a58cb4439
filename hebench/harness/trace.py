"""Spans around the program's layers, installed from the benchmark's own
files for a traced segment only, and the reduction of the profiler's trace
to per-layer numbers.

A span wraps one entry point by replacing the attribute that its callers
look up at call time: the batched step's `multiply` (instance), the
evaluator's `_switch_key_impl` (instance; relinearize and the Galois round
both switch keys through it), and the transforms `ops.ntt.ntt_forward` /
`ntt_inverse` (the fast path's K1 route) and `ops.ntt64.ntt_forward64` /
`ntt_inverse64` (the wide path's torch passes).  Each call counts, opens a
`torch.profiler.record_function` range named `hb.<span>`, and an NTT call
records its shape and width for the roofline.  A span that saw no call
fails the run.

The device time under a span is the sum of the device operations whose
launch (the CUDA runtime call, joined by its correlation id) lies inside
one of the span's host ranges.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import Counter, defaultdict

import torch

PREFIX = "hb."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    def __init__(self):
        self.calls = Counter()
        self.ntt_calls: list[tuple[tuple, bool]] = []
        self._undo = []

    def _wrap(self, name, fn, wide=None):
        def wrapped(*args, **kwargs):
            self.calls[name] += 1
            if wide is not None:
                self.ntt_calls.append((tuple(args[0].shape), wide))
            with torch.profiler.record_function(PREFIX + name):
                return fn(*args, **kwargs)
        return wrapped

    def patch(self, obj, attr: str, name: str, wide=None):
        old = getattr(obj, attr)
        in_dict = attr in getattr(obj, "__dict__", {})
        setattr(obj, attr, self._wrap(name, old, wide))
        self._undo.append((obj, attr, old if in_dict else None))
        self.calls[name] += 0

    def install(self, batched, evaluator, names):
        from troy_tpu_torch.ops import ntt, ntt64
        if "multiply" in names:
            self.patch(batched, "multiply", "multiply")
        if "keyswitch" in names:
            self.patch(evaluator, "_switch_key_impl", "keyswitch")
        if "ntt" in names:
            for mod, wide in ((ntt, False), (ntt64, True)):
                for attr in (("ntt_forward", "ntt_inverse") if not wide
                             else ("ntt_forward64", "ntt_inverse64")):
                    self.patch(mod, attr, "ntt", wide)

    def uninstall(self):
        for obj, attr, old in reversed(self._undo):
            if old is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)
        self._undo.clear()

    def check(self):
        silent = [k for k, v in self.calls.items() if v == 0]
        if silent:
            raise RuntimeError(f"span(s) saw no call: {silent}")


class Summary:
    """Per-layer numbers of one traced segment."""

    def __init__(self):
        self.batches = 0
        self.kernels = 0
        self.port_kernels = 0      # kernels that are not PyTorch's own
        self.window_s = 0.0
        self.busy_s = 0.0
        self.span_device_s: dict[str, float] = {}
        self.ntt_bound_s = 0.0
        self.device_ops: list = []
        self.idle_gaps: list = []


def export_events(prof) -> list[dict]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return data["traceEvents"] if isinstance(data, dict) else data


def reduce(events: list[dict], batches: int, ntt_bound_s: float) -> Summary:
    launches, device, ranges = {}, [], defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args", {})
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = e["ts"]
        elif cat in DEVICE_CATS:
            device.append(e)
        elif cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            ranges[e["name"][len(PREFIX):]].append((e["ts"], e["ts"] + e["dur"]))
    s = Summary()
    s.batches = batches
    seg = ranges.get("segment")
    if not seg:
        raise RuntimeError("the trace holds no segment range")
    t0, t1 = seg[0]
    s.window_s = (t1 - t0) * 1e-6
    device = [e for e in device if e["ts"] + e["dur"] > t0 and e["ts"] < t1]
    s.kernels = sum(e.get("cat") == "kernel" for e in device)
    s.port_kernels = sum(e.get("cat") == "kernel" and "at::native" not in e.get("name", "")
                         for e in device)
    # busy: the union of device intervals inside the segment; gaps between them
    iv = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in device)
    merged = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    s.busy_s = sum(b - a for a, b in merged) * 1e-6
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    if merged:
        gaps += [(t0, merged[0][0]), (merged[-1][1], t1)]
    host = sorted(((a, b, name) for name, rs in ranges.items() if name != "segment"
                   for a, b in rs), key=lambda r: r[0])
    starts = [h[0] for h in host]

    def doing(ts):
        best = None
        for a, b, name in host[max(0, bisect.bisect_right(starts, ts) - 64):
                               bisect.bisect_right(starts, ts)]:
            if a <= ts <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        return best[2] if best else "harness"

    gaps.sort(key=lambda g: g[0] - g[1])
    s.idle_gaps = [[doing(a), (b - a) * 1e-6] for a, b in gaps[:10] if b > a]
    # device time under each span, by the host time of each operation's launch
    for name, rs in ranges.items():
        if name == "segment":
            continue
        rs = sorted(rs)
        lo = [a for a, _ in rs]
        tot = 0.0
        for e in device:
            ts = launches.get(e.get("args", {}).get("correlation"))
            if ts is None:
                continue
            i = bisect.bisect_right(lo, ts) - 1
            if i >= 0 and ts <= rs[i][1]:
                tot += e["dur"]
        s.span_device_s[name] = tot * 1e-6
    by_name = Counter()
    for e in device:
        by_name[e.get("name", "?")] += e["dur"] * 1e-6
    s.device_ops = [[k, v] for k, v in by_name.most_common(10)]
    s.ntt_bound_s = ntt_bound_s
    return s
