"""Timing and profiling utilities (counterpart of troy_tpu/utils/timer.py).

Named accumulating timers with tab-indented, autoscaled duration lines
(ref: src/utils/timer.{h,cpp}, timer.h:18-33), communication byte counters
(timer.h:82) and a TimerOnce scoped timer.  The printed lines are the format
scripts/compare_bench.py parses.

CUDA work is asynchronous, so `tock(name, probe)` first waits for the
probe's device (torch.cuda.synchronize on a CUDA tensor; a CPU tensor is
already computed); without a probe the time is the host's dispatch only.
For kernel-level timelines, profile_trace records a torch.profiler trace.

The port's spans (`span`) name its layers on that trace: the BFV lift,
floor and Shenoy-Kumaresan step, base conversion, the keyswitch's digits
and key dot product, the rescale, the multiply, the keyswitch and the
transforms.  A span's device time is that of the operations launched
inside its host range, its inner spans' included.  The hand-written
kernels' launch counters (each kernel module's LAUNCHES) are read and reset
together by launch_counts / reset_launch_counts.
"""

from __future__ import annotations

import functools
import time

import torch

_recording = torch._C._autograd._profiler_enabled

# A span's range is named "hb.troy.<name>": the benchmark's trace reduction
# (hebench/harness/trace.py) collects the ranges whose names start with
# "hb." and keys these "troy.<name>", apart from its own.
SPAN_PREFIX = "hb.troy."


def _format_duration(ns: float) -> str:
    """ns -> autoscaled string (ref: timer.h:18-33)."""
    if ns < 1e3:
        return f"{ns:.0f} ns"
    if ns < 1e6:
        return f"{ns / 1e3:.2f} us"
    if ns < 1e9:
        return f"{ns / 1e6:.2f} ms"
    return f"{ns / 1e9:.3f} s"


def _sync(probe):
    """Wait until every CUDA tensor in probe (a tensor, or a list, tuple or
    dict of them) is computed."""
    if isinstance(probe, torch.Tensor):
        if probe.is_cuda:
            torch.cuda.synchronize(probe.device)
    elif isinstance(probe, dict):
        for v in probe.values():
            _sync(v)
    elif isinstance(probe, (list, tuple)):
        for v in probe:
            _sync(v)


def profile_trace(log_dir: str):
    """A torch.profiler context over CPU and CUDA activities that writes a
    Chrome trace into log_dir when it exits (view it in Perfetto or
    chrome://tracing), the port's spans on it as hb.troy.<name> ranges."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))


class span:
    """A named range of the port's work on the profiler's trace, as a
    decorator (`@span("lift")`) or around a block (`with span("lift"):`).

    With no torch.profiler session recording, a span is one flag check
    before the call: no record_function, no CUDA event.  Under a session (the
    benchmark's traced segment, profile_trace) it is a record_function
    range on the trace's own clock, beside the device's kernels.  A span
    object used as a block is not shared between threads."""

    def __init__(self, name: str):
        self.name = SPAN_PREFIX + name
        self._open = []

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return spanned

    def __enter__(self):
        rf = None
        if _recording():
            rf = torch.profiler.record_function(self.name)
            rf.__enter__()
        self._open.append(rf)
        return self

    def __exit__(self, *exc):
        rf = self._open.pop()
        if rf is not None:
            rf.__exit__(*exc)
        return False


def _launch_tables() -> tuple:
    from ..ops import bconv_cuda, fused_mul_cuda, ntt_cuda, ntt_mxu_cuda

    return (ntt_cuda.LAUNCHES, ntt_mxu_cuda.LAUNCHES, bconv_cuda.LAUNCHES,
            fused_mul_cuda.LAUNCHES)


def launch_counts() -> dict:
    """The hand-written kernels' launches so far, by counter: the LAUNCHES
    dicts of ops/ntt_cuda.py, ntt_mxu_cuda.py, bconv_cuda.py and
    fused_mul_cuda.py in one dict (their keys are distinct)."""
    counts = {}
    for table in _launch_tables():
        counts.update(table)
    return counts


def reset_launch_counts():
    """Every launch counter back to 0."""
    for table in _launch_tables():
        for k in table:
            table[k] = 0


class TimerOnce:
    """Scoped one-shot timer (ref: timer.h:110)."""

    def __init__(self, name: str = "", print_on_exit: bool = True):
        self.name = name
        self.print_on_exit = print_on_exit
        self.start = time.perf_counter_ns()
        self.elapsed_ns = 0

    def finish(self) -> int:
        self.elapsed_ns = time.perf_counter_ns() - self.start
        if self.print_on_exit:
            print(f"{self.name}: {_format_duration(self.elapsed_ns)}")
        return self.elapsed_ns

    def __enter__(self):
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.finish()
        return False


class Timer:
    """Named accumulating timers (ref: timer.h Timer with registered entries)."""

    def __init__(self):
        self._entries: dict[str, list] = {}  # name -> [total_ns, count, start]
        self._comm: dict[str, int] = {}

    def register(self, name: str) -> str:
        self._entries.setdefault(name, [0, 0, None])
        return name

    def tick(self, name: str):
        e = self._entries.setdefault(name, [0, 0, None])
        e[2] = time.perf_counter_ns()

    def tock(self, name: str, probe=None):
        if probe is not None:
            _sync(probe)
        e = self._entries[name]
        if e[2] is None:
            raise ValueError(f"[Timer.tock] {name} not ticked")
        e[0] += time.perf_counter_ns() - e[2]
        e[1] += 1
        e[2] = None

    def add_communication(self, name: str, nbytes: int):
        self._comm[name] = self._comm.get(name, 0) + nbytes

    # -- printing (parsed by scripts/compare_bench.py) ----------------------
    def print(self, indent: int = 1):
        for name, (total, count, _) in self._entries.items():
            avg = total / max(count, 1)
            print("\t" * indent + f"{name}: {_format_duration(avg)}"
                  f" ({count} runs, total {_format_duration(total)})")

    def print_communication(self, indent: int = 1):
        """ref: timer.h:82"""
        for name, nbytes in self._comm.items():
            mb = nbytes / (1024 * 1024)
            print("\t" * indent + f"{name}: {mb:.3f} MB")

    def clear(self):
        self._entries.clear()
        self._comm.clear()
