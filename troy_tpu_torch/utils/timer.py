"""Timing and profiling utilities (counterpart of troy_tpu/utils/timer.py).

Named accumulating timers with tab-indented, autoscaled duration lines
(ref: src/utils/timer.{h,cpp}, timer.h:18-33), communication byte counters
(timer.h:82) and a TimerOnce scoped timer.  The printed lines are the format
scripts/compare_bench.py parses.

CUDA work is asynchronous, so `tock(name, probe)` first waits for the
probe's device (torch.cuda.synchronize on a CUDA tensor; a CPU tensor is
already computed); without a probe the time is the host's dispatch only.
For kernel-level timelines, profile_trace records a torch.profiler trace.
"""

from __future__ import annotations

import time

import torch


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
    chrome://tracing)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))


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
