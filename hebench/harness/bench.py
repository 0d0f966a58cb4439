"""One run of one cell: set-up, the measured window, the traced segment,
the correctness check and the result line.

The window is a closed loop with `in_flight` batches on the card: batch i+1
is dispatched while batch i runs, then the harness waits for batch i.  A
batch's latency runs from the host's dispatch to the moment its completion
is observed.  Dispatch stops once `seconds` have passed; the batches in
flight are then waited for, and the window ends at the last completion.  So
the rate is every ciphertext completed over the whole window, and the tail
is over every batch.

With trace on, the window runs as without trace, and `dispatch_ms` and the
steady time between completions are read from its batches; then a segment
of `profile_batches` more batches runs under torch.profiler with the spans
of trace.py installed (the batches in flight drained at both ends).  The
segment comes last because the profiler slows the host's dispatch for a
while after it has stopped.

What belongs to one operation, scheme or metric is a file found by name:
ops/<op>.<scheme>.py (an operation under one scheme: its switching keys,
timed step, spans, expected message and plain reference), schemes/<scheme>.py
(messages, fresh encryptions, the numbers the check compares) and
metrics/<name>.py (a reader of Record).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import random
import sys
import time
from collections import deque
from pathlib import Path

import torch

from . import judge as J
from . import reference as REF
from . import roofline, trace as TR
from .scheme import Config, Keys, Sampler

HERE = Path(__file__).resolve().parents[1]      # the benchmark's folder
FORBIDDEN = ("jax", "jaxlib", "flax", "troy_tpu")


def found(folder: str, name: str):
    """The module of hebench/<folder>/<name>.py."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {folder}/{name}.py in {HERE.name}/")
    spec = importlib.util.spec_from_file_location(f"hebench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    return found("metrics", name).read


class Spec:
    """A workload of BENCHMARK.json with its configuration, traffic,
    operation, scheme, limits and metrics, found by name.  A scheme or an
    operation under it that has no file fails here, at set-up."""

    def __init__(self, workload: str, trace: bool = False, config_overrides=None,
                 traffic_overrides=None):
        root = HERE.parent
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
        if cell is None:
            raise SystemExit(f"unknown workload {workload}")
        conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
        self.name = workload
        self.cfg = Config.load(root / conf["file"], config_overrides)
        self.traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
        self.traffic.update(traffic_overrides or {})
        scheme = self.cfg.scheme.lower()
        self.scheme = found("schemes", scheme)
        self.op = found("ops", f"{self.traffic['op']}.{scheme}")
        self.limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
        group = bench["per_layer"] if trace else bench["end_to_end"]
        self.metrics = [m for m in group if workload in m.get("workloads", [workload])]

    def out_ring(self, device):
        return REF.out_ring(self.cfg, self.op.LEVELS_DROPPED, device)


class Record:
    """What the metric readers read."""

    def __init__(self):
        self.setup_s = 0.0
        self.window_s = 0.0
        self.completed_cts = 0
        self.latencies_ms: list[float] = []
        self.dispatch_ms: list[float] = []
        self.intervals_ms: list[float] = []     # between completions, untraced
        self.summary: TR.Summary | None = None


class Clock:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def wait(self, ev):
        if ev is not None:
            ev.synchronize()

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()


def sample(seed: int, traffic: dict) -> tuple[set, list[int]]:
    """Batch ordinals whose outputs are judged (and the last batch besides),
    and the ciphertexts judged in each: one from each of `judged_per_batch`
    equal strata of the batch."""
    rng = random.Random(seed * 2654435761 + 97)
    keep = set(rng.sample(range(traffic["min_batches"]), traffic["judged_batches"]))
    B, k = traffic["batch"], traffic["judged_per_batch"]
    idx = [rng.randrange(i * B // k, (i + 1) * B // k) for i in range(k)]
    return keep, idx


def window(run, inputs, seconds: float, traffic: dict, keep: set, clock: Clock,
           rec: Record, segment=None) -> dict:
    """Returns the outputs of the kept batch ordinals and of the last batch."""
    depth, D, n_seg = traffic["in_flight"], len(inputs), traffic["profile_batches"]
    kept, inflight, skip = {}, deque(), set()
    t_end, latest = 0.0, None

    def complete():
        nonlocal t_end, latest
        i, td, out, ev = inflight.popleft()
        clock.wait(ev)
        t_prev, t_end = t_end, time.perf_counter()
        if i > 0 and not {i - 1, i} & skip:
            rec.intervals_ms.append((t_end - t_prev) * 1e3)
        rec.latencies_ms.append((t_end - td) * 1e3)
        rec.completed_cts += traffic["batch"]
        latest = (i, out)
        if i in keep:
            kept[i] = out

    def drain():
        while inflight:
            complete()

    def dispatch(i, span=False):
        td = time.perf_counter()
        if span:
            with torch.profiler.record_function(TR.PREFIX + "step"):
                out = run(*inputs[i % D])
        else:
            out = run(*inputs[i % D])
        ev = clock.mark()
        if i not in skip:
            rec.dispatch_ms.append((time.perf_counter() - td) * 1e3)
        inflight.append((i, td, out, ev))
        if len(inflight) >= depth:
            complete()

    def body():
        for k in range(i, i + n_seg):
            dispatch(k, span=True)
        drain()

    t0, i = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        dispatch(i)
        i += 1
    if segment is not None:
        drain()
        skip.update(range(i, i + n_seg))
        segment(body)
    drain()
    rec.window_s = t_end - t0
    kept[latest[0]] = latest[1]
    return kept


def make_segment(port, names, clock: Clock, rec: Record, batches: int):
    """A function that runs a body of batches under the profiler with spans."""

    from troy_tpu_torch.ops import bconv_cuda, ntt_cuda

    def counted():
        return sum(ntt_cuda.LAUNCHES.values()) + sum(bconv_cuda.LAUNCHES.values())

    def run_segment(body):
        spans = TR.Spans()
        for attempt in range(3):
            before = counted()
            spans.install(port.batched, port.evaluator, names)
            try:
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                        torch.profiler.ProfilerActivity.CUDA]) \
                        as prof:
                    with torch.profiler.record_function(TR.PREFIX + "segment"):
                        body()
                        clock.sync()
            finally:
                spans.uninstall()
            spans.check()
            bound = sum(roofline.ntt_bound_s(shape, wide) for shape, wide in spans.ntt_calls)
            summary = TR.reduce(TR.export_events(prof), batches, bound)
            if summary.kernels:
                rec.summary = summary
                print(f"[hebench] segment: {summary.kernels} kernels in the trace, "
                      f"{summary.port_kernels} of them the port's; its K1 and K3 "
                      f"counters {counted() - before}", file=sys.stderr)
                return
            print(f"[hebench] profiler recorded no kernel (attempt {attempt + 1})",
                  file=sys.stderr)
            spans = TR.Spans()
        raise RuntimeError("the profiler recorded no kernel in three segments")

    return run_segment


def prepare(spec: Spec, seed: int, device):
    """Keys, switching keys, messages and input batches from the seed, in
    one fixed order of draws."""
    traffic, scheme = spec.traffic, spec.scheme
    keys = Keys(spec.cfg, Sampler(seed, device))
    switch = spec.op.switch_keys(keys, traffic)
    msgs, inputs = [], []
    for _ in range(traffic["distinct_batches"]):
        ms = tuple(scheme.messages(keys, traffic["batch"]) for _ in range(spec.op.ARITY))
        msgs.append(ms)
        inputs.append(tuple(scheme.encrypt(keys, m) for m in ms))
    return keys, switch, msgs, inputs


def check(spec: Spec, keys, msgs, outs: dict, idx: list[int]) -> J.Verdict:
    """Judge the rows `idx` of the outputs of some batch ordinals: `outs`
    maps an ordinal to those rows of its output."""
    D = spec.traffic["distinct_batches"]
    order = sorted(outs)
    sel = torch.tensor(idx, device=outs[order[0]].device)
    parts = [tuple(m.index_select(0, sel) for m in msgs[o % D]) for o in order]
    ms = tuple(torch.cat([p[j] for p in parts]) for j in range(len(parts[0])))
    expect = spec.op.expected(spec.cfg, spec.traffic, ms)
    return J.judge(spec.scheme, spec.out_ring(sel.device), keys,
                   torch.cat([outs[o] for o in order]), expect, spec.limits)


def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: float | None = None, fault=None,
        config_overrides=None, traffic_overrides=None) -> tuple[dict, J.Verdict]:
    """One run: the result line and the verdict behind its `correct`.  A
    fault (faults.py) is planted under the timed step by the check's control
    and tests, never by a run of the benchmark."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = Spec(workload, trace, config_overrides, traffic_overrides)
    cfg, traffic = spec.cfg, spec.traffic
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(0)
    clock = Clock(device)

    # -- set-up: keys and inputs from the seed, the port, the warm-up --------
    from .port import DEFAULT_NTT_BACKEND, Port
    marks = [("start", time.perf_counter())]
    keys, switch, msgs, inputs = prepare(spec, seed, device)
    clock.sync()
    marks.append(("keys and inputs", time.perf_counter()))
    port = Port(cfg, device, traffic.get("ntt_backend", DEFAULT_NTT_BACKEND))
    step = spec.op.step(port, traffic, switch)
    marks.append(("context and tables", time.perf_counter()))
    run_step = step if fault is None else fault(step)
    for _ in range(2):
        for inp in inputs:
            run_step(*inp)
    clock.sync()
    marks.append(("warm-up", time.perf_counter()))
    print("[hebench] set-up: imports %.2f s, " % (marks[0][1] - t_start) +
          ", ".join(f"{name} {b - a:.2f} s" for (_, a), (name, b) in zip(marks, marks[1:])),
          file=sys.stderr)
    keep, idx = sample(seed, traffic)
    rec = Record()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    segment = (make_segment(port, spec.op.SPANS, clock, rec, traffic["profile_batches"])
               if trace else None)
    gc.collect()
    gc.freeze()      # set-up's objects leave the collector's scans in the window
    rec.setup_s = time.perf_counter() - t_start

    # -- the window ---------------------------------------------------------
    kept = window(run_step, inputs, seconds, traffic, keep, clock, rec, segment)
    clock.sync()
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0

    # -- the check, with the program's state freed ---------------------------
    sel = torch.tensor(idx, device=device)
    kept = {i: out.index_select(0, sel) for i, out in kept.items()}
    del port, step, run_step, switch, inputs
    if device.type == "cuda":
        torch.cuda.empty_cache()
    verdict = check(spec, keys, msgs, kept, idx)

    # -- the result line ------------------------------------------------------
    metrics = {}
    for m in spec.metrics:
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": verdict.correct,
              "attempted": rec.completed_cts,
              "failed": verdict.failed,
              "metrics": metrics, "device": dev}
    if trace and rec.summary is not None:
        dev["busy_s"] = rec.summary.busy_s
        dev["window_s"] = rec.summary.window_s
        result["breakdown"] = {"device_ops": rec.summary.device_ops,
                               "idle_gaps": rec.summary.idle_gaps}
    result["checks"] = {k: {"value": v, "limit": verdict.limits[k]}
                        for k, v in verdict.numbers.items()}
    return result, verdict


def loaded_forbidden() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
