#!/usr/bin/env python3
"""CPU rehearsal of chip_smoke.py: every phase, at tiny sizes, on the CPU.

    python3 scripts/torch_smoke_rehearsal.py

chip_smoke.py runs only on a GPU.  This script fakes what the CPU lacks and
runs its main() unchanged otherwise, to catch faults in the script's own
logic before a chip call: torch.cuda's availability, synchronize, events,
graphs (a graph just runs its calls) and device name; the device (the
CPU), nvidia-smi's line, the profiler (the CPU profiler sees no device
kernels), ptxas and the build.  Each kernel's C call is routed to its plain
version (the wrappers' own routing and launch counting stay real, and every
kernel input must be a contiguous int64 tensor, as the kernels need); the
dispatch functions to the wrappers; the refusal phase is skipped.  Sizes: n
= 1024 (the BFV, CKKS and BGV phases), batch 2, the large-n phase at n = 4096 with blocks of 1024 (the
tables' route switches at 2048 here), the security bound lifted for the
quickstart's Classical128; [ring2k] at matmul 4 x 5 x 6, conv2d 1 x 2 x 6
x 6 -> 3 and 2 messages a helper flow; [wide] at n = 1024, batch 2 (its
CPU twin then runs on the same device).  Times it prints are the CPU's and
mean nothing.
"""
import contextlib
import sys
import time
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from troy_tpu_torch.ops import (ntt as NTT, ntt_cuda, bconv as BC, bconv_cuda,  # noqa: E402
                                fused_mul as FM, fused_mul_cuda, _cuda_build, dyadic as D)
from troy_tpu_torch.core import coeff_modulus as CM  # noqa: E402

def install_fakes():
    """The fakes above, and the tiny sizes, on chip_smoke and the port."""
    torch.cuda.is_available = lambda: True
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.get_device_name = lambda *a: "fake"
    torch.cuda.device_count = lambda: 1
    class Ev:
        def __init__(self, **k): self.t = 0
        def record(self, *a): self.t = time.perf_counter()
        def elapsed_time(self, o): return (o.t - self.t) * 1e3
    torch.cuda.Event = Ev
    class G:
        def replay(self): [f() for f in self.fns]
    torch.cuda.CUDAGraph = G
    @contextlib.contextmanager
    def graph(g, **k):
        g.fns = []
        yield
    torch.cuda.graph = graph
    cs.cuda_device = lambda: torch.device("cpu")
    cs.gpu_line = lambda: "fake GPU, 700.00 W"
    cs.ptxas_report = lambda p: None
    cs.ptxas_start = lambda s: None
    cs.profile_step = lambda fn, calls: {"launches": 1, "ms": 1.0, **{k: (1, 0.1) for k in cs.PROFILED}}
    ntt_cuda.kernel_info = lambda w, l: {"threads": 1}
    fused_mul_cuda.kernel_info = lambda w, l: {"smem": fused_mul_cuda.shared_bytes(l), "clusters": 1}
    _cuda_build.build = lambda: types.SimpleNamespace(name="fake.so")
    _cuda_build.load = lambda: None
    _cuda_build.sources = lambda: []
    cs.phase_refusals = lambda *a: None

    def chk(x):
        assert x.dtype == torch.int64 and x.is_contiguous(), (x.dtype, x.is_contiguous())
    def fake_check(x, t):
        chk(x); assert x.shape[-1] == t.n and x.shape[-2] == t.size and t.block_log_n <= 15
    ntt_cuda._check = fake_check
    def fake_call(name, argtypes, x, t, *args):
        chk(x)
        s = t.split
        return {"troy_ntt_forward": lambda: NTT.ntt_forward_plain(x, t),
                "troy_ntt_inverse": lambda: NTT.ntt_inverse_plain(x % t.q.view(-1, 1), t),
                "troy_ntt_blocks_forward": lambda: NTT.forward_stages_plain(x, t, s, t.log_n),
                "troy_ntt_blocks_inverse": lambda: NTT.inverse_stages_plain(x % t.q.view(-1, 1), t, s, t.log_n, False),
                "troy_ntt_columns_forward": lambda: NTT.forward_stages_plain(x, t, 0, s),
                "troy_ntt_columns_inverse": lambda: NTT.inverse_stages_plain(x % t.q.view(-1, 1), t, 0, s, True),
                }[name]()
    ntt_cuda._call = fake_call
    ntt_cuda.run_radix2 = lambda inv, x, t: (NTT.ntt_inverse_plain(x % t.q.view(-1,1), t) if inv else NTT.ntt_forward_plain(x, t))
    def fake_fcheck(a, b, t, polys=2):
        chk(a); chk(b); assert a.shape[-3] == polys
    fused_mul_cuda._check = fake_fcheck
    def fake_fcall(name, argtypes, a, b, t, table, *extra):
        return FM.fused_negacyclic_multiply_plain(a, b, t)
    fused_mul_cuda._call = fake_fcall
    fused_mul_cuda.run_radix2 = lambda a, b, t: FM.fused_negacyclic_multiply_plain(a, b, t)
    def fake_tp(y, t):
        chk(y); fused_mul_cuda.LAUNCHES["tensor_product"] += 1
        return D.dyadic_convolute(y[..., :2, :, :], y[..., 2:, :, :], t)
    fused_mul_cuda.tensor_product = fake_tp
    def fake_bconv(x, tabs):
        chk(x); bconv_cuda.LAUNCHES["base_convert"] += 1
        return BC.base_convert_plain(x, tabs)
    bconv_cuda.base_convert = fake_bconv
    NTT.ntt_forward = lambda x, t: ntt_cuda.ntt_forward(x, t)
    NTT.ntt_inverse = lambda x, t: ntt_cuda.ntt_inverse(x, t)
    BC.base_convert = lambda x, t: bconv_cuda.base_convert(x, t)
    FM.fused_negacyclic_multiply = lambda a, b, t: fused_mul_cuda.fused_negacyclic_multiply(a, b, t)
    CM.CoeffModulus.max_bit_count = staticmethod(lambda n, s: 10**6)

    cs.N, cs.BATCH, cs.REPS, cs.PLAIN_REPS, cs.GRAPH_LAUNCHES = 1024, 2, 2, 1, 2
    cs.N_LARGE, cs.LARGE_DEGREES, cs.SPLIT_BLOCKS = 4096, (4096, 8192), (9, 10, 11)
    cs.LARGE_BITS = [30] * 5
    cs.K4_DEGREES = (16, 1024)
    cs.RING2K_MATMUL, cs.RING2K_CONV, cs.RING2K_MESSAGES = (4, 5, 6), (1, 2, 3, 6, 6, 3, 3), 2
    NTT.BLOCK_MAX_LOG_N = 11
    ntt_cuda.BLOCK_MAX_LOG_N = 11
    NTT.LARGE_BLOCK_LOG_N = 10
    def small_degrees(dev):
        from troy_tpu_torch.core.modulus import Modulus
        from troy_tpu_torch.utils import numth
        return {1 << l: NTT.NTTTables(l, [Modulus(p) for p in numth.get_primes(2 << l, 30, 2)], dev) for l in range(1, 14)} | {cs.REFUSED_DEGREE: None}
    cs.other_degrees = small_degrees


if __name__ == "__main__":
    install_fakes()
    t0 = time.time()
    rc = cs.main()
    print(f"[rehearsal] main() returned {rc} in {time.time() - t0:.1f} s of CPU time")
    sys.exit(rc)
