#!/usr/bin/env python3
"""CPU rehearsal of chip_smoke.py: every phase, at tiny sizes, on the CPU.

    python3 scripts/torch_smoke_rehearsal.py [--no-profiler]

chip_smoke.py runs only on a GPU.  This script fakes what the CPU lacks and
runs its main() unchanged otherwise, to catch faults in the script's own
logic before a chip call: torch.cuda's availability, synchronize, events,
graphs (a graph just runs its calls) and device name; the device (the
CPU), nvidia-smi's line, the profiler (the CPU profiler sees no device
kernels), ptxas and the build; HeContext.create's default device (the
card) becomes the CPU.  Each kernel's C call is routed to its plain
version (the wrappers' own routing and launch counting stay real, and every
kernel input must be a contiguous int64 tensor, as the kernels need, but
K3's, which may be strided as its wrapper allows); the
dispatch functions to the wrappers; the refusal phase is skipped.  Sizes: n
= 1024 (the BFV, CKKS and BGV phases), batch 2, the large-n phase at n = 4096 in clusters of 4
(the tables' route switches at 2048 here; the yardstick's blocks are of
1024), the security bound lifted for the
quickstart's Classical128; [ring2k] at matmul 4 x 5 x 6, conv2d 1 x 2 x 6
x 6 -> 3 and 2 messages a helper flow; [wide] at n = 1024, batch 2 (its
CPU twin then runs on the same device); [perop] at n = 1024, batch 2, 2
repetitions; [eager] 1 repetition; [examples] with --device cpu at the
twins' own sizes; [mesh] over (data, limb) = (2, 1), (1, 2), (1, 3) at batch
2, its one-rank multihost mesh on gloo; [mxu] at n = 256 .. 8192 on 1 to 3
limbs, the cluster route taking 4096 and 8192 (clusters of 4 and 8 at
4096, of 8 at 8192; the refusals skipped), its timing at (3, 2, n) for n
= 2048, 4096, 8192 and the large step's digits, the large step at 4096
(the C calls of every K2 kernel are their plain version).  Times it prints are the CPU's and
mean nothing.  With --no-profiler every profiler session records no device
kernel, so each profile_step takes its fallback (counts, times nan).
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
                                fused_mul as FM, fused_mul_cuda, _cuda_build, dyadic as D,
                                ntt_mxu as MX, ntt_mxu_cuda)
from troy_tpu_torch.core import coeff_modulus as CM  # noqa: E402

def install_fakes(profiler: bool = True):
    """The fakes above, and the tiny sizes, on chip_smoke and the port;
    profiler False: a profiler that records no device kernel."""
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
    if profiler:
        cs.profile_step = lambda fn, calls: {"launches": 1, "ms": 1.0,
                                             **{k: (1, 0.1) for k in cs.PROFILED}}
    else:
        cs.profiler_kernels = lambda fn, calls: [fn() for _ in range(calls)] and []
        cs.PROFILER_PAUSE_S = 0.0
    ntt_cuda.kernel_info = lambda w, l: {"threads": 1}
    ntt_cuda.cluster_info = lambda inv, l, k, threads=256: {"threads": threads, "clusters": 1}
    fused_mul_cuda.kernel_info = lambda w, l: {"smem": fused_mul_cuda.shared_bytes(l), "clusters": 1}
    fused_mul_cuda.large_info = lambda l, k: {"smem": fused_mul_cuda.large_shared_bytes(l - k),
                                              "clusters": 1}
    _cuda_build.build = lambda: types.SimpleNamespace(name="fake.so")
    _cuda_build.load = lambda: None
    _cuda_build.sources = lambda: []
    cs.phase_refusals = lambda *a: None

    def chk(x):
        assert x.dtype == torch.int64 and x.is_contiguous(), (x.dtype, x.is_contiguous())
    def fake_check(x, t, cluster=True):
        chk(x); assert x.shape[-1] == t.n and x.shape[-2] == t.size and t.block_log_n <= 15
        assert not (cluster and t.split) or (1 << t.split) in NTT.CLUSTER_SIZES
    ntt_cuda._check = fake_check
    def fake_call(name, argtypes, x, t, *args):
        chk(x)
        s = t.split
        return {"troy_ntt_forward": lambda: NTT.ntt_forward_plain(x, t),
                "troy_ntt_inverse": lambda: NTT.ntt_inverse_plain(x % t.q.view(-1, 1), t),
                "troy_ntt_cluster_forward": lambda: NTT.ntt_forward_plain(x, t),
                "troy_ntt_cluster_inverse": lambda: NTT.ntt_inverse_plain(x % t.q.view(-1, 1), t),
                "troy_ntt_blocks_forward": lambda: NTT.forward_stages_plain(x, t, s, t.log_n),
                "troy_ntt_blocks_inverse": lambda: NTT.inverse_stages_plain(x % t.q.view(-1, 1), t, s, t.log_n, False),
                "troy_ntt_columns_forward": lambda: NTT.forward_stages_plain(x, t, 0, s),
                "troy_ntt_columns_inverse": lambda: NTT.inverse_stages_plain(x % t.q.view(-1, 1), t, 0, s, True),
                }[name]()
    ntt_cuda._call = fake_call
    ntt_cuda.run_radix2 = lambda inv, x, t: (NTT.ntt_inverse_plain(x % t.q.view(-1,1), t) if inv else NTT.ntt_forward_plain(x, t))
    def fake_fcheck(a, b, t, polys=2, large=True):
        chk(a); chk(b); assert a.shape[-3] == polys
        assert not (large and t.split) or (t.log_n, t.split) in fused_mul_cuda.LARGE_SHAPES
    fused_mul_cuda._check = fake_fcheck
    def fake_fcall(name, argtypes, a, b, t, *args):
        assert name in ("troy_fused_mul", "troy_fused_mul_large")
        return FM.fused_negacyclic_multiply_plain(a, b, t)
    fused_mul_cuda._call = fake_fcall
    fused_mul_cuda.run_radix2 = lambda a, b, t: FM.fused_negacyclic_multiply_plain(a, b, t)
    def fake_tp(y, t):
        chk(y); fused_mul_cuda.LAUNCHES["tensor_product"] += 1
        return D.dyadic_convolute(y[..., :2, :, :], y[..., 2:, :, :], t)
    fused_mul_cuda.tensor_product = fake_tp
    bconv_cuda._check_device = lambda x, tabs: None
    def fake_bcall(name, x, out, tabs, *args):  # K3 reads strided rows; the first kernel not
        assert x.dtype == torch.int64 and bconv_cuda.row_stride(x, tabs.L_in) is not None
        assert name == "troy_bconv" or x.is_contiguous()
        out.copy_(BC.base_convert_plain(x, tabs))
        return 0
    bconv_cuda._call = fake_bcall
    bconv_cuda.kernel_info = lambda l: {"threads": 128, "regs": 0, "local_bytes": 0, "smem": 0,
                                        "ctas_per_sm": 1, "sms": 132}
    def fake_mxu_check(x, t):
        chk(x); assert x.shape[-1] == t.n and x.shape[-2] == t.size and 8 <= t.log_n <= 17
    ntt_mxu_cuda._check = fake_mxu_check
    def fake_mxu_call(name, x, out, mid, w_left, w_right, t):
        out.copy_(MX.ntt_inverse_mxu(x, t) if "inverse" in name else MX.ntt_forward_mxu(x, t))
        return 0
    ntt_mxu_cuda._call = fake_mxu_call
    def fake_wg_call(name, x, out, t1, t2, twiddle, t):
        assert t.wg_w is not None and t1.dtype == torch.uint8
        return fake_mxu_call(name, x, out, None, t1, t2, t)
    ntt_mxu_cuda._call_wg = fake_wg_call
    def fake_wg_info(inverse, log_n):
        p = MX.wg_plan(log_n, inverse)
        return {"threads": 256, "smem": p["smem"], "regs": 0, "local_bytes": 0,
                "ctas_per_sm": 1, "resident": int(p["resident"]),
                **{k: p[k] for k in ("t1", "t2", "b1", "b2", "staging")}}
    ntt_mxu_cuda.wg_info = fake_wg_info
    def fake_cluster_call(name, x, out, t1, t2, twiddle, t, log_c):
        assert t1.dtype == torch.uint8 and (1 << log_c) * 2 <= t.n
        return fake_mxu_call(name, x, out, None, t1, t2, t)
    ntt_mxu_cuda._call_cluster = fake_cluster_call
    def fake_cluster_plan(t, inverse, log_c=None):
        log_c = MX.CL_SWEEP[t.log_n][0] if log_c is None else log_c
        if t.log_n not in MX.CL_SWEEP or log_c not in MX.CL_SWEEP[t.log_n]:
            raise ValueError(f"[ntt_mxu_cuda] n = {t.n}: no cut in clusters of {1 << log_c} CTAs")
        return {"C": 1 << log_c}
    ntt_mxu_cuda.cluster_plan = fake_cluster_plan
    def fake_cluster_info(inverse, log_n, log_c=None):
        log_c = MX.CL_SWEEP[log_n][0] if log_c is None else log_c
        p = MX.cl_plan(log_n, inverse, log_c)
        return {"threads": 256, "smem": p["smem"], "regs": 0, "local_bytes": 0, "clusters": 3,
                "cluster": p["C"]}
    ntt_mxu_cuda.cluster_info = fake_cluster_info
    ntt_mxu_cuda._wg_route = lambda t: t.log_n <= 11   # the cluster route at 4096 and 8192
    MX.CL_MIN_LOG_N = 12
    MX.CL_SWEEP = {12: (2, 3), 13: (3,)}
    cs.expect_refusals = lambda *a: None
    torch.cuda.get_device_properties = lambda *a: types.SimpleNamespace(multi_processor_count=132)
    ntt_mxu_cuda.kernel_info = lambda w, smem: {"threads": 256, "smem": smem, "regs": 0,
                                                "local_bytes": 0, "ctas_per_sm": 1}
    def route(kernel, mxu_kernel):
        return lambda x, t: (mxu_kernel(x.contiguous(), t.mxu) if getattr(t, "mxu", None)
                             is not None else kernel(x.contiguous(), t))
    NTT.ntt_forward = route(ntt_cuda.ntt_forward, ntt_mxu_cuda.ntt_forward)
    NTT.ntt_inverse = route(ntt_cuda.ntt_inverse, ntt_mxu_cuda.ntt_inverse)
    BC.base_convert = lambda x, t: bconv_cuda.base_convert(bconv_cuda.addressable(x, t.L_in), t)
    FM.fused_negacyclic_multiply = lambda a, b, t: fused_mul_cuda.fused_negacyclic_multiply(
        a.contiguous(), b.contiguous(), t)
    CM.CoeffModulus.max_bit_count = staticmethod(lambda n, s: 10**6)

    cs.N, cs.BATCH, cs.REPS, cs.PLAIN_REPS, cs.GRAPH_LAUNCHES = 1024, 2, 2, 1, 2
    cs.N_LARGE, cs.LARGE_DEGREES = 4096, (4096, 8192)
    cs.CLUSTER_SWEEP = {4096: (3, 2, 1), 8192: (3, 2)}
    NTT.CLUSTER_SPLIT = {12: 2, 13: 3}
    fused_mul_cuda.LARGE_SHAPES = ((12, 2), (13, 3))
    cs.LARGE_BITS = [30] * 5
    cs.K4_DEGREES = (16, 1024)
    cs.RING2K_MATMUL, cs.RING2K_CONV, cs.RING2K_MESSAGES = (4, 5, 6), (1, 2, 3, 6, 6, 3, 3), 2
    cs.MESH_LAYOUTS = ((2, 1), (1, 2), (1, 3))
    NTT.BLOCK_MAX_LOG_N = 11
    ntt_cuda.BLOCK_MAX_LOG_N = 11
    NTT.LARGE_BLOCK_LOG_N = 10
    def small_degrees(dev):
        from troy_tpu_torch.core.modulus import Modulus
        from troy_tpu_torch.utils import numth
        return {1 << l: NTT.NTTTables(l, [Modulus(p) for p in numth.get_primes(2 << l, 30, 2)], dev) for l in range(1, 14)} | {cs.REFUSED_DEGREE: None}
    cs.other_degrees = small_degrees
    cs.PEROP_REPS, cs.EAGER_REPS = {"fast": 2, "wide": 2}, 1
    cs.MXU_DEGREES, cs.MXU_LIMBS, cs.MXU_LARGE = range(8, 14), 3, (11, 12, 13)
    from troy_tpu_torch.core.context import HeContext
    create = HeContext.create  # the context's default device, the card, is the CPU here
    HeContext.create = staticmethod(
        lambda *a, device=None, **k: create(*a, device=device or "cpu", **k))
    examples = cs.phase_examples
    cs.phase_examples = lambda args=(): examples(("--device", "cpu"))


if __name__ == "__main__":
    install_fakes(profiler="--no-profiler" not in sys.argv[1:])
    t0 = time.time()
    rc = cs.main()
    print(f"[rehearsal] main() returned {rc} in {time.time() - t0:.1f} s of CPU time")
    sys.exit(rc)
