#!/usr/bin/env python3
"""Where the time goes in the port's BFV multiply + relinearize step on a GPU.

    python3 scripts/torch_stage_profile.py

Runs the flagship step of troy_tpu_torch (n = 8192, 7 x 30-bit chain, batch
16, as chip_smoke.py) and reports:

  * per-stage times by CUDA events, each stage run on its own over `reps`
    chained repetitions: the forward NTTs, the HPS lift, the tensor product,
    the inverse NTTs, the fast floor, and the keyswitch (digit NTT, key dot,
    special-prime division);
  * a torch.profiler table of device time by kernel over a few steps: the
    kernel launches per step, the device kernel time per step, and its
    share of the event-timed step (the device's busy share).

Needs one CUDA device; imports nothing of jax.
"""

from __future__ import annotations

import pathlib
import sys
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the flagship configuration and helpers)

REPS = 20


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_stage_profile: no CUDA device", file=sys.stderr)
        return 1
    from troy_tpu_torch.ops import ntt as NTT, u32 as U, dyadic as D
    from troy_tpu_torch.core.evaluator import Evaluator
    from troy_tpu_torch.core.keygen import KeyGenerator
    from troy_tpu_torch.parallel.batched import BatchedEvaluator

    def say(msg=""):
        print(msg, flush=True)

    dev = chip_smoke.cuda_device()
    gpu = chip_smoke.gpu_line()
    ctx = chip_smoke.build_context(dev)
    cd = ctx.first_context_data()
    ev = Evaluator(ctx)
    batched = BatchedEvaluator(ev, cd)
    tool, qtab = cd.rns_tool, cd.qtab()
    btab = tool.bsk_ntt
    L, n, B = cd.coeff_modulus_size, chip_smoke.N, chip_smoke.BATCH
    keys = KeyGenerator(ctx, torch.Generator(device=dev).manual_seed(1)) \
        .create_relin_keys().key(2)
    gen = torch.Generator(device=dev).manual_seed(2)

    def res(shape, t):
        return torch.randint(0, 1 << 62, shape, generator=gen, device=dev) \
            % t.q.view(-1, 1)

    d1, d2 = res((B, 2, L, n), qtab), res((B, 2, L, n), qtab)
    step = batched.build_mul_relin_step(keys)
    for _ in range(3):
        step(d1, d2, keys)

    x_b = tool.fast_b_conv_hps(d1)
    a_q, a_b = NTT.ntt_forward(d1, qtab), NTT.ntt_forward(x_b, btab)
    t3_q, t3_b = D.dyadic_convolute(a_q, a_q, qtab), D.dyadic_convolute(a_b, a_b, btab)
    d_q, d_b = NTT.ntt_inverse(t3_q, qtab), NTT.ntt_inverse(t3_b, btab)
    prod = tool.fast_floor_scale_fast_b_conv_sk(d_q, d_b)
    sw = ev._switch_tables(cd)
    otab = sw["otab"]
    target = prod[:, 2]
    digits = target[..., :, None, :].expand(B, L, L + 1, n).contiguous()
    dig_ntt = NTT.ntt_forward(digits, otab)
    keys_sel = keys[:L][:, :, sw["idx"], :]

    def key_dot():
        return U.dot_mod([(dig_ntt[:, i, None], keys_sel[i]) for i in range(L)],
                         otab.q.view(-1, 1))


    stages = [
        ("step (mul + relin), whole", lambda: step(d1, d2, keys), 1),
        ("forward NTT base q, 2 operands", lambda: NTT.ntt_forward(d1, qtab), 2),
        ("HPS lift q -> Bsk, 2 operands", lambda: tool.fast_b_conv_hps(d1), 2),
        ("forward NTT base Bsk, 2 operands", lambda: NTT.ntt_forward(x_b, btab), 2),
        ("tensor product q + Bsk", lambda: (D.dyadic_convolute(a_q, a_q, qtab),
                                            D.dyadic_convolute(a_b, a_b, btab)), 1),
        ("inverse NTT q + Bsk", lambda: (NTT.ntt_inverse(t3_q, qtab),
                                         NTT.ntt_inverse(t3_b, btab)), 1),
        ("fast floor + SK conversion", lambda: tool.fast_floor_scale_fast_b_conv_sk(
            d_q, d_b), 1),
        ("keyswitch: digits expand", lambda: target[..., :, None, :].expand(
            B, L, L + 1, n).contiguous(), 1),
        ("keyswitch: digit forward NTT", lambda: NTT.ntt_forward(digits, otab), 1),
        ("keyswitch: key inner product", key_dot, 1),
        ("keyswitch: inverse NTTs + division", lambda: ev._switch_key_impl(
            cd, target, keys), 0),
        ("relinearize, whole", lambda: batched.relinearize(prod, keys), 1),
    ]
    say(f"{gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"batch {B}, n {n}, L {L}, |Bsk| {btab.size}; CUDA events, {REPS} reps")
    whole = None
    for name, fn, mult in stages:
        fn()
        ms = chip_smoke.cuda_ms(fn, REPS) * max(mult, 1)
        if whole is None:
            whole = ms
        tag = "" if mult else " (includes the digit NTT and key dot)"
        say(f"  {name:40s} {ms:9.4f} ms  {100 * ms / whole:6.1f}%{tag}")

    def profile(fn, calls):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        return events, [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                        and not e.is_user_annotation]

    steps = 5
    events, kernels = profile(lambda: step(d1, d2, keys), steps)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    ntt_ms = sum(e.self_device_time_total for e in kernels if "ntt_" in e.key) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    say(f"profiler, {steps} steps: {launches:.0f} kernel launches and {dev_ms:.4f} ms "
        f"of device kernel time per step ({ntt_ms:.4f} ms in the NTT kernels); "
        f"device busy share of the event-timed step {100 * dev_ms / whole:.1f}%")
    say(events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))

    # The kernels alone at (B, L, n) over base q: device time per launch, and
    # the device-memory rate it implies (one int64 load and store per value).
    x_q = d1[:, 0].contiguous()
    moved = 2 * x_q.numel() * x_q.element_size()
    for name, fn in (("ntt_forward", lambda: NTT.ntt_forward(x_q, qtab)),
                     ("ntt_inverse", lambda: NTT.ntt_inverse(x_q, qtab))):
        _, ks = profile(fn, REPS)
        us = sum(e.self_device_time_total for e in ks) / REPS
        say(f"profiler, {name} at {tuple(x_q.shape)}: {us:.3f} us device time per "
            f"launch, {moved / us / 1e6:.4f} TB/s of int64 in and out")

    return 0


if __name__ == "__main__":
    sys.exit(main())
