#!/usr/bin/env python3
"""Where the time goes in the port's BFV multiply + relinearize step on a GPU.

    python3 scripts/torch_stage_profile.py

Runs the flagship step of troy_tpu_torch (n = 8192, 7 x 30-bit chain, batch
16, as chip_smoke.py) under both lifts, HPS and BEHZ, and reports:

  * per-stage times by CUDA events, each stage run on its own over REPS
    chained repetitions: the forward NTTs, the HPS lift, the BEHZ lift and
    its base conversion (K3), the tensor product, the inverse NTTs, the fast
    floor and its K3 conversions, and the keyswitch (digit NTT, key dot,
    special-prime division);
  * a torch.profiler table of device time by kernel over a few steps of each
    lift: the kernel launches per step, the device kernel time per step (in
    all, in the NTT kernels, in K3), and its share of the event-timed step
    (the device's busy share);
  * each hand-written kernel alone at its flagship shapes: device time per
    launch by the profiler, and the device-memory rate it implies (one int64
    load per input value and one store per output value).

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
    from troy_tpu_torch.ops import (ntt as NTT, u32 as U, dyadic as D, bconv as BC,
                                    fused_mul as FM)
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
    behz = BatchedEvaluator(Evaluator(ctx, lift="behz"), cd)
    tool, qtab = cd.rns_tool, cd.qtab()
    btab = tool.bsk_ntt
    L, n, B = cd.coeff_modulus_size, chip_smoke.N, chip_smoke.BATCH
    keys = KeyGenerator(ctx, torch.Generator(device=dev).manual_seed(1)) \
        .create_relin_keys().key(2)
    gen = torch.Generator(device=dev).manual_seed(2)

    def res(shape, t):
        return chip_smoke.residues(shape, t.q, gen)

    d1, d2 = res((B, 2, L, n), qtab), res((B, 2, L, n), qtab)
    step = batched.build_mul_relin_step(keys)
    behz_step = behz.build_mul_relin_step(keys)
    for _ in range(3):
        step(d1, d2, keys)
        behz_step(d1, d2, keys)

    x_b = tool.fast_b_conv_hps(d1)
    x_scaled = U.mul_mod(d1, 1 << 16, qtab.q.view(-1, 1))
    a_q, a_b = NTT.ntt_forward(d1, qtab), NTT.ntt_forward(x_b, btab)
    t3_q, t3_b = D.dyadic_convolute(a_q, a_q, qtab), D.dyadic_convolute(a_b, a_b, btab)
    d_q, d_b = NTT.ntt_inverse(t3_q, qtab), NTT.ntt_inverse(t3_b, btab)
    y_B = res((B, 3, tool.base_B.size, n), tool.base_B)
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
        ("HPS step (mul + relin), whole", lambda: step(d1, d2, keys), 1),
        ("BEHZ step (mul + relin), whole", lambda: behz_step(d1, d2, keys), 1),
        ("forward NTT base q, 2 operands", lambda: NTT.ntt_forward(d1, qtab), 2),
        ("HPS lift q -> Bsk, 2 operands", lambda: tool.fast_b_conv_hps(d1), 2),
        ("BEHZ lift q -> Bsk, 2 operands", lambda: tool.fast_b_conv_m_tilde_sm_mrq(d1), 2),
        ("- of which K3 q -> Bsk u {m~}", lambda: BC.base_convert(
            x_scaled, tool.conv_q_to_Bsk_m_tilde.tables), 2),
        ("forward NTT base Bsk, 2 operands", lambda: NTT.ntt_forward(x_b, btab), 2),
        ("tensor product q + Bsk", lambda: (D.dyadic_convolute(a_q, a_q, qtab),
                                            D.dyadic_convolute(a_b, a_b, btab)), 1),
        ("inverse NTT q + Bsk", lambda: (NTT.ntt_inverse(t3_q, qtab),
                                         NTT.ntt_inverse(t3_b, btab)), 1),
        ("fast floor + SK conversion", lambda: tool.fast_floor_scale_fast_b_conv_sk(
            d_q, d_b), 1),
        ("- of which K3 floor q -> Bsk", lambda: BC.base_convert(d_q, tool.ff_tables), 1),
        ("- of which K3 SK B -> q and B -> m_sk", lambda: (
            tool.conv_B_to_q.convert(y_B), tool.conv_B_to_m_sk.convert(y_B)), 1),
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
    whole = {}
    for name, fn, mult in stages:
        fn()
        ms = chip_smoke.cuda_ms(fn, REPS) * max(mult, 1)
        if "whole" in name and "step" in name:
            whole[name.split()[0]] = ms
        base = whole.get(name.split()[0], whole["HPS"])
        tag = "" if mult else " (includes the digit NTT and key dot)"
        say(f"  {name:40s} {ms:9.4f} ms  {100 * ms / base:6.1f}%{tag}")

    def profile(fn, calls):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        return events, [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                        and not e.is_user_annotation]

    def device_ms(kernels, calls, part=""):
        return sum(e.self_device_time_total for e in kernels if part in e.key) / 1e3 / calls

    steps = 5
    for label, fn in (("HPS", lambda: step(d1, d2, keys)),
                      ("BEHZ", lambda: behz_step(d1, d2, keys))):
        events, kernels = profile(fn, steps)
        dev_ms = device_ms(kernels, steps)
        launches = sum(e.count for e in kernels) / steps
        say(f"profiler, {label}, {steps} steps: {launches:.0f} kernel launches and "
            f"{dev_ms:.4f} ms of device kernel time per step ({device_ms(kernels, steps, 'ntt_'):.4f} "
            f"ms in the NTT kernels, {device_ms(kernels, steps, 'bconv'):.4f} ms in K3); "
            f"device busy share of the event-timed step {100 * dev_ms / whole[label]:.1f}%")
        say(events.table(sort_by="self_device_time_total", row_limit=25,
                         max_name_column_width=60))

    # Each kernel alone at its flagship shapes: device time per launch, and
    # the device-memory rate it implies (one int64 load and store per value).
    def alone(name, fn, inputs, output_numel, part):
        _, ks = profile(fn, REPS)
        us = device_ms(ks, REPS, part) * 1e3
        moved = 8 * (sum(x.numel() for x in inputs) + output_numel)
        say(f"profiler, {name}: {us:.3f} us device time per launch, "
            f"{moved / us / 1e6:.4f} TB/s of int64 in and out")

    x_q = d1[:, 0].contiguous()
    alone(f"ntt_forward at {tuple(x_q.shape)}", lambda: NTT.ntt_forward(x_q, qtab),
          [x_q], x_q.numel(), "ntt_")
    alone(f"ntt_inverse at {tuple(x_q.shape)}", lambda: NTT.ntt_inverse(x_q, qtab),
          [x_q], x_q.numel(), "ntt_")
    for label, x, tabs in (("lift q -> Bsk u {m~}", x_scaled, tool.conv_q_to_Bsk_m_tilde.tables),
                           ("floor q -> Bsk", d_q, tool.ff_tables),
                           ("SK B -> q", y_B, tool.conv_B_to_q.tables),
                           ("SK B -> m_sk", y_B, tool.conv_B_to_m_sk.tables)):
        out_numel = x.numel() // tabs.L_in * tabs.L_out
        alone(f"base_convert {label} {tuple(x.shape)} -> {tabs.L_out} limbs",
              lambda: BC.base_convert(x, tabs), [x], out_numel, "bconv")
    for label, t, a in (("base q", qtab, d1), ("base Bsk", btab, x_b)):
        alone(f"fused_negacyclic_multiply {label} {tuple(a.shape)}",
              lambda: FM.fused_negacyclic_multiply(a, a, t), [a, a],
              a.numel() // 2 * 3, "fused_mul")
    return 0


if __name__ == "__main__":
    sys.exit(main())
