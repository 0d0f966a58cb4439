"""Per-operation device benchmark matrix of the PyTorch port, slope-timed.

The port's twin of scripts/troybench_tpu.py: the reference `troybench` op
list (test/bench/he_operations.cu:15-50: encode / encrypt / negate / add /
multiply + relinearize / multiply_plain / mod_switch_to_next /
rescale_to_next / rotate_rows / rotate_columns / rotate_vector /
complex_conjugate / decrypt / decode) as batched steps on stacked
(B, size, L, n) tensors, built on BatchedEvaluator and BatchedClient.  Each
step is chained (its output is the next call's input) at two repetition
counts, each run timed by CUDA events (the host's clock on the CPU), and
the slope (t_hi - t_lo) / (reps_hi - reps_lo) cancels the constant start and
end of a run.  A step that shrinks its ciphertext is re-expanded through an
exact modular identity: the dropped third polynomial is left out of the
chain (multiply), the dropped last limb is appended back as
((fixed + probe) mod q - probe) mod q of a fixed limb and a probe of the
output (mod switch, rescale), and the decrypt row returns its input with
limb 0 sent through the same round trip by 20 bits of the decrypted output.

Inputs are made in this process by the port's own keygen and encryption
from a context with seed 7; the client's host ops (encode, decode,
encryption, decryption of one ciphertext) are timed eagerly through the
object API and labelled "(B=1)".

Usage:
  python scripts/torch_troybench_perop.py --scheme bfv [--q-bits 60,40,40,60]
      [--batch 16] [-n 8192] [--reps 100] [--device cpu]
Markdown rows print to stdout, in the format scripts/compare_bench.py's
_MD reads.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SEED = 7
# rows whose steps are short: chained 8 times as often, as troybench_tpu.py does
CHEAP = {"negate", "add", "multiply_plain", "mod_switch_to_next", "rescale_to_next",
         "encode_simd (device)", "decode_simd (device)", "decrypt (device)"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheme", default="bfv", choices=["bfv", "bgv", "ckks"])
    ap.add_argument("-n", "--poly-degree", type=int, default=8192)
    ap.add_argument("--q-bits", default=None,
                    help="comma-separated prime bit sizes; default 7 x 30 (bench.py's)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    args.qbits = ([int(b) for b in args.q_bits.split(",")] if args.q_bits else [30] * 7)
    return args


def setup(args, dev) -> SimpleNamespace:
    """Context (seed 7), keys, two public-key encryptions of one message and
    the encoders, all through the port's object API on dev."""
    import torch

    from troy_tpu_torch import (EncryptionParameters, SchemeType, HeContext, CoeffModulus,
                                PlainModulus, SecurityLevel, KeyGenerator, Encryptor,
                                Decryptor, Evaluator, BatchEncoder, CKKSEncoder)
    from troy_tpu_torch.ops.galois import GaloisTool

    scheme = SchemeType[args.scheme.upper()]
    n = args.poly_degree
    parms = EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, list(args.qbits)))
    if scheme != SchemeType.CKKS:
        parms.set_plain_modulus(PlainModulus.batching(n, 20))
    ctx = HeContext.create(parms, True, SecurityLevel.Nil, SEED, device=dev)
    kg = KeyGenerator(ctx)
    pk = kg.create_public_key()
    s = SimpleNamespace(args=args, dev=torch.device(dev), scheme=scheme, n=n, ctx=ctx, kg=kg,
                        pk=pk, ckks=scheme == SchemeType.CKKS,
                        encryptor=Encryptor(ctx, sk=kg.secret_key, pk=pk),
                        decryptor=Decryptor(ctx, kg.secret_key), ev=Evaluator(ctx),
                        cd=ctx.first_context_data())
    rng = np.random.default_rng(5)
    if s.ckks:
        s.encoder, s.scale = CKKSEncoder(ctx), 2.0 ** 25
        s.v = rng.uniform(-1, 1, s.encoder.slot_count)
        s.encode = lambda: s.encoder.encode(s.v, scale=s.scale)
    else:
        s.encoder, s.t = BatchEncoder(ctx), parms.plain_modulus.value
        s.v = rng.integers(0, s.t, s.encoder.slot_count, dtype=np.uint64)
        s.encode = lambda: s.encoder.encode(s.v)
    s.pt = s.encode()
    s.ct1 = s.encryptor.encrypt_asymmetric(s.pt)
    s.ct2 = s.encryptor.encrypt_asymmetric(s.pt)
    s.rlk = kg.create_relin_keys()
    s.elt_rot = GaloisTool.get_element_from_step(1, n)
    s.elt_conj = GaloisTool.conjugate_element(n)
    s.glk = kg.create_galois_keys_from_elements([s.elt_rot, s.elt_conj])
    return s


def host_times(s, reps: int = 8) -> dict:
    """The client's host ops on one ciphertext through the object API: the
    median seconds of reps calls after one warm call, each synced on its
    output's device."""
    from troy_tpu_torch.utils.timer import _sync

    calls = {"encode_simd (host)": s.encode,
             "decode_simd (host)": lambda: s.encoder.decode(s.pt),
             "encrypt_asymmetric (host)": lambda: s.encryptor.encrypt_asymmetric(s.pt),
             "encrypt_symmetric (host)": lambda: s.encryptor.encrypt_symmetric(s.pt),
             "decrypt (host)": lambda: s.decryptor.decrypt(s.ct1)}
    out = {}
    for name, fn in calls.items():
        _sync(getattr(fn(), "data", None))
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            _sync(getattr(fn(), "data", None))
            ts.append(time.perf_counter() - t0)
        out[name] = sorted(ts)[len(ts) // 2]
    return out


def _round_trip(first, p, q: int):
    """((first + p) mod q - p) mod q: first again, through p (below q)."""
    return ((first + p) % q - p) % q


def build_steps(s) -> dict:
    """name -> row: step (cur, aux) -> next cur, its first cur and aux, and
    ref() -> (ciphertext or None, tensor): the object API's result on the
    step's first input, which row 0 of the step's output must equal (the
    ciphertext carries its level and metadata for a decrypt)."""
    import torch

    from troy_tpu_torch.core.plaintext import Plaintext
    from troy_tpu_torch.parallel.batched import BatchedEvaluator, BatchedClient
    from troy_tpu_torch.ops import rp as R
    from troy_tpu_torch.utils import numth
    from troy_tpu_torch.utils.random import RandomGenerator

    B, cd, ev = s.args.batch, s.cd, s.ev
    qtab = cd.qtab()
    be = BatchedEvaluator(ev, cd)

    def bcast(x):
        return x.expand((B,) + tuple(x.shape)).contiguous()

    d1, d2 = bcast(s.ct1.data), bcast(s.ct2.data)
    steps = {}

    def row(name, step, cur, aux, ref):
        steps[name] = SimpleNamespace(name=name, step=step, cur=cur, aux=aux, ref=ref)

    row("negate", lambda cur, aux: R.negate(cur, qtab), d1, d2,
        lambda: ev.negate(s.ct1))
    row("add", lambda cur, aux: R.add(cur, aux, qtab), d1, d2,
        lambda: ev.add(s.ct1, s.ct2))
    row("multiply", lambda cur, aux: be.multiply(cur, aux)[..., :2, :, :], d1, d2,
        lambda: _cut(ev.multiply(s.ct1, s.ct2)))
    mr = be.build_mul_relin_step(s.rlk.key(2))
    row("multiply_relinearize", lambda cur, k: mr(cur, d2, k), d1, s.rlk.key(2),
        lambda: ev.relinearize(ev.multiply(s.ct1, s.ct2), s.rlk))
    ntt_form = be.ntt_form
    row("multiply_plain", lambda cur, pt: ev._plain_product(
        cur, ev._plain_to_level(pt, cd, ntt=True)[None], qtab, ntt_form), d1, s.pt,
        lambda: ev.multiply_plain(s.ct1, s.pt))

    if not cd.is_last():
        q_last = cd.parms.coeff_modulus[-1].value
        fixed = d2[..., -1:, :].contiguous()

        def reexpand(out, fixed):
            probe = out[..., :1, :]
            return torch.cat([out, _round_trip(fixed, probe, q_last)], dim=-2)

        ms = be.build_mod_switch_step()
        row("mod_switch_to_next", lambda cur, aux: reexpand(ms(cur), aux), d1, fixed,
            lambda: _grow(ev.mod_switch_to_next(s.ct1), s.ct2.data[..., -1:, :]))
        if s.ckks:
            rs = be.build_rescale_step()
            row("rescale_to_next", lambda cur, aux: reexpand(rs(cur), aux), d1, fixed,
                lambda: _grow(ev.rescale_to_next(s.ct1), s.ct2.data[..., -1:, :]))

    rot_step = be.build_galois_step([s.elt_rot])
    conj_step = be.build_galois_step([s.elt_conj])
    if s.ckks:
        row("rotate_vector(1)", lambda cur, k: rot_step(cur, (k,)), d1,
            s.glk.key(s.elt_rot), lambda: ev.rotate_vector(s.ct1, 1, s.glk))
        row("complex_conjugate", lambda cur, k: conj_step(cur, (k,)), d1,
            s.glk.key(s.elt_conj), lambda: ev.complex_conjugate(s.ct1, s.glk))
    else:
        row("rotate_rows(1)", lambda cur, k: rot_step(cur, (k,)), d1,
            s.glk.key(s.elt_rot), lambda: ev.rotate_rows(s.ct1, 1, s.glk))
        row("rotate_columns", lambda cur, k: conj_step(cur, (k,)), d1,
            s.glk.key(s.elt_conj), lambda: ev.rotate_columns(s.ct1, s.glk))

    # the client's rows on BatchedClient
    bc = BatchedClient(s.ctx, cd)
    base = RandomGenerator(997).base_keys
    plain_ntt = s.pt.is_ntt_form
    rns = plain_ntt or s.ckks
    row("encrypt_asymmetric (device)",
        bc.build_encrypt_asymmetric_step(base, s.pt.data, plain_ntt, rns), d1, s.pk.data(),
        None)
    row("encrypt_symmetric (device)",
        bc.build_encrypt_symmetric_step(base, s.pt.data, plain_ntt, rns), d1,
        s.kg.secret_key.data, None)
    inv_cf = 1
    if s.scheme.name == "BGV":
        inv_cf = numth.invert_mod(s.ct1.correction_factor, s.t)
    dstep = bc.build_decrypt_step([s.decryptor._power(1)], size=2, inv_cf=inv_cf)
    q0 = cd.parms.coeff_modulus[0].value

    def decrypt_row(cur, aux):
        p20 = dstep(cur).reshape(-1)[0] & 0xFFFFF
        return torch.cat([_round_trip(cur[..., :1, :], p20, q0), cur[..., 1:, :]], dim=-2)

    row("decrypt (device)", decrypt_row, d1, None, lambda: (None, s.ct1.data))
    steps["decrypt (device)"].phase = dstep

    if not s.ckks:
        g = np.random.default_rng(11)
        slots = torch.from_numpy(g.integers(0, s.t, (B, s.n), dtype=np.int64)).to(s.dev)
        enc_step = bc.build_batch_encode_step(s.encoder)
        dec_step = bc.build_batch_decode_step(s.encoder)
        row("encode_simd (device)", lambda cur, aux: enc_step(cur), slots, None,
            lambda: (None, s.encoder.encode(slots[0].cpu().numpy()).data[0]))
        row("decode_simd (device)", lambda cur, aux: dec_step(cur), slots, None,
            lambda: (None, torch.from_numpy(s.encoder.decode(Plaintext(
                slots[:1], coeff_count=s.n)).astype(np.int64)).to(s.dev)))
    else:
        g = np.random.default_rng(11)
        k = s.encoder.slot_count
        vals = g.uniform(-1, 1, (B, k)) + 1j * g.uniform(-1, 1, (B, k))
        enc = s.encoder
        first = bcast(s.pt.data)
        row("encode_simd (device)",
            lambda cur, aux: enc.encode_device(aux, scale=s.scale).data, first, vals,
            lambda: (None, enc.encode_device(vals[0], scale=s.scale).data))
        # decode_device's envelope is log2(Q / scale) <= 120, and the fresh
        # level's margin at 2^25 is larger: the row decodes the same residues
        # at a nominal 26-bit margin, as troybench_tpu.py does
        dec_scale = math.ldexp(1.0, cd.total_coeff_modulus.bit_length() - 26)

        def ck_decode(cur, aux):
            out = enc.decode_device(Plaintext(cur, cd.parms_id, True, dec_scale))
            p20 = int(abs(out[0, 0].real) * 2.0 ** 20) & 0xFFFFF
            return torch.cat([_round_trip(cur[..., :1, :], p20, q0), cur[..., 1:, :]], dim=-2)

        row("decode_simd (device)", ck_decode, first, None, lambda: (None, s.pt.data))
    return steps


def _cut(ct):
    """The size-2 head of a product, as the multiply row keeps it."""
    return None, ct.data[..., :2, :, :]


def _grow(ct, fixed):
    """A mod-switched ciphertext with a fixed last limb appended."""
    import torch

    return ct, torch.cat([ct.data, fixed], dim=-2)


def reference(row):
    """(ciphertext or None, tensor): what row 0 of the row's output equals."""
    r = row.ref()
    return r if isinstance(r, tuple) else (r, r.data)


# CKKS decode tolerance at scale 2^25: with public-key encryptions and one
# 30-bit special prime, a keyswitch's noise reaches 0.07 of a slot at n = 8192
# (0.005 at n = 1024); a wrong slot is off by order 1
CKKS_ATOL = 0.25


def expected_slots(s, name: str):
    """The slots a ciphertext row decrypts to, or None where its output is
    not a whole ciphertext (multiply keeps two of three polynomials) or loses
    its precision (a rescale of a fresh ciphertext at scale 2^25)."""
    v = s.v.astype(np.complex128) if s.ckks else s.v.astype(object)
    if s.ckks:
        table = {"negate": -v, "add": 2 * v, "multiply_relinearize": v * v,
                 "multiply_plain": v * v, "mod_switch_to_next": v,
                 "rotate_vector(1)": np.roll(v, -1), "complex_conjugate": np.conj(v)}
    else:
        t, rows = s.t, v.reshape(2, -1)
        table = {"negate": (-v) % t, "add": (2 * v) % t, "multiply_relinearize": v * v % t,
                 "multiply_plain": v * v % t, "mod_switch_to_next": v,
                 "rotate_rows(1)": np.roll(rows, -1, axis=1).reshape(-1),
                 "rotate_columns": rows[::-1].reshape(-1)}
    table["encrypt_asymmetric (device)"] = table["encrypt_symmetric (device)"] = v
    return table.get(name)


def decrypts_to(s, ct, data, want) -> bool:
    """ct's level and metadata with data decrypt to the slots want."""
    c = ct.clone()
    c.data = data
    got = s.encoder.decode(s.decryptor.decrypt(c))
    if s.ckks:
        return float(np.max(np.abs(got - want))) < CKKS_ATOL
    return bool(np.array_equal(got.astype(object), want % s.t))


def check_row(s, row, out, decrypt: bool = True) -> str:
    """Row 0 of a step's output against the object API's result on the same
    ciphertexts, bit for bit; with decrypt, a ciphertext row also decrypts
    to its slots (row 0, or every row of a batch of fresh encryptions).
    Raises AssertionError; returns what was checked."""
    import torch

    what = []
    if row.ref is not None:
        ct, want = reference(row)
        if not torch.equal(out[0], want):
            raise AssertionError(f"[perop] {row.name}: row 0 != the object API's result")
        what.append("row 0 equals the object API's result")
    slots = expected_slots(s, row.name) if decrypt else None
    if slots is not None:
        if row.ref is None:  # fresh encryptions: every ciphertext of the batch
            proto, rows = s.ct1, list(out)
        else:
            proto = reference(row)[0]
            rows = [out[0][..., :-1, :] if row.name.endswith("_to_next") else out[0]]
        if not all(decrypts_to(s, proto, r, slots) for r in rows):
            raise AssertionError(f"[perop] {row.name}: decrypts wrong")
        what.append(f"{len(rows)} ciphertext(s) decrypt right")
    if row.name == "decrypt (device)":
        phase = row.phase(row.cur)[0]
        plain = s.decryptor.decrypt(s.ct1).data
        if not torch.equal(phase, plain[0] if plain.shape != phase.shape else plain):
            raise AssertionError("[perop] decrypt (device) != Decryptor.decrypt")
        what.append("its decrypt equals Decryptor.decrypt")
    return "; ".join(what)


def _events(dev):
    import torch

    if dev.type == "cuda":
        return (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    return None


def chained_seconds(row, reps: int, dev) -> float:
    """Seconds to run row's step reps times chained from its first input:
    CUDA events on the card, the host's clock on the CPU."""
    import torch

    ev = _events(dev)
    if ev is not None:
        torch.cuda.synchronize(dev)
        ev[0].record()
    else:
        t0 = time.perf_counter()
    cur = row.cur
    for _ in range(reps):
        cur = row.step(cur, row.aux)
    if ev is not None:
        ev[1].record()
        torch.cuda.synchronize(dev)
        return ev[0].elapsed_time(ev[1]) / 1e3
    return time.perf_counter() - t0


def slope_ms(row, reps_hi: int, reps_lo: int, dev) -> float:
    """ms per step: (t_hi - t_lo) / (reps_hi - reps_lo), each t the lower of
    two runs after a warm run of both counts."""
    for r in (reps_lo, reps_hi):
        chained_seconds(row, r, dev)
    t_lo = min(chained_seconds(row, reps_lo, dev) for _ in range(2))
    t_hi = min(chained_seconds(row, reps_hi, dev) for _ in range(2))
    return (t_hi - t_lo) / (reps_hi - reps_lo) * 1e3


def rep_counts(name: str, reps: int) -> tuple[int, int]:
    """(reps_hi, reps_lo) of a row: troybench_tpu.py's counts, kept apart
    at the smallest reps."""
    hi = max(2, reps * (8 if name in CHEAP else 1))
    return hi, (max(2, hi // 5) if hi > 2 else 1)


def header(s) -> list[str]:
    qb = ",".join(str(b) for b in s.args.qbits)
    return [f"### {s.args.scheme.upper()} n={s.n} q_bits={{{qb}}} batch={s.args.batch}",
            "| op | ms / batched step | us / ciphertext |",
            "|---|---|---|"]


def host_lines(host: dict) -> list[str]:
    return [f"| {name} | {t * 1e3:.3f} (B=1) | {t * 1e6:.1f} |"
            for name, t in sorted(host.items())]


def device_line(name: str, ms: float, batch: int) -> str:
    return f"| {name} | {ms:.3f} | {ms / batch * 1e3:.1f} |"


def table(s, steps: dict, reps: int | None = None, out=print, host_reps: int = 8) -> dict:
    """The benchmark's table: the header, the host rows, then each device
    row's slope time as it is measured; returns {row: ms per batched step}
    (host rows in ms a call)."""
    reps = reps or s.args.reps
    for line in header(s):
        out(line)
    host = host_times(s, host_reps)
    for line in host_lines(host):
        out(line)
    times = {k: v * 1e3 for k, v in host.items()}
    for name, row in steps.items():
        times[name] = slope_ms(row, *rep_counts(name, reps), s.dev)
        out(device_line(name, times[name], s.args.batch))
    return times


def main(argv=None):
    import torch

    args = parse_args(argv)
    dev = torch.device(args.device)
    s = setup(args, dev)
    table(s, build_steps(s), out=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
