"""Per-operation benchmark of the PyTorch port through its object API.

The port's twin of scripts/troybench.py (ref: the reference `troybench`
binary, test/bench/he_operations.cu:15-50): encode / decode / encrypt /
decrypt / negate / add / sub / the plaintext ops / multiply / relinearize /
multiply_plain / mod_switch_to_next / rescale_to_next / rotate / rotate
columns or complex conjugate, each called eagerly REPS times after a warmup,
every call timed by the port's Timer with a sync on its output's device, and
printed as the Timer's lines, which scripts/compare_bench.py parses.  The
result of multiply + relinearize is checked unless --no-test-correct.

Usage:
  python scripts/torch_troybench.py --scheme bfv -n 8192 --reps 50 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

OPS = ["encode_simd", "decode_simd", "encrypt_asymmetric", "encrypt_symmetric", "decrypt",
       "negate", "add", "sub", "add_plain", "sub_plain", "multiply", "relinearize",
       "multiply_plain", "mod_switch_to_next", "rescale_to_next", "rotate(1)",
       "rotate_columns", "complex_conjugate"]


def op_names(scheme: str) -> list[str]:
    """The ops this script times for a scheme, in its order."""
    ckks = scheme == "ckks"
    drop = {"rotate_columns"} if ckks else {"rescale_to_next", "complex_conjugate"}
    return [op for op in OPS if op not in drop]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheme", default="bfv", choices=["bfv", "bgv", "ckks"])
    ap.add_argument("-n", "--poly-degree", type=int, default=8192)
    ap.add_argument("--limbs", type=int, default=7)
    ap.add_argument("--q-bits", default=None,
                    help="comma-separated prime bit sizes (e.g. 60,40,40,60 "
                         "for the wide path); overrides --limbs x30")
    ap.add_argument("--log-t", type=int, default=20)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--no-test-correct", action="store_true")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Times every op of op_names(args.scheme) on args.device and prints the
    Timer's lines; returns {"timer": Timer, "correct": bool or None}."""
    import torch

    from troy_tpu_torch import (EncryptionParameters, SchemeType, HeContext, CoeffModulus,
                                PlainModulus, SecurityLevel, KeyGenerator, Encryptor,
                                Decryptor, Evaluator, BatchEncoder, CKKSEncoder)
    from troy_tpu_torch.ops.galois import GaloisTool
    from troy_tpu_torch.utils.timer import Timer

    scheme = SchemeType[args.scheme.upper()]
    n = args.poly_degree
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"troybench (port): scheme={args.scheme} n={n} limbs={args.limbs} "
          f"reps={args.reps} device={dev} ({name})")

    parms = EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(n)
    q_bits = ([int(b) for b in args.q_bits.split(",")]
              if args.q_bits else [30] * args.limbs)
    parms.set_coeff_modulus(CoeffModulus.create(n, q_bits))
    if scheme != SchemeType.CKKS:
        parms.set_plain_modulus(PlainModulus.batching(n, args.log_t))
    context = HeContext.create(parms, True, SecurityLevel.Nil, 1, device=dev)
    keygen = KeyGenerator(context)
    encryptor = Encryptor(context, sk=keygen.secret_key, pk=keygen.create_public_key())
    decryptor = Decryptor(context, keygen.secret_key)
    evaluator = Evaluator(context)
    rlk = keygen.create_relin_keys()
    glk = keygen.create_galois_keys_from_steps([1])
    cglk = keygen.create_galois_keys_from_elements([GaloisTool.conjugate_element(n)])
    rng = np.random.default_rng(0)
    if scheme == SchemeType.CKKS:
        encoder = CKKSEncoder(context)
        scale = 2.0 ** 25
        v = rng.uniform(-1, 1, encoder.slot_count)
        encode = lambda: encoder.encode(v, scale=scale)
    else:
        encoder = BatchEncoder(context)
        t = parms.plain_modulus.value
        v = rng.integers(0, t, encoder.slot_count, dtype=np.uint64)
        encode = lambda: encoder.encode(v)
    pt = encode()
    ct1 = encryptor.encrypt_asymmetric(pt)
    ct2 = encryptor.encrypt_asymmetric(pt)
    prod = evaluator.multiply(ct1, ct2)
    calls = {
        "encode_simd": encode,
        "decode_simd": lambda: encoder.decode(pt),
        "encrypt_asymmetric": lambda: encryptor.encrypt_asymmetric(pt),
        "encrypt_symmetric": lambda: encryptor.encrypt_symmetric(pt),
        "decrypt": lambda: decryptor.decrypt(ct1),
        "negate": lambda: evaluator.negate(ct1),
        "add": lambda: evaluator.add(ct1, ct2),
        "sub": lambda: evaluator.sub(ct1, ct2),
        "add_plain": lambda: evaluator.add_plain(ct1, pt),
        "sub_plain": lambda: evaluator.sub_plain(ct1, pt),
        "multiply": lambda: evaluator.multiply(ct1, ct2),
        "relinearize": lambda: evaluator.relinearize(prod, rlk),
        "multiply_plain": lambda: evaluator.multiply_plain(ct1, pt),
        "mod_switch_to_next": lambda: evaluator.mod_switch_to_next(ct1),
        "rescale_to_next": lambda: evaluator.rescale_to_next(prod),
        "rotate(1)": lambda: evaluator._rotate_internal(ct1, 1, glk),
        "rotate_columns": lambda: evaluator.rotate_columns(ct1, cglk),
        "complex_conjugate": lambda: evaluator.complex_conjugate(ct1, cglk),
    }
    timer = Timer()
    for op in op_names(args.scheme):
        fn = calls[op]
        for _ in range(3):       # warmup: tables, caches, the allocator
            out = fn()
        for _ in range(args.reps):
            timer.tick(op)
            out = fn()
            timer.tock(op, getattr(out, "data", out))
    timer.print()

    correct = None
    if not args.no_test_correct and scheme != SchemeType.CKKS:
        rel = evaluator.relinearize(prod, rlk)
        out = encoder.decode(decryptor.decrypt(rel))
        correct = bool((out == v * v % t).all())
        assert correct, "correctness check failed"
        print("correctness: OK")
    return {"timer": timer, "correct": correct}


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
