"""The plain reference against the port at a small n: its transforms, its
products, and its evaluator's outputs."""

import numpy as np
import pytest
import torch

from harness import arith as A, bench, judge as J, reference as REF
from harness.port import Port

from conftest import SMALL_CONFIG, WORKLOADS

FAST = [1073692673, 1073643521, 1073479681]
WIDE = [1152921504606830593, 1099511480321, 1099510890497]


@pytest.mark.parametrize("primes", [FAST, WIDE], ids=["fast", "wide"])
def test_ntt_is_the_ports(primes):
    from troy_tpu_torch.core.modulus import Modulus
    from troy_tpu_torch.ops import ntt as NTT, ntt64 as N64
    n = 1024
    ring = A.Ring(n, primes, "cpu")
    g = torch.Generator().manual_seed(5)
    x = torch.stack([torch.randint(0, p, (2, n), generator=g) for p in primes], dim=-2)
    if ring.wide:
        port = N64.ntt_forward64(x, N64.NTT64Tables(10, primes, "cpu"))
    else:
        port = NTT.ntt_forward_plain(x, NTT.NTTTables(10, [Modulus(p) for p in primes], "cpu"))
    y = ring.ntt(x)
    assert torch.equal(y, port)
    assert torch.equal(ring.intt(y), x)


@pytest.mark.parametrize("primes", [FAST, WIDE], ids=["fast", "wide"])
def test_products_and_crt(primes):
    ring = A.Ring(64, primes, "cpu")
    g = torch.Generator().manual_seed(6)
    a, b = (torch.stack([torch.randint(0, p, (64,), generator=g) for p in primes])
            for _ in range(2))
    want = torch.tensor([[int(a[i, j]) * int(b[i, j]) % p for j in range(64)]
                         for i, p in enumerate(primes)])
    assert torch.equal(ring.mul(a, b), want)
    assert torch.equal(ring.residues(ring.crt(a)), a)
    control = A.Ring(64, primes, "cpu", exact=False)
    assert not torch.equal(control.mul(a, b), want)


def test_int_negacyclic():
    n = 64
    rng = np.random.default_rng(3)
    a = np.array([int(v) for v in rng.integers(-2 ** 40, 2 ** 40, n)], dtype=object)
    b = np.array([int(v) for v in rng.integers(-2 ** 40, 2 ** 40, n)], dtype=object)
    got = A.int_negacyclic([(a, b)], n, 90, "cpu")
    for k in range(n):
        want = sum(a[i] * b[k - i] for i in range(k + 1)) - \
            sum(a[i] * b[n + k - i] for i in range(k + 1, n))
        assert got[k] == want


@pytest.mark.parametrize("workload", WORKLOADS)
def test_evaluator_agrees_with_the_port(workload):
    spec = bench.Spec(workload, config_overrides=SMALL_CONFIG,
                      traffic_overrides={"batch": 3, "distinct_batches": 1})
    keys, switch, msgs, inputs = bench.prepare(spec, 2 ** 33 + 1, "cpu")
    got = spec.op.step(Port(spec.cfg, "cpu"), spec.traffic, switch)(*inputs[0])
    ref = spec.op.reference(REF.Evaluator(keys), spec.traffic, inputs[0], switch)
    ring = spec.out_ring("cpu")
    expect = spec.op.expected(spec.cfg, spec.traffic, msgs[0])
    for out in (got, ref):
        v = J.judge(spec.scheme, ring, keys, out, expect, spec.limits)
        assert v.correct, v.numbers
    if spec.traffic["op"] == "mul_relin":
        # HPS rounds t d / Q as the program does, the reference exactly: the
        # phases differ by the keyswitch of +-1 differences, far below the error
        ntt = False
        gap = A.centered(J.phase(ring, keys.s, keys.s_ntt, got, ntt)
                         - J.phase(ring, keys.s, keys.s_ntt, ref, ntt), ring.modulus)
        assert A.bits_of(gap) < 20
    else:
        assert torch.equal(got, ref)
