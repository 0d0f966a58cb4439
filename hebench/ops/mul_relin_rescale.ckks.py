"""Multiply + relinearize + rescale (CKKS): build_mul_relin_step, then
build_rescale_step.  Each output's phase is the exact integer product of
its two messages divided by the dropped prime."""

from harness.arith import int_negacyclic

ARITY = 2
SPANS = ("multiply", "keyswitch", "ntt")
LEVELS_DROPPED = 1


def switch_keys(keys, traffic):
    return {"relin": keys.relin_key()}


def step(port, traffic, switch):
    rlk = switch["relin"]
    mr, rs = port.batched.build_mul_relin_step(rlk), port.batched.build_rescale_step()
    return lambda d1, d2: rs(mr(d1, d2, rlk))


def expected(cfg, traffic, msgs):
    """(numerator, denominator): an object array (k, n) of integers and the
    integer it is to be divided by."""
    a, b = (m.cpu().numpy().astype(object) for m in msgs)
    num = int_negacyclic([(a, b)], cfg.n, 2 * cfg.message_bits + cfg.n.bit_length() + 1,
                         msgs[0].device)
    return num, cfg.data_primes[-1]


def reference(ev, traffic, inputs, switch):
    return ev.ckks_mul_relin_rescale(*inputs, switch["relin"])
