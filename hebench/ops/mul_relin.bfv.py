"""Multiply + relinearize (BFV): BatchedEvaluator.build_mul_relin_step, the
HPS lift, tensor product and floor with K1 and K3, then the relinearizing
keyswitch.  Each output decrypts to the negacyclic product of its two
messages mod t."""

from harness.arith import Ring

ARITY = 2
SPANS = ("multiply", "keyswitch", "ntt")
LEVELS_DROPPED = 0


def switch_keys(keys, traffic):
    return {"relin": keys.relin_key()}


def step(port, traffic, switch):
    rlk = switch["relin"]
    mr = port.batched.build_mul_relin_step(rlk)
    return lambda d1, d2: mr(d1, d2, rlk)


def expected(cfg, traffic, msgs):
    tr = Ring(cfg.n, [cfg.plain_modulus], msgs[0].device)
    return tr.negacyclic(tr.small(msgs[0]), tr.small(msgs[1]))[..., 0, :]


def reference(ev, traffic, inputs, switch):
    return ev.bfv_mul_relin(*inputs, switch["relin"])
