"""rotate_rows(steps) (BFV): BatchedEvaluator.build_rotate_rows_step, the
Galois gather and one keyswitch round per Galois element the port asks
keys for.  Each output decrypts to m(X^g) mod t, g = 3^steps mod 2n."""

from harness.reference import rotation_element
from harness.scheme import galois_apply

ARITY = 1
SPANS = ("keyswitch", "ntt")
LEVELS_DROPPED = 0


def switch_keys(keys, traffic):
    g = rotation_element(traffic["steps"], keys.cfg.n)
    return {g: keys.galois_key(g)}


def step(port, traffic, switch):
    gstep, elts = port.batched.build_rotate_rows_step(traffic["steps"])
    ks = tuple(switch[g] for g in elts)
    return lambda d: gstep(d, ks)


def expected(cfg, traffic, msgs):
    return galois_apply(msgs[0], rotation_element(traffic["steps"], cfg.n)) % cfg.plain_modulus


def reference(ev, traffic, inputs, switch):
    g = rotation_element(traffic["steps"], ev.cfg.n)
    return ev.rotate(inputs[0], g, switch[g])
