"""Device ms a batch of the operations launched inside the program's
'troy.ks_inner' span: the keyswitch's key dot product over the digits
(Evaluator._ks_inner). None where the program has no such span."""

from harness.stats import per_batch_ms


def read(rec):
    return per_batch_ms(rec, "troy.ks_inner")
