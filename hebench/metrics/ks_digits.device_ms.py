"""Device ms a batch of the operations launched inside the program's
'troy.ks_digits' span: the keyswitch's digits (Evaluator._ks_digits): each
digit as a residue of every output prime. None where the program has no such
span."""

from harness.stats import per_batch_ms


def read(rec):
    return per_batch_ms(rec, "troy.ks_digits")
