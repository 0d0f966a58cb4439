"""Device ms a batch of the operations launched inside the program's
'troy.bconv' span: a base conversion (ops/bconv.base_convert): K3, with the
copy of an input it cannot address. None where the program has no such span."""

from harness.stats import per_batch_ms


def read(rec):
    return per_batch_ms(rec, "troy.bconv")
