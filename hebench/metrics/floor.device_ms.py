"""Device ms a batch of the operations launched inside the program's
'troy.floor' span: the BFV multiply's floor(t d / Q) in Bsk
(RNSTool._floor): K3 and its epilogue. None where the program has no such
span."""

from harness.stats import per_batch_ms


def read(rec):
    return per_batch_ms(rec, "troy.floor")
