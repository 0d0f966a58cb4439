"""Device ms a batch of the operations launched inside the program's
'troy.rescale' span: the CKKS rescale step
(BatchedEvaluator.build_rescale_step), its transforms included. None where
the program has no such span."""

from harness.stats import per_batch_ms


def read(rec):
    return per_batch_ms(rec, "troy.rescale")
