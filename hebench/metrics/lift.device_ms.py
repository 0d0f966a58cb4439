"""Device ms a batch of the operations launched inside the program's
'troy.lift' span: the BFV multiply's lift of base q to Bsk
(RNSTool.fast_b_conv_hps, or the BEHZ lift), twice a multiply. None where
the program has no such span."""

from harness.stats import per_batch_ms


def read(rec):
    return per_batch_ms(rec, "troy.lift")
