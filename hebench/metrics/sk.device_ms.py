"""Device ms a batch of the operations launched inside the program's 'troy.sk'
span: the BFV multiply's Shenoy-Kumaresan step back to base q
(RNSTool._b_conv_sk): K3 and its epilogue. None where the program has no
such span."""

from harness.stats import per_batch_ms


def read(rec):
    return per_batch_ms(rec, "troy.sk")
