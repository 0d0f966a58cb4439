"""Faults planted under the timed step, which the correctness check must
catch.  Each takes the step and returns a broken one; bench.run(fault=)
plants it, for control.py --fault on the card and tests/ on the CPU."""


def unchanged(step):
    """A step that returns its state unchanged: the first operand, at the
    output's level."""
    def run(*args):
        out = step(*args)
        return args[0][..., :out.shape[-2], :]
    return run


def half(step):
    """Half of the batch left out: never computed, left at zero."""
    def run(*args):
        out = step(*args).clone()
        out[out.shape[0] // 2:] = 0
        return out
    return run


def altered(step):
    """An answer altered where it is produced: one residue of each output."""
    def run(*args):
        out = step(*args).clone()
        out[:, 0, 0, 0] += 12345
        return out
    return run


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}
