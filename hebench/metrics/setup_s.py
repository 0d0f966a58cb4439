"""Process start to the first timed batch: keys and inputs, tables,
kernel build or load, warm-up."""


def read(rec):
    return rec.setup_s
